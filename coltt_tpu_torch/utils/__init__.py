"""Configuration and structured logging."""

"""Checkpoint object store (local filesystem)."""

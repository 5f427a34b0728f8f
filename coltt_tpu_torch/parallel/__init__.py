"""The immutable flat index (single device) of ``coltt_tpu/parallel``."""

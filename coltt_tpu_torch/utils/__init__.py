"""Configuration, structured logging, ids and the host helpers of core mode."""

from coltt_tpu_torch.utils.snowflake import SnowflakeNode
from coltt_tpu_torch.utils.logging import get_logger
from coltt_tpu_torch.utils.config import Config, load_config

__all__ = ["SnowflakeNode", "get_logger", "Config", "load_config"]

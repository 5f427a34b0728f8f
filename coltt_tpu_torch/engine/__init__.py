"""The three engines (edge, core, experimental), collection state, errors
and cross-request scan batching."""

from coltt_tpu_torch.engine.errors import EngineError, ErrorCode
from coltt_tpu_torch.engine.state import CollectionStateManager
from coltt_tpu_torch.engine.edge import EdgeEngine
from coltt_tpu_torch.engine.core import CoreEngine
from coltt_tpu_torch.engine.experimental import ExperimentalEngine

__all__ = [
    "EngineError",
    "ErrorCode",
    "CollectionStateManager",
    "EdgeEngine",
    "CoreEngine",
    "ExperimentalEngine",
]

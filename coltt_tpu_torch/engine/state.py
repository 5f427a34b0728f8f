"""Collection state manager.

Reference parity: ``core/core_state_manager.go:22-60`` and
``edge/edge_state_manager.go:22-62`` — two RWMutex-guarded maps tracking
"collection exists" and "collection loaded in memory", consulted by every
RPC before touching an engine (collectionStatusHelper,
core/core_helper.go:227).
"""

from __future__ import annotations

import threading
from typing import Set

from coltt_tpu_torch.engine.errors import EngineError, ErrorCode


class CollectionStateManager:
    def __init__(self):
        self._mu = threading.RLock()
        self._exists: Set[str] = set()
        self._loaded: Set[str] = set()

    # -- mutation ----------------------------------------------------------
    def add(self, name: str) -> None:
        with self._mu:
            self._exists.add(name)

    def remove(self, name: str) -> None:
        with self._mu:
            self._exists.discard(name)
            self._loaded.discard(name)

    def mark_loaded(self, name: str) -> None:
        with self._mu:
            self._loaded.add(name)

    def mark_released(self, name: str) -> None:
        with self._mu:
            self._loaded.discard(name)

    # -- queries -----------------------------------------------------------
    def exists(self, name: str) -> bool:
        with self._mu:
            return name in self._exists

    def loaded(self, name: str) -> bool:
        with self._mu:
            return name in self._loaded

    def loaded_collections(self) -> Set[str]:
        with self._mu:
            return set(self._loaded)

    def all_collections(self) -> Set[str]:
        with self._mu:
            return set(self._exists)

    # -- guards (collectionStatusHelper parity) -----------------------------
    def require_exists(self, name: str) -> None:
        if not self.exists(name):
            raise EngineError(
                f"collection {name!r} does not exist", ErrorCode.INTERNAL_FUNC_ERROR
            )

    def require_loaded(self, name: str) -> None:
        self.require_exists(name)
        if not self.loaded(name):
            raise EngineError(
                f"collection {name!r} is not loaded; call LoadCollection first",
                ErrorCode.INTERNAL_FUNC_ERROR,
            )

    def require_not_exists(self, name: str) -> None:
        if self.exists(name):
            raise EngineError(
                f"collection {name!r} already exists", ErrorCode.INTERNAL_FUNC_ERROR
            )

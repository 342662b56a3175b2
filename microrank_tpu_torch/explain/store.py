"""Bounded in-process store of recent explain bundles (counterpart of
``microrank_tpu/explain/store.py``).

The obs server's ``GET /explainz?window=...`` serves from here: the
stream engine publishes every bundle it writes, keyed by window start,
and the ring keeps the most recent ``ExplainConfig.store_windows``. The
engine thread publishes and HTTP handler threads read, under one lock.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional


class ExplainStore:
    def __init__(self, capacity: int = 32):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._bundles: "OrderedDict[str, dict]" = OrderedDict()

    def publish(self, window_id: str, bundle_data: dict) -> None:
        key = str(window_id)
        with self._lock:
            self._bundles.pop(key, None)
            self._bundles[key] = bundle_data
            while len(self._bundles) > self.capacity:
                self._bundles.popitem(last=False)

    def get(self, window_id: str) -> Optional[dict]:
        with self._lock:
            return self._bundles.get(str(window_id))

    def latest(self) -> Optional[dict]:
        with self._lock:
            if not self._bundles:
                return None
            return next(reversed(self._bundles.values()))

    def windows(self) -> List[str]:
        with self._lock:
            return list(self._bundles)

    def configure(self, capacity: int) -> None:
        with self._lock:
            self.capacity = max(1, int(capacity))
            while len(self._bundles) > self.capacity:
                self._bundles.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._bundles)


_store_lock = threading.Lock()
_store: Optional[ExplainStore] = None


def get_explain_store() -> ExplainStore:
    """The process-wide bundle store (created on first use)."""
    global _store
    with _store_lock:
        if _store is None:
            _store = ExplainStore()
        return _store

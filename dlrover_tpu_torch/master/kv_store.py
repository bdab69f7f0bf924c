"""Master kv-store: the rendezvous/barrier backing store for all hosts
(port of ``dlrover_tpu/master/kv_store.py``).

Capability ref: ``dlrover/python/master/servicer.py:278,567`` kv-store RPCs +
``elastic_agent/torch/master_kv_store.py`` (the torch Store built on it).
Used by agents for barriers, hang-vote, and checkpoint commit coordination.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class KVStore:
    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._cv = threading.Condition()

    def put(self, key: str, value: bytes):
        with self._cv:
            self._store[key] = value
            self._cv.notify_all()

    def get(self, key: str) -> Optional[bytes]:
        with self._cv:
            return self._store.get(key)

    def snapshot(self) -> Dict[str, bytes]:
        """Consistent copy for persistence (RPC threads mutate the store)."""
        with self._cv:
            return dict(self._store)

    def wait(self, key: str, timeout: float = 60.0) -> Optional[bytes]:
        deadline = time.monotonic() + timeout
        with self._cv:
            while key not in self._store:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    return None
            return self._store[key]

    def add(self, key: str, amount: int = 1) -> int:
        """Atomic counter (torch Store ``add`` semantics)."""
        with self._cv:
            current = int(self._store.get(key, b"0"))
            current += amount
            self._store[key] = str(current).encode()
            self._cv.notify_all()
            return current

    def delete(self, key: str) -> bool:
        with self._cv:
            return self._store.pop(key, None) is not None

    def clear_prefix(self, prefix: str):
        with self._cv:
            for key in [k for k in self._store if k.startswith(prefix)]:
                del self._store[key]

"""Sync service: named worker barriers + PS cluster-version protocol
(port of ``dlrover_tpu/master/sync_service.py``).

Capability ref: ``dlrover/python/master/elastic_training/sync_service.py``
and ``elastic_ps.py`` (``ElasticPsService``): workers rendezvous on named
barriers, and a "cluster version" lets parameter-server-style jobs agree on
when a resized serving set is consistent (workers report their local
version; the global version advances once every live worker caught up).

Use: the embedding engine's hosts play the PS role — after an elastic
resize each host reloads/reshards its tables, reports its local version,
and resumes lookups only once the global version advances.
"""

from __future__ import annotations

import threading
from typing import Dict, Set

from dlrover_tpu_torch.common.log import default_logger as logger


class SyncService:
    def __init__(self):
        self._lock = threading.Lock()
        # barrier name -> set of joined node ids; "finished" once the
        # expected count is reached (a later join of a finished barrier is
        # an immediate pass — re-joining workers must not deadlock).
        self._barriers: Dict[str, Set[int]] = {}
        self._barrier_need: Dict[str, int] = {}
        self._finished: Set[str] = set()
        # PS cluster-version protocol.
        self._global_version = 0
        self._local_versions: Dict[int, int] = {}

    # -- barriers -------------------------------------------------------------

    def join_sync(self, name: str, node_id: int, need: int) -> bool:
        """Join barrier ``name`` expecting ``need`` members; True when the
        barrier is complete (now or previously)."""
        with self._lock:
            if name in self._finished:
                return True
            members = self._barriers.setdefault(name, set())
            members.add(node_id)
            self._barrier_need[name] = need
            if len(members) >= need:
                self._finished.add(name)
                logger.info("sync barrier %s complete (%d)", name, need)
                return True
            return False

    def sync_finished(self, name: str) -> bool:
        with self._lock:
            return name in self._finished

    def remove_node(self, node_id: int):
        """A dead node must not wedge open barriers: drop its membership
        and shrink the expectation for barriers it never reached."""
        with self._lock:
            for name, members in self._barriers.items():
                if name in self._finished:
                    continue
                members.discard(node_id)
                need = max(1, self._barrier_need.get(name, 1) - 1)
                self._barrier_need[name] = need
                if len(members) >= need:
                    self._finished.add(name)
            self._local_versions.pop(node_id, None)

    # -- cluster version ------------------------------------------------------

    def get_global_version(self) -> int:
        with self._lock:
            return self._global_version

    def update_local_version(
        self, node_id: int, version: int, expected: int = 0
    ) -> int:
        """Worker reports the version it has locally applied; the global
        version advances to the minimum across reporters once at least
        ``expected`` workers have reported (0 = whoever has reported).
        Returns the (possibly new) global version."""
        with self._lock:
            self._local_versions[node_id] = version
            enough = len(self._local_versions) >= max(expected, 1)
            if self._local_versions and enough:
                candidate = min(self._local_versions.values())
                if candidate > self._global_version:
                    self._global_version = candidate
                    logger.info(
                        "cluster version -> %d", self._global_version
                    )
            return self._global_version

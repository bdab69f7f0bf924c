"""Per-node device-memory accounting ledger: the master's memory truth
(port of ``dlrover_tpu/master/memory_ledger.py``).

Receives the flat-attr ``memory`` telemetry events that
``utils/memory_profile.emit_memory_event`` ships on the report cadence
and keeps one newest-wins snapshot per node, the same shape the speed
monitor keeps for serve stats.  The master's servicer routes the events
here, its timeline renders it as gauges and its state store persists it;
serving it at ``/memory`` and feeding a diagnosis chain are ROADMAP Queue
1 item 10b's remainder.

``headroom_frac`` uses ``-1`` as the "unknown" sentinel (a node
without a card — the CPU fallback path — cannot price headroom);
aggregates skip unknowns rather than treating them as pressure.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.utils.memory_profile import POOLS

#: Numeric attrs a memory event may carry; everything else is ignored
#: so trainers can grow the event without breaking older masters.
_FIELDS = (
    "bytes_in_use", "peak_bytes", "limit_bytes", "headroom_frac",
    "measured_b", "modeled_b", "step",
    "xla_temp_b", "xla_arg_b", "xla_out_b", "xla_code_b",
) + tuple(f"pool_{pool}_b" for pool in POOLS)


class MemoryLedger:
    """Newest-wins per-node classified device-memory snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[int, Dict[str, float]] = {}
        self._events = 0

    def record(
        self,
        node_id: int = 0,
        *,
        source: str = "",
        cache_key: str = "",
        timestamp: Optional[float] = None,
        **attrs,
    ):
        """Book one node's memory event.  Unknown attrs are ignored."""
        snap: Dict[str, float] = {
            field: float(attrs.get(field, 0.0)) for field in _FIELDS
        }
        snap["headroom_frac"] = float(attrs.get("headroom_frac", -1.0))
        snap["source"] = source
        snap["cache_key"] = cache_key
        snap["timestamp"] = (
            time.time() if timestamp is None else float(timestamp)
        )
        with self._lock:
            self._events += 1
            self._stats[int(node_id)] = snap

    def evict(self, node_id: int):
        """Drop a retired/quarantined node's snapshot so it stops
        weighing on the fleet aggregates and the healthz floor."""
        with self._lock:
            self._stats.pop(int(node_id), None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._stats)

    def per_node(self) -> Dict[int, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def headroom_frac(self) -> float:
        """Fleet headroom = the *tightest* node's headroom (min over
        nodes that can price it); ``-1`` when no node reports a
        limit."""
        with self._lock:
            known = [
                s["headroom_frac"] for s in self._stats.values()
                if s.get("headroom_frac", -1.0) >= 0.0
            ]
        return min(known) if known else -1.0

    def ledger(self) -> Dict[str, float]:
        """Fleet aggregate for gauges: summed bytes, max peak, min
        known headroom, per-pool sums."""
        with self._lock:
            stats = list(self._stats.values())
            events = self._events
        out: Dict[str, float] = {
            "nodes": float(len(stats)),
            "events": float(events),
            "bytes_in_use": sum(s["bytes_in_use"] for s in stats),
            "peak_bytes": max(
                (s["peak_bytes"] for s in stats), default=0.0
            ),
            "limit_bytes": sum(s["limit_bytes"] for s in stats),
        }
        known = [
            s["headroom_frac"] for s in stats
            if s.get("headroom_frac", -1.0) >= 0.0
        ]
        out["headroom_frac"] = min(known) if known else -1.0
        for pool in POOLS:
            field = f"pool_{pool}_b"
            out[field] = sum(s.get(field, 0.0) for s in stats)
        return out

    def state(self) -> Dict[str, object]:
        """Snapshot for the master state store."""
        with self._lock:
            return {
                "stats": {k: dict(v) for k, v in self._stats.items()},
                "events": self._events,
            }

    def restore(self, state: Dict[str, object]):
        with self._lock:
            self._stats = {
                int(k): dict(v)
                for k, v in dict(state.get("stats", {})).items()
            }
            self._events = int(state.get("events", 0))

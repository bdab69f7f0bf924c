"""Host-side step-pipeline accounting (port of ``PipelineEvent``,
``StepPipelineCounters`` and ``pipeline_counters`` of
``dlrover_tpu/utils/profiler.py``).

The reference's device-time capture and trace parsing (``jax.profiler``)
wait for the measurement planes (ROADMAP Queue 1 item 10).  On the card a
"place" is a batch's copy from pinned host memory issued on the
prefetcher's CUDA stream, and a "block" is a device-to-host read that
waits for the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.common import telemetry as _telemetry

# These counters record the three host-side event kinds the async step
# pipeline cares about:
#
#   "place"    — a batch's H2D copy was issued (train_lib.shard_batch)
#   "dispatch" — host time spent enqueueing one train step
#   "block"    — a blocking device->host sync (metrics fetch, eval fetch)
#
# The pipelined trainer's contract — at most one blocking sync per
# ``metrics_lag`` steps, and batch N+1 placed before step N's metrics are
# fetched — is asserted straight off the ordered event list.


@dataclasses.dataclass
class PipelineEvent:
    kind: str                 # "place" | "dispatch" | "block"
    label: str                # e.g. "h2d", "step", "metrics", "metrics-flush"
    t: float                  # perf_counter at event start
    duration_s: float = 0.0
    steps: Tuple[int, ...] = ()   # step(s) the event is attributed to


class StepPipelineCounters:
    """Ordered host-event log + aggregate counters for the step pipeline.

    A "block" with label ``"metrics"`` is a per-step synchronous fetch (the
    pre-pipeline behavior); label ``"metrics-flush"`` is the ring's batched
    fetch covering ``steps``.  ``sync_block_count`` therefore must read 0 in
    pipelined mode — the tier-1 assertion ``tools/trace_steps.py`` wraps.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with getattr(self, "_lock", threading.Lock()):
            self.events: List[PipelineEvent] = []
            self.host_block_count = 0
            self.host_blocked_s = 0.0
            self.place_count = 0
            self.dispatch_count = 0
            self.dispatch_s = 0.0
            # Telemetry-ring overflow: events the bounded ring discarded
            # before a ship drained it (lifetime tally; the per-window
            # count also rides the wire to the master's
            # dlrover_telemetry_dropped_total gauge).
            self.dropped_events = 0

    @contextlib.contextmanager
    def host_block(self, label: str, steps: Sequence[int] = ()):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.host_block_count += 1
                self.host_blocked_s += dt
                self.events.append(
                    PipelineEvent("block", label, t0, dt, tuple(steps))
                )
            # Host blocks are the pipeline's stalls — fold them into the
            # job timeline so metrics-flush/eval-fetch slices sit next to
            # the trainer's step spans in the merged Perfetto trace.
            _telemetry.event(
                label, duration_s=dt, kind="block", steps=tuple(steps)
            )

    def record_place(self, duration_s: float = 0.0, label: str = "h2d"):
        with self._lock:
            index = self.place_count
            self.place_count += 1
            self.events.append(
                PipelineEvent("place", label, time.perf_counter(),
                              duration_s, (index,))
            )
        if duration_s > 0.0:
            _telemetry.event(label, duration_s=duration_s, kind="place",
                             batch=index)

    def record_dropped(self, count: int):
        if count <= 0:
            return
        with self._lock:
            self.dropped_events += count

    def record_dispatch(self, step: int, duration_s: float):
        with self._lock:
            self.dispatch_count += 1
            self.dispatch_s += duration_s
            self.events.append(
                PipelineEvent("dispatch", "step", time.perf_counter(),
                              duration_s, (step,))
            )

    # -- queries ------------------------------------------------------------

    def blocks(self, label: Optional[str] = None) -> List[PipelineEvent]:
        with self._lock:
            return [
                e for e in self.events
                if e.kind == "block" and (label is None or e.label == label)
            ]

    def sync_block_count(self) -> int:
        """Per-step synchronous fetches (the blocks pipelining eliminates)."""
        return len(self.blocks("metrics"))

    def sync_blocks_for_step(self, step: int) -> int:
        return sum(1 for e in self.blocks("metrics") if step in e.steps)

    def per_step_table(self) -> List[Dict]:
        """One row per dispatched step: host dispatch time vs attributed
        blocking time — the timeline ``tools/trace_steps.py`` dumps."""
        with self._lock:
            events = list(self.events)
        rows: Dict[int, Dict] = {}
        for e in events:
            if e.kind == "dispatch":
                row = rows.setdefault(e.steps[0], {
                    "step": e.steps[0], "dispatch_s": 0.0,
                    "blocked_s": 0.0, "sync_blocks": 0,
                })
                row["dispatch_s"] += e.duration_s
        for e in events:
            if e.kind != "block" or not e.steps:
                continue
            share = e.duration_s / len(e.steps)
            for step in e.steps:
                if step in rows:
                    rows[step]["blocked_s"] += share
                    if e.label == "metrics":
                        rows[step]["sync_blocks"] += 1
        return [rows[s] for s in sorted(rows)]

    def summary(self) -> Dict:
        with self._lock:
            return {
                "host_block_count": self.host_block_count,
                "host_blocked_s": self.host_blocked_s,
                "sync_block_count": len([
                    e for e in self.events
                    if e.kind == "block" and e.label == "metrics"
                ]),
                "flush_block_count": len([
                    e for e in self.events
                    if e.kind == "block" and e.label == "metrics-flush"
                ]),
                "place_count": self.place_count,
                "dispatch_count": self.dispatch_count,
                "dispatch_s": self.dispatch_s,
                "dropped_events": self.dropped_events,
            }


_PIPELINE_COUNTERS = StepPipelineCounters()


def pipeline_counters() -> StepPipelineCounters:
    """The process-wide step-pipeline counter instance."""
    return _PIPELINE_COUNTERS

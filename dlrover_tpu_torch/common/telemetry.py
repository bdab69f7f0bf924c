"""Process-local structured telemetry: spans, events, and the wire format.

The unified observability plane's first tier.  Every process (trainer,
agent, master-local tools) owns one :class:`TelemetryRecorder` — a bounded,
thread-safe ring of structured events with monotonic timestamps — and
instruments itself through ``span(name, **attrs)`` / ``event(name,
**attrs)``.  Draining the ring yields plain-tuple wire events that ship
master-ward inside a ``TelemetryEvents`` report (pickle-safe under the
control plane's restricted unpickler: tuples/str/float/dict only), where
``master/timeline.py`` merges the per-node streams into the job timeline.

Design constraints:

* **Near-zero cost when disabled** — ``span()`` returns one cached no-op
  context manager and ``event()`` returns before touching the ring, so a
  disabled recorder allocates nothing per call.
* **Bounded under churn** — the ring is a ``deque(maxlen=ring_size)``; a
  chatty process overwrites its own oldest events instead of growing.
* **Clock discipline** — durations come from ``time.monotonic``; each
  event also carries a wall-clock timestamp derived from one (wall, mono)
  anchor taken at construction, so streams from different hosts merge on
  wall time without per-event ``time.time()`` skew.

Knobs (also surfaced in README):

* ``DLROVER_TPU_TELEMETRY`` — ``0``/``false``/``off`` disables recording
  (default: enabled).
* ``DLROVER_TPU_TELEMETRY_RING`` — ring capacity in events (default 4096).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

# One wire event: (name, kind, t_wall, duration_s, attrs).
# kind is "span" (has duration) or "event" (instant).
WireEvent = Tuple[str, str, float, float, Dict[str, Any]]

DEFAULT_RING_SIZE = 4096
ENV_ENABLE = "DLROVER_TPU_TELEMETRY"
ENV_RING = "DLROVER_TPU_TELEMETRY_RING"

_FALSY = ("0", "false", "off", "no")

# Attribute names that collide with the ``span()``/``event()`` parameters
# themselves.  An attrs dict carrying one of these used to either shadow a
# parameter (an opaque ``TypeError: got multiple values for argument``) or
# silently rebind the timing channel — reject loudly at the recording call
# site instead.
RESERVED_ATTRS = frozenset({"name", "duration_s", "t_mono"})


def _check_attrs(attrs: Dict[str, Any]):
    bad = RESERVED_ATTRS.intersection(attrs)
    if bad:
        raise ValueError(
            f"telemetry attrs {sorted(bad)} are reserved parameters "
            "(name/duration_s/t_mono); rename the attribute "
            "(e.g. 'probe_duration_s'), or pass timing through the "
            "duration_s/t_mono parameters"
        )


def _env_enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "1").strip().lower() not in _FALSY


def _env_ring_size() -> int:
    try:
        return max(16, int(os.environ.get(ENV_RING, DEFAULT_RING_SIZE)))
    except ValueError:
        return DEFAULT_RING_SIZE


class _Span:
    """An open span; closes (and records) on context exit.

    Reusing one object per ``span()`` call (not per event kind) keeps the
    hot path to: one allocation, two ``monotonic()`` reads, one deque
    append under the lock.
    """

    __slots__ = ("_recorder", "name", "attrs", "_t0")

    def __init__(self, recorder: "TelemetryRecorder", name: str,
                 attrs: Dict[str, Any]):
        self._recorder = recorder
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        duration = time.monotonic() - self._t0
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._recorder._record("span", self.name, self._t0, duration,
                               self.attrs)
        return False


# The single shared no-op context manager handed out while disabled: a
# disabled ``span()`` call must not allocate per event.
_NULL_SPAN = contextlib.nullcontext()


class TelemetryRecorder:
    """Bounded thread-safe event/span ring for one process."""

    def __init__(
        self,
        enabled: Optional[bool] = None,
        ring_size: Optional[int] = None,
        source: str = "trainer",
    ):
        self._lock = threading.Lock()
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self.source = source
        size = ring_size if ring_size is not None else _env_ring_size()
        self._ring: Deque[WireEvent] = deque(maxlen=size)
        self.dropped = 0  # events overwritten before a drain shipped them
        self._anchor_wall = time.time()
        self._anchor_mono = time.monotonic()

    # -- configuration --------------------------------------------------------

    def configure(
        self,
        enabled: Optional[bool] = None,
        ring_size: Optional[int] = None,
        source: Optional[str] = None,
    ):
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if source is not None:
                self.source = source
            if ring_size is not None and ring_size != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(16, ring_size))

    @property
    def ring_size(self) -> int:
        return self._ring.maxlen or 0

    # -- recording ------------------------------------------------------------

    def _wall(self, mono: float) -> float:
        return self._anchor_wall + (mono - self._anchor_mono)

    def _record(self, kind: str, name: str, t_mono: float,
                duration_s: float, attrs: Dict[str, Any]):
        if not self.enabled:
            return
        attrs.setdefault("src", self.source)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(
                (name, kind, self._wall(t_mono), duration_s, attrs)
            )

    def span(self, name: str, /, **attrs):
        """Context manager timing a code region.  Nesting works naturally
        (each span records independently on exit); mutate ``.attrs`` inside
        the block to attach results discovered mid-span.  Attrs named after
        the reserved parameters (``RESERVED_ATTRS``) are rejected with
        ``ValueError``.
        """
        if attrs:
            _check_attrs(attrs)
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def event(self, name: str, /, duration_s: float = 0.0,
              t_mono: Optional[float] = None, **attrs):
        """Record an instant (or externally-timed) occurrence.

        ``t_mono`` backdates the event to a caller-captured
        ``time.monotonic()`` reading — how modeled sub-phases (e.g. the
        microbatch engine's accumulate/reduce/update breakdown, which the
        host cannot observe inside one XLA program) are placed *inside*
        their enclosing measured span on the Chrome trace.

        ``duration_s`` and ``t_mono`` are the timing channel, never attrs;
        an attrs dict naming them (or ``name`` — see ``RESERVED_ATTRS``)
        is rejected with ``ValueError`` — what used to surface as an opaque
        ``TypeError: got multiple values`` or a silently-rebound duration.
        """
        if attrs:
            _check_attrs(attrs)
        if not isinstance(duration_s, (int, float)) or isinstance(
            duration_s, bool
        ):
            raise TypeError(
                f"event({name!r}): duration_s must be seconds (a number), "
                f"got {type(duration_s).__name__} — it is the reserved "
                "timing parameter, not an attribute"
            )
        if not self.enabled:
            return
        self._record("event" if duration_s == 0.0 else "span",
                     name, time.monotonic() if t_mono is None else t_mono,
                     duration_s, attrs)

    # -- shipping -------------------------------------------------------------

    def drain(self) -> List[WireEvent]:
        """Remove and return everything recorded since the last drain.
        The return value IS the wire format ``TelemetryEvents`` carries."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def ship(self, client) -> int:
        """Drain the ring into ``client.report_telemetry`` (duck-typed:
        ``agent/master_client.py``).  Returns events shipped; a no-op when
        the ring is empty, so callers can invoke it on any cadence."""
        with self._lock:
            events = list(self._ring)
            self._ring.clear()
            dropped, self.dropped = self.dropped, 0
        if not events and not dropped:
            return 0
        client.report_telemetry(events, dropped)
        return len(events)

    def peek(self) -> List[WireEvent]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def events_to_chrome_trace(
    events_by_node: Dict[int, List[WireEvent]],
) -> Dict[str, Any]:
    """Wire events -> Chrome-trace/Perfetto JSON dict, one track per node.

    Each node becomes a trace *process* (pid = node id); within it the
    recording process kind (``src`` attr: trainer/agent/master) becomes a
    thread, so one elastic run reads as: per node, a trainer lane of
    step/compile/checkpoint spans over an agent lane of rendezvous/restart
    events.  Load the output at https://ui.perfetto.dev or
    ``chrome://tracing``.
    """
    trace: List[Dict[str, Any]] = []
    tids: Dict[Tuple[int, str], int] = {}
    for node_id in sorted(events_by_node):
        trace.append({
            "ph": "M", "name": "process_name", "pid": node_id, "tid": 0,
            "args": {"name": f"node {node_id}"},
        })
        for name, kind, t_wall, duration_s, attrs in events_by_node[node_id]:
            src = str(attrs.get("src", "trainer"))
            tid_key = (node_id, src)
            if tid_key not in tids:
                tids[tid_key] = len([k for k in tids if k[0] == node_id])
                trace.append({
                    "ph": "M", "name": "thread_name", "pid": node_id,
                    "tid": tids[tid_key], "args": {"name": src},
                })
            entry = {
                "name": name,
                "pid": node_id,
                "tid": tids[tid_key],
                "ts": t_wall * 1e6,
                "args": {k: v for k, v in attrs.items() if k != "src"},
            }
            if kind == "span":
                entry["ph"] = "X"
                entry["dur"] = duration_s * 1e6
            else:
                entry["ph"] = "i"
                entry["s"] = "t"
            trace.append(entry)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


_RECORDER = TelemetryRecorder()


def recorder() -> TelemetryRecorder:
    """The process-wide recorder instance."""
    return _RECORDER


def span(name: str, /, **attrs):
    return _RECORDER.span(name, **attrs)


def event(name: str, /, duration_s: float = 0.0,
          t_mono: Optional[float] = None, **attrs):
    _RECORDER.event(name, duration_s=duration_s, t_mono=t_mono, **attrs)


def configure(**kwargs):
    _RECORDER.configure(**kwargs)

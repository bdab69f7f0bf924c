"""Measured device-time phase attribution for the step loop (port of
``dlrover_tpu/utils/device_profile.py``).

What the trainer's timeline emits otherwise is **modeled**:
``train_lib.microbatch_phase_plan`` apportions the measured step wall
time by the reference's cost model and stamps every row
``source="modeled"``.  Every ``profile_every`` steps the trainer captures
one ``torch.profiler`` window around a single step; this module parses
the Chrome trace the profiler exports (pure stdlib) into per-phase
**device** durations plus a compute-vs-collective overlap fraction, and
the trainer emits them as ``source="measured"`` rows (``src="device"``)
inside the same step span, with one ``"calibration"`` event per window
for the master's :class:`~dlrover_tpu_torch.master.calibration.
CalibrationLedger`.

The traces.  A kineto trace (what ``torch.profiler`` exports) is read so:

* On a card, the device lanes are its GPU events: ``cat`` of
  ``kernel``, ``gpu_memcpy`` or ``gpu_memset``.  A kernel whose name
  holds ``nccl`` is collective traffic, its leg read from the name.
* The port's collectives between processes on one card are gloo through
  the host (``parallel/wire.Wire``), so no device event is one of them.
  While a window is armed (:func:`armed`) each ``Wire`` call opens a
  host range ``wire:<axis>/<leg>`` from its issue to its completion
  (:func:`leg_range`); the parser books those ranges as the window's
  collective intervals and legs.  Unarmed, a ``Wire`` call pays one
  list read.
* Without a card (a CPU run) the CPU's ops are the "device": each
  ``cpu_op`` counts its self time (its duration less its child ops'), so
  nested rows (``aten::linear`` holding ``aten::addmm``) count once, and
  ops inside a ``wire:`` range on their thread are the collective's own
  host work, not compute.

On a card the window also counts the launches of the port's own kernels
(``PORT_KERNELS``, the ``__global__`` functions of ``ops/csrc``) by
name, and the calibration event carries each count as a flat
``kernel_<name>`` attribute, so the master's timeline shows which
hand-written kernels ran in a profiled step.

A trace in the reference's format (``process_name`` metadata naming a
``TPU``/``GPU``/``/device:`` plane, HLO-shaped op rows) is parsed exactly
as the reference parses it.

Capture discipline: the window costs one host-device sync in the
captured step plus the trace export and parse.  With ``profile_every ==
0`` (the default) nothing here is constructed and the step path pays one
attribute read.  Only one ``torch.profiler`` may run in a process: a
window that cannot start (another profiler is running, or the build has
no profiler) latches the profiler off, as the reference's does.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import glob
import gzip
import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import default_logger as logger

# Modeled phase name (microbatch_phase_plan rows) -> phase kind.  The
# measured side classifies device ops into the same two kinds, so the
# calibration ratio compares like with like.
PHASE_KINDS: Dict[str, str] = {
    "accumulate": "compute",
    "update": "compute",
    "shard_update": "compute",
    "reduce": "collective",
    "reduce_scatter": "collective",
    "allgather": "collective",
}

#: Substrings that mark a device op as collective traffic in a trace of
#: the reference's format (its ``utils/profiler._classify`` table).
_COLLECTIVE_KEYS = (
    "all-reduce", "all-gather", "all-to-all", "reduce-scatter",
    "collective", "psum", "ppermute",
)

#: NCCL kernel name (lower case, no underscores) -> leg.
_NCCL_LEGS = (
    ("allreduce", "all_reduce"), ("allgather", "all_gather"),
    ("reducescatter", "reduce_scatter"), ("alltoall", "all_to_all"),
    ("sendrecv", "send"), ("send", "send"), ("recv", "send"),
    ("broadcast", "broadcast"), ("reduce", "reduce"),
)

#: HLO-ish op row: lowercase, digits, ``._-`` — matches ``dot.4``,
#: ``broadcast_add_fusion``, ``reduce-window``, ``all-reduce.3``; rejects
#: host scaffolding (``PjitFunction(f)``, ``$profiler.py:91 start_trace``).
_HLO_NAME = re.compile(r"^[a-z][a-z0-9._-]*$")

#: Our own annotation namespace — host-side rows, never device ops.
ANNOTATION_PREFIX = "dlrover."
#: Host ranges of the wire's collectives: ``wire:<axis>/<leg>``.
WIRE_PREFIX = "wire:"
#: Host ranges of modules during a capture (``utils/profiler.capture``):
#: ``module:<qualified name>``.
MODULE_PREFIX = "module:"

#: Kineto categories of the events that ran on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The port's hand-written CUDA kernels (the ``__global__`` functions of
#: ``ops/csrc``): a window on a card counts the launches of each by name.
PORT_KERNELS = (
    "flash_fwd_kernel", "flash_bwd_prep_kernel", "flash_bwd_kv_tile_kernel",
    "flash_bwd_dq_kernel", "norm_bwd_kernel", "norm_param_reduce_kernel",
    "expert_tables_kernel", "gmm_kernel", "copy_vec_kernel",
    "copy_strided_kernel", "quantize_kernel", "dequantize_kernel",
    "q8_adam_kernel", "q4_adam_kernel", "q4_code_check_kernel",
    "copy_rows_kernel", "byte_sums_kernel",
)
_PORT_KERNEL_RE = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")\b")
#: Kineto categories of host rows.
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# Capture windows open in this process (torch.profiler is process-wide).
_ARMED = [0]


def armed() -> bool:
    """Whether a capture window is open in this process."""
    return _ARMED[0] > 0


@contextlib.contextmanager
def armed_window():
    """Mark a capture window open for the wire's ranges."""
    _ARMED[0] += 1
    try:
        yield
    finally:
        _ARMED[0] -= 1


def leg_range(axis: str, leg: str):
    """An open ``wire:<axis>/<leg>`` host range while a window is armed
    (close it with :func:`close_range`), else None."""
    if not _ARMED[0]:
        return None
    rf = torch.profiler.record_function(f"{WIRE_PREFIX}{axis}/{leg}")
    rf.__enter__()
    return rf


def close_range(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


def _collective_leg(op_name: str) -> Optional[str]:
    """The collective *leg* an op belongs to, normalized to a metric-safe
    name, or None for a non-collective op: a wire range's own leg
    (``wire:data/all_reduce`` -> ``all_reduce``), an NCCL kernel's leg
    from its name, else the first matching key of the reference's table
    (``all-reduce.3`` -> ``all_reduce``)."""
    if op_name.startswith(WIRE_PREFIX):
        return op_name.rpartition("/")[2] or None
    lowered = op_name.lower()
    if "nccl" in lowered:
        flat = lowered.replace("_", "")
        for key, leg in _NCCL_LEGS:
            if key in flat:
                return leg
        return "collective"
    for key in _COLLECTIVE_KEYS:
        if key in op_name:
            return key.replace("-", "_")
    return None


def _is_device_op(name: str) -> bool:
    if name.startswith(ANNOTATION_PREFIX):
        return False
    # Envelope rows (whole-program / while-loop spans) would double-count
    # the leaves; bare integers are XLA's anonymous envelope ids.
    if name.startswith("jit_") or re.fullmatch(r"while\.\d+|\d+", name):
        return False
    return bool(_HLO_NAME.match(name))


@dataclasses.dataclass
class DeviceWindow:
    """One parsed capture window: per-kind device seconds + overlap."""

    #: phase kind -> device seconds summed over the window's ops.
    phases: Dict[str, float]
    #: Fraction of collective time that ran concurrently with compute
    #: (0.0 = fully exposed, 1.0 = fully hidden).
    overlap_fraction: float
    #: Total op seconds in the window.
    device_total_s: float
    #: Op rows counted (diagnostic).
    op_count: int = 0
    #: Per-collective-leg attribution: leg name (``all_reduce``,
    #: ``all_gather``, ``reduce_scatter``, ``send``, ...) -> (seconds,
    #: overlap fraction vs compute).
    legs: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict
    )
    #: Launches of each of ``PORT_KERNELS`` in the window (a card's trace
    #: only; names never launched are absent).
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)

    def seconds(self, kind: str) -> float:
        return self.phases.get(kind, 0.0)


def _merge_intervals(
    intervals: List[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [intervals[0]]
    for start, end in intervals[1:]:
        if start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def overlap_seconds(
    compute: List[Tuple[float, float]],
    collective: List[Tuple[float, float]],
) -> float:
    """Wall seconds where merged compute and collective intervals
    coincide — the numerator of the overlap fraction."""
    a, b = _merge_intervals(compute), _merge_intervals(collective)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


# -- kineto traces ---------------------------------------------------------------


@dataclasses.dataclass
class KinetoOp:
    """One op of a kineto trace's "device": a GPU event, or (on the CPU)
    a ``cpu_op`` with its self time."""

    name: str
    t0: float             # seconds
    dur: float            # seconds counted (the self time of a cpu_op)
    end: float            # seconds: the op's whole interval ends here
    module: str = ""      # attributed module path, "" when none
    collective: bool = False
    top_level: bool = True


@dataclasses.dataclass
class KinetoTrace:
    """What the parsers read of one kineto trace."""

    ops: List[KinetoOp]
    #: Host ranges of the wire: (leg, t0, t1) in seconds.
    wire: List[Tuple[str, float, float]]
    on_device: bool       # the ops ran on a card (else on the CPU)


def is_kineto(events: Sequence[Any]) -> bool:
    """Whether ``events`` come from ``torch.profiler`` (kineto rows carry
    a ``cat``; the reference's rows do not)."""
    return any(isinstance(e, dict) and e.get("cat") in DEVICE_CATS + _HOST_CATS
               for e in events)


def module_label(qualified: str) -> str:
    """``blocks.3.attn.qkv`` -> ``blocks/attn/qkv``: a module's qualified
    name without its layer indices, the path the reference reads from
    HLO metadata."""
    return "/".join(p for p in qualified.split(".") if p and not p.isdigit())


def _seconds(value: Any) -> float:
    return float(value) / 1e6


def kineto_ops(events: Sequence[Any]) -> KinetoTrace:
    """Read a kineto trace's ops and the wire's host ranges.

    Each op is given a module in one way:

    * a forward op or kernel takes the innermost ``module:`` range open
      around it (or around the launch of a kernel: the runtime call
      whose ``correlation`` the kernel carries, else the ``cpu_op``
      whose ``External id`` it carries) on the launching thread;
    * a backward op or kernel takes the module of its forward op: the
      innermost autograd node around it carries the forward op's
      ``Sequence number``, and the last op on a thread to record that
      number made the node (ops before it that make none record the
      number the next node will take) and sits in a ``module:`` range;
      the thread is another than the backward's where there is one (a
      recompute's forward ops on autograd's thread number themselves);
    * anything else (the optimizer's update, gradient accumulation, the
      loss outside any module) has no module (``""``).
    """
    device, host = [], {}
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in _HOST_CATS:
            host.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    by_corr: Dict[Any, Tuple] = {}
    by_ext: Dict[Any, Tuple] = {}
    forward: Dict[int, Dict[Any, Optional[Tuple]]] = {}
    cpu_rows: List[Tuple[Dict, Any, Tuple, bool, List[Any]]] = []
    wire: List[Tuple[str, float, float]] = []
    wire_by_tid: Dict[Any, List[Tuple[float, float]]] = {}
    for tid, rows in host.items():
        rows.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                 -float(e.get("dur", 0.0))))
        # Stack entries: [end_us, attr, child cpu_ops' us, is a cpu_op].
        stack: List[List[Any]] = []
        for e in rows:
            name = str(e.get("name", ""))
            ts = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
            if e.get("cat") == "user_annotation" and \
                    name.startswith(WIRE_PREFIX):
                # Async legs need not nest: kept out of the stack.
                wire.append((_collective_leg(name) or "collective",
                             _seconds(ts), _seconds(ts + dur)))
                wire_by_tid.setdefault(tid, []).append((ts, ts + dur))
                continue
            while stack and stack[-1][0] <= ts:
                stack.pop()
            attr = stack[-1][1] if stack else None
            args = e.get("args") or {}
            cat = e.get("cat")
            if cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    by_corr[args["correlation"]] = attr
                continue
            own = attr
            if cat == "user_annotation" and name.startswith(MODULE_PREFIX):
                own = ("m", module_label(name[len(MODULE_PREFIX):]))
            elif cat == "cpu_op" and "Sequence number" in args:
                if int(args.get("Fwd thread id", 0) or 0) > 0:
                    own = ("s", int(args["Sequence number"]), tid)
                else:
                    forward.setdefault(int(args["Sequence number"]),
                                       {})[tid] = attr
            entry = [ts + dur, own, 0.0, cat == "cpu_op"]
            if cat == "cpu_op":
                if "External id" in args:
                    by_ext[args["External id"]] = own
                parent = next((s for s in reversed(stack) if s[3]), None)
                if parent is not None:
                    parent[2] += dur
                cpu_rows.append((e, tid, own, parent is None, entry))
            stack.append(entry)

    def module_of(attr) -> str:
        if attr is None:
            return ""
        if attr[0] == "m":
            return attr[1]
        found = forward.get(attr[1], {})
        others = [a for t, a in found.items() if t != attr[2]]
        pick = others[0] if others else found.get(attr[2])
        return pick[1] if pick is not None and pick[0] == "m" else ""

    ops: List[KinetoOp] = []
    if device:
        for e in device:
            args = e.get("args") or {}
            if args.get("correlation") in by_corr:
                attr = by_corr[args["correlation"]]
            else:
                attr = by_ext.get(args.get("External id"))
            name = str(e.get("name", ""))
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            ops.append(KinetoOp(
                name, _seconds(ts), _seconds(dur), _seconds(ts + dur),
                module_of(attr), "nccl" in name.lower()))
        return KinetoTrace(ops, wire, True)
    for tid in wire_by_tid:
        wire_by_tid[tid].sort()
    for e, tid, attr, top, entry in cpu_rows:
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        spans = wire_by_tid.get(tid, ())
        opened = spans[:bisect.bisect_right(spans, (ts, float("inf")))]
        inside = any(end >= ts + dur for _, end in opened)
        ops.append(KinetoOp(
            str(e.get("name", "")), _seconds(ts),
            _seconds(max(0.0, dur - entry[2])), _seconds(ts + dur),
            module_of(attr), inside, top))
    return KinetoTrace(ops, wire, False)


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    return sum(t1 - t0 for t0, t1 in _merge_intervals(intervals))


def _kineto_window(trace: KinetoTrace) -> Optional[DeviceWindow]:
    """A kineto trace's window.  Compute is the ops' seconds; collective
    seconds are the union of the collective intervals, and a leg's the
    union of its own: the host ranges of asynchronous legs overlap one
    another (a bucket's reduce-scatter is issued while the last one is
    in flight), so their sum would count the same wall time again."""
    compute = 0.0
    compute_iv: List[Tuple[float, float]] = []
    leg_iv: Dict[str, List[Tuple[float, float]]] = {}
    kernels: Dict[str, int] = {}
    count = 0
    for op in trace.ops:
        if op.collective and not trace.on_device:
            continue  # host work of a wire leg: its range books it
        if trace.on_device:
            found = _PORT_KERNEL_RE.search(op.name)
            if found:
                kernels[found.group(1)] = kernels.get(found.group(1), 0) + 1
        if op.collective:
            leg = _collective_leg(op.name) or "collective"
            leg_iv.setdefault(leg, []).append((op.t0, op.end))
        else:
            compute += op.dur
            if op.top_level:
                compute_iv.append((op.t0, op.end))
        count += 1
    for leg, t0, t1 in trace.wire:
        if t1 > t0:
            leg_iv.setdefault(leg, []).append((t0, t1))
            count += 1
    if not count:
        return None
    collective_iv = [iv for ivs in leg_iv.values() for iv in ivs]
    phases = {"compute": compute} if compute_iv else {}
    collective = _union_s(collective_iv)
    if collective > 0.0:
        phases["collective"] = collective
    leg_s = {leg: _union_s(ivs) for leg, ivs in leg_iv.items()}
    window = _window(phases, compute_iv, collective_iv, leg_iv, leg_s,
                     compute + collective, count)
    window.kernels = kernels
    return window


def _window(phases, compute_iv, collective_iv, leg_iv, leg_s, total,
            ops) -> DeviceWindow:
    coll_total = phases.get("collective", 0.0)
    overlap = (
        overlap_seconds(compute_iv, collective_iv) / coll_total
        if coll_total > 0.0 else 0.0
    )
    legs = {
        leg: (
            leg_s[leg],
            min(1.0, overlap_seconds(compute_iv, ivs) / leg_s[leg]),
        )
        for leg, ivs in leg_iv.items()
        if leg_s[leg] > 0.0
    }
    return DeviceWindow(
        phases=phases,
        overlap_fraction=min(1.0, overlap),
        device_total_s=total,
        op_count=ops,
        legs=legs,
    )


def load_trace_events(path: str) -> Optional[List[Any]]:
    """The ``traceEvents`` of a Chrome trace (``.gz`` or not), or None
    when the file is unreadable."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        events = data.get("traceEvents", [])
        if not isinstance(events, list):
            return None
        return events
    except (OSError, ValueError, EOFError, AttributeError) as e:
        logger.warning("device trace %s unparseable: %s", path, e)
        return None


def parse_device_trace(path: str) -> Optional[DeviceWindow]:
    """Parse one profiler-written Chrome trace into a :class:`DeviceWindow`.

    A kineto trace is read as the module docstring says.  A trace of the
    reference's format: device lanes are the pids whose ``process_name``
    names a real accelerator (``TPU``/``GPU``/``/device:``); with none,
    the ``CPU`` plane, filtered to HLO-shaped names.

    Returns ``None`` when the trace is unreadable or holds no device ops —
    the degrade-to-no-rows contract: a malformed window must cost the step
    loop nothing but the capture it already paid.
    """
    events = load_trace_events(path)
    if events is None:
        return None
    if is_kineto(events):
        return _kineto_window(kineto_ops(events))
    pid_names: Dict[Any, str] = {}
    for e in events:
        if (
            isinstance(e, dict) and e.get("ph") == "M"
            and e.get("name") == "process_name" and "args" in e
        ):
            pid_names[e.get("pid")] = str(e["args"].get("name", ""))
    device_pids = {
        pid for pid, name in pid_names.items()
        if "TPU" in name or "GPU" in name or "/device:" in name
    }
    if not device_pids:
        # XLA:CPU runs its ops inline on the host plane.
        device_pids = {
            pid for pid, name in pid_names.items() if "CPU" in name
        }
    phases: Dict[str, float] = {}
    compute_iv: List[Tuple[float, float]] = []
    collective_iv: List[Tuple[float, float]] = []
    leg_iv: Dict[str, List[Tuple[float, float]]] = {}
    leg_s: Dict[str, float] = {}
    total = 0.0
    ops = 0
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        if e.get("pid") not in device_pids:
            continue
        name = str(e.get("name", ""))
        if not _is_device_op(name):
            continue
        try:
            t0 = float(e.get("ts", 0.0)) / 1e6
            dur = float(e.get("dur", 0.0)) / 1e6
        except (TypeError, ValueError):
            continue
        if dur <= 0.0:
            continue
        leg = _collective_leg(name)
        kind = "collective" if leg else "compute"
        phases[kind] = phases.get(kind, 0.0) + dur
        if leg:
            collective_iv.append((t0, t0 + dur))
            leg_iv.setdefault(leg, []).append((t0, t0 + dur))
            leg_s[leg] = leg_s.get(leg, 0.0) + dur
        else:
            compute_iv.append((t0, t0 + dur))
        total += dur
        ops += 1
    if not ops:
        return None
    return _window(phases, compute_iv, collective_iv, leg_iv, leg_s,
                   total, ops)


def find_trace_file(trace_dir: str) -> Optional[str]:
    hits = sorted(
        glob.glob(
            os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
        )
        + glob.glob(
            os.path.join(trace_dir, "**", "*.trace.json"), recursive=True
        )
    )
    return hits[-1] if hits else None


def modeled_kind_seconds(rows: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """Sum ``microbatch_phase_plan`` rows into per-phase-kind seconds."""
    out: Dict[str, float] = {}
    for row in rows:
        kind = PHASE_KINDS.get(str(row.get("phase", "")))
        if kind is None:
            continue
        out[kind] = out.get(kind, 0.0) + float(row.get("dur", 0.0))
    return out


def profiler_activities(device: Optional[torch.device] = None) -> list:
    """CPU, and CUDA where the work runs on a card (``device`` None: where
    this process can reach one)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = (device.type == "cuda" if device is not None
            else torch.cuda.is_available())
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class DeviceProfiler:
    """Cadenced ``torch.profiler`` capture windows around single steps.

    The trainer owns one instance when ``profile_every > 0`` and drives
    it from ``train_step``: :meth:`arm` starts a window when the step
    hits the cadence (returns whether it did), :meth:`finish` closes the
    window after the step's device work completed and hands back the
    parsed :class:`DeviceWindow` (or ``None`` on any failure — capture is
    strictly best-effort and must never take a step down with it).  A
    window that cannot start latches the profiler off (``_disabled``): a
    caller that must have its window checks :attr:`windows`.
    """

    def __init__(self, profile_every: int, trace_dir: str = "",
                 device: Optional[torch.device] = None):
        self.profile_every = max(0, int(profile_every))
        self._trace_root = trace_dir
        self._device = device
        self._window_dir: Optional[str] = None
        self._prof = None
        self._armed = None
        self.windows = 0          # capture windows successfully parsed
        self.failed_windows = 0   # started but unparseable/failed windows
        self._disabled = False    # latched on a start failure

    def wants(self, step: int) -> bool:
        return (
            not self._disabled
            and self.profile_every > 0
            and step % self.profile_every == 0
        )

    def arm(self, step: int) -> bool:
        """Open a trace window for ``step`` if the cadence says so."""
        if not self.wants(step):
            return False
        trace_dir = tempfile.mkdtemp(
            prefix=f"dlrover_devprof_{step}_", dir=self._trace_root or None
        )
        try:
            prof = torch.profiler.profile(
                activities=profiler_activities(self._device))
            prof.start()
        except Exception as e:  # noqa: BLE001 - profiler unavailable
            # One loud latch, not one warning per cadence hit: a process
            # that cannot trace now will not trace on the next window.
            logger.warning(
                "device profiler unavailable (%s); disabling capture", e
            )
            self._disabled = True
            shutil.rmtree(trace_dir, ignore_errors=True)
            return False
        self._prof = prof
        self._armed = armed_window()
        self._armed.__enter__()
        self._window_dir = trace_dir
        return True

    def annotation(self, name: str):
        """A host range in our namespace (a marker row; excluded from the
        device-op accounting by its prefix)."""
        return torch.profiler.record_function(ANNOTATION_PREFIX + name)

    def abort(self) -> None:
        """Close the open window without parsing it (the step inside it
        raised): stop the profiler, end the armed window, remove the
        trace directory and count a failed window.  Never raises, so the
        step's own error is the one that propagates."""
        if self._window_dir is None:
            return
        trace_dir, self._window_dir = self._window_dir, None
        prof, self._prof = self._prof, None
        self._armed.__exit__(None, None, None)
        self._armed = None
        try:
            prof.stop()
        except Exception as e:  # noqa: BLE001 - the step's error wins
            logger.warning("device profiler stop failed: %s", e)
        self.failed_windows += 1
        shutil.rmtree(trace_dir, ignore_errors=True)

    def finish(self) -> Optional[DeviceWindow]:
        """Close the open window; parse it.  The caller must have waited
        for the step's device work first (the window only holds what the
        device finished before the profiler stops)."""
        if self._window_dir is None:
            return None
        trace_dir, self._window_dir = self._window_dir, None
        prof, self._prof = self._prof, None
        self._armed.__exit__(None, None, None)
        self._armed = None
        try:
            prof.stop()
            path = os.path.join(trace_dir, "window.trace.json")
            prof.export_chrome_trace(path)
        except Exception as e:  # noqa: BLE001 - never fail the step
            logger.warning("device profiler stop failed: %s", e)
            self.failed_windows += 1
            shutil.rmtree(trace_dir, ignore_errors=True)
            return None
        try:
            window = parse_device_trace(path)
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        if window is None:
            self.failed_windows += 1
        else:
            self.windows += 1
        return window


def emit_measured_phases(
    window: DeviceWindow,
    *,
    step: int,
    t_span: float,
    wall_s: float,
    modeled_rows: Sequence[Dict[str, Any]],
    cache_key: str = "",
) -> int:
    """Book one capture window into the telemetry plane.

    Emits (a) one ``source="measured"`` phase row per phase kind the
    window observed — ``src="device"`` so ``events_to_chrome_trace``
    renders them on their own per-node device track, backdated via
    ``t_mono`` inside the measured step span — and (b) one
    ``"calibration"`` event carrying flat measured/modeled per-kind
    seconds for the master's :class:`CalibrationLedger`.  Returns the
    number of measured rows emitted (0 when the recorder is disabled).
    """
    if not telemetry.recorder().enabled:
        return 0
    modeled = modeled_kind_seconds(modeled_rows)
    rows = 0
    # Sequential layout inside the step span: compute first, collective
    # after — the real lanes overlap (that is what overlap_fraction
    # reports), but additive placement keeps the device track readable
    # next to the modeled rows, which make the same presentation choice.
    t = t_span
    for kind in ("compute", "collective"):
        seconds = window.seconds(kind)
        if seconds <= 0.0:
            continue
        telemetry.event(
            kind, duration_s=seconds, t_mono=t, step=step,
            source="measured", src="device",
            overlap=round(window.overlap_fraction, 4),
        )
        t += seconds
        rows += 1
    attrs: Dict[str, Any] = {
        "step": step,
        "cache_key": cache_key or "uncacheable",
        "overlap": round(window.overlap_fraction, 4),
        "wall_s": round(wall_s, 6),
        "device_total_s": round(window.device_total_s, 6),
    }
    for kind in ("compute", "collective"):
        attrs[f"measured_{kind}"] = round(window.seconds(kind), 6)
        attrs[f"modeled_{kind}"] = round(modeled.get(kind, 0.0), 6)
    # Per-leg split of the collective seconds (flat attrs — the wire
    # format is flat floats): which collective hid and which was exposed.
    for leg, (seconds, frac) in sorted(window.legs.items()):
        attrs[f"leg_{leg}_s"] = round(seconds, 6)
        attrs[f"leg_{leg}_overlap"] = round(frac, 4)
    for name, launches in sorted(window.kernels.items()):
        attrs[f"kernel_{name}"] = launches
    telemetry.event("calibration", **attrs)
    return rows

"""Step profiler and host-side step-pipeline accounting (port of
``dlrover_tpu/utils/profiler.py``).

The device-time breakdown: one window around ``steps`` calls of a step is
captured with ``torch.profiler`` (:func:`capture`), exported as a Chrome
trace and parsed back (pure stdlib, :func:`parse_chrome_trace`) into a
table of ops keyed by the module that ran them, with the step's device
time and MFU.  The reference reads a module path from each op's HLO
metadata; a kineto trace has none, so :func:`capture` opens a
``module:<name>`` range around each submodule's forward while its window
is open (forward hooks, removed after it), and
``utils/device_profile.kineto_ops`` gives each kernel its module: the
range open around its launch, or for a backward kernel the range of the
forward op whose autograd node launched it.  A kernel no rule reaches
(the optimizer's update, gradient accumulation) falls back to
:func:`_classify` of its name, as the reference's ops without metadata
do, and :meth:`StepProfile.unattributed_s` reports their share.  The
per-module totals sum to the device total.  On the CPU the ops are
``cpu_op`` rows counted by self time, so nested rows count once.

The pipeline counters: on the card a "place" is a batch's copy from
pinned host memory issued on the prefetcher's CUDA stream, and a "block"
is a device-to-host read that waits for the device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.common import telemetry as _telemetry
from dlrover_tpu_torch.utils import device_profile as _dp
from dlrover_tpu_torch.utils.device_profile import find_trace_file


@dataclasses.dataclass
class OpProfile:
    name: str
    time_s: float
    count: int
    detail: str = ""
    #: The module a kineto parse found (``utils/device_profile.kineto_ops``);
    #: "" where none was found or the trace is in the reference's format.
    module_path: str = ""

    @property
    def module(self) -> str:
        """The module the parse found, else the module-ish path from
        ``op_name="..."`` in ``detail`` (the reference's HLO metadata),
        else the op's class by name."""
        if self.module_path:
            return self.module_path
        m = re.search(r'op_name="[^"]*?((?:[\w.]+/)*[\w.]+)"', self.detail)
        if not m:
            return _classify(self.name)
        path = m.group(1)
        # strip transform prefixes: jit(_train_step)/jvp(Model)/while/body/..
        parts = [
            p for p in path.split("/")
            if not re.match(r"(jit|jvp|transpose|while|body|closed_call|"
                            r"checkpoint|remat\d*)\b", p)
            and "(" not in p
        ]
        return "/".join(parts[:3]) if parts else _classify(self.name)


def _classify(op_name: str) -> str:
    """The reference's classes of an op by name, then those of a CUDA
    kernel's or an ATen op's name."""
    for key, label in (
        ("attn", "attention-kernel"),
        ("convolution", "matmul"),
        ("dot", "matmul"),
        ("dynamic-update-slice", "grad-accumulate"),
        ("all-reduce", "collective"),
        ("all-gather", "collective"),
        ("all-to-all", "collective"),
        ("collective", "collective"),
        ("copy", "copy"),
        ("fusion", "fusion"),
        ("flash", "attention-kernel"),
        ("nccl", "collective"),
        ("gemm", "matmul"),
        ("nvjet", "matmul"),
        ("cutlass", "matmul"),
        ("aten::mm", "matmul"),
        ("aten::addmm", "matmul"),
        ("aten::bmm", "matmul"),
        ("Memcpy", "copy"),
        ("Memset", "copy"),
        ("layer_norm", "norm"),
        ("GammaBeta", "norm"),
        ("softmax", "softmax"),
        ("elementwise", "elementwise"),
        ("reduce_kernel", "reduce"),
    ):
        if key in op_name:
            return label
    return "other"


@dataclasses.dataclass
class StepProfile:
    steps: int
    wall_s: float
    device_total_s: float
    ops: List[OpProfile]

    def per_step(self) -> float:
        return self.device_total_s / max(self.steps, 1)

    def by_module(self) -> Dict[str, float]:
        table: Dict[str, float] = collections.defaultdict(float)
        for op in self.ops:
            table[op.module] += op.time_s
        return dict(sorted(table.items(), key=lambda kv: -kv[1]))

    def unattributed_s(self) -> float:
        """Seconds of ops no module was found for (their module is their
        class by name)."""
        return sum(op.time_s for op in self.ops
                   if not op.module_path and "op_name=" not in op.detail)

    def mfu(self, flops_per_step: float, peak_flops: float) -> float:
        step_s = self.per_step()
        return flops_per_step / (peak_flops * step_s) if step_s else 0.0

    def table(self, top: int = 20) -> str:
        """Human-readable profile (the ``print_model_profile`` analogue)."""
        lines = [
            f"device time/step: {self.per_step():.4f}s "
            f"(wall {self.wall_s:.2f}s over {self.steps} steps)",
            f"{'s/step':>10}  {'share':>6}  {'n':>5}  op / module",
        ]
        step_total = max(self.per_step(), 1e-12)
        for op in sorted(self.ops, key=lambda o: -o.time_s)[:top]:
            per = op.time_s / self.steps
            lines.append(
                f"{per:10.4f}  {per / step_total:6.1%}  "
                f"{op.count:5d}  {op.name}  [{op.module}]"
            )
        lines.append("-- by module --")
        for module, t in list(self.by_module().items())[:top]:
            per = t / self.steps
            lines.append(f"{per:10.4f}  {per / step_total:6.1%}  {module}")
        return "\n".join(lines)


def parse_chrome_trace(path: str, steps: int, wall_s: float) -> StepProfile:
    """Aggregate device-lane op durations from a profiler trace: a kineto
    trace by (op, module), counted once (see the module docstring); a
    trace of the reference's format as the reference does."""
    events = _dp.load_trace_events(path) or []
    if _dp.is_kineto(events):
        return _parse_kineto(events, steps, wall_s)
    pid_names = {
        e["pid"]: str(e["args"].get("name", ""))
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and "args" in e
    }
    device_pids = {
        pid for pid, name in pid_names.items()
        if "TPU" in name or "GPU" in name or "/device:" in name
    }
    dur: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    detail: Dict[str, str] = {}
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        name = e["name"]
        # Skip the envelope rows (whole-program and while-loop spans) so the
        # leaf table sums to the device time once, not 3x.
        if name.startswith("jit_") or re.fullmatch(r"while\.\d+|\d+", name):
            continue
        d = float(e.get("dur", 0)) / 1e6
        dur[name] += d
        cnt[name] += 1
        total += d
        if name not in detail:
            args = e.get("args", {})
            detail[name] = str(
                args.get("long_name") or args.get("tf_op") or ""
            )
    ops = [
        OpProfile(name, dur[name], cnt[name], detail.get(name, ""))
        for name in dur
    ]
    return StepProfile(
        steps=steps, wall_s=wall_s, device_total_s=total, ops=ops
    )


def _parse_kineto(events, steps: int, wall_s: float) -> StepProfile:
    dur: Dict[Tuple[str, str], float] = collections.Counter()
    cnt: Dict[Tuple[str, str], int] = collections.Counter()
    total = 0.0
    for op in _dp.kineto_ops(events).ops:
        key = (op.name, op.module)
        dur[key] += op.dur
        cnt[key] += 1
        total += op.dur
    ops = [OpProfile(name, dur[(name, module)], cnt[(name, module)],
                     module_path=module)
           for name, module in dur]
    return StepProfile(steps=steps, wall_s=wall_s, device_total_s=total,
                       ops=ops)


@contextlib.contextmanager
def _module_ranges(root: Optional[torch.nn.Module]):
    """``module:<qualified name>`` host ranges around every submodule's
    forward of ``root`` while the block runs (a thread's ranges nest:
    autograd's thread runs a recompute's forwards)."""
    if root is None:
        yield
        return
    local = threading.local()

    def pre(label):
        def hook(module, inputs):
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            local.__dict__.setdefault("stack", []).append(rf)
        return hook

    def post(module, inputs, output):
        local.stack.pop().__exit__(None, None, None)

    handles = []
    try:
        for name, module in root.named_modules():
            if not name:
                continue
            handles.append(module.register_forward_pre_hook(
                pre(_dp.MODULE_PREFIX + name)))
            handles.append(module.register_forward_hook(post,
                                                        always_call=True))
        yield
    finally:
        for handle in handles:
            handle.remove()


def capture(
    step_fn: Callable,
    args: Sequence = (),
    steps: int = 3,
    trace_dir: Optional[str] = None,
    sync: Optional[Callable] = None,
    *,
    module: Optional[torch.nn.Module] = None,
    warmup: int = 1,
    on_profile: Optional[Callable] = None,
) -> StepProfile:
    """Profile ``steps`` calls of ``step_fn(*args)`` in one
    ``torch.profiler`` window (CPU and, where a card is reachable, CUDA
    activities) and parse the exported trace.

    ``warmup`` calls run first, outside the window.  The window closes
    after ``sync(out)`` (default: ``torch.cuda.synchronize()`` on the
    device of the first tensor the last call returned).  ``module``:
    the model whose submodules get ``module:`` ranges for the parse.
    ``on_profile(prof)`` sees the stopped profiler (its
    ``key_averages()``) before it is dropped.  The trace goes to
    ``trace_dir`` (kept) or a temporary directory (removed).  Only one
    ``torch.profiler`` may run in a process: do not call this inside
    another profiler's window.
    """
    owned = trace_dir is None
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="dlrover_prof_")
    try:
        out = None
        for _ in range(warmup):
            out = step_fn(*args)
        if warmup:
            _sync(out, sync)
        prof = torch.profiler.profile(activities=_dp.profiler_activities())
        with prof, _dp.armed_window(), _module_ranges(module):
            t0 = time.perf_counter()
            for _ in range(steps):
                out = step_fn(*args)
            _sync(out, sync)
            wall = time.perf_counter() - t0
        if on_profile is not None:
            on_profile(prof)
        path = os.path.join(trace_dir, "step.trace.json")
        prof.export_chrome_trace(path)
        return parse_chrome_trace(path, steps, wall)
    finally:
        if owned:
            shutil.rmtree(trace_dir, ignore_errors=True)


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def _sync(out, sync):
    if sync is not None:
        sync(out)
        return
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# Host-side step-pipeline accounting
# ---------------------------------------------------------------------------
#
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

"""The measurement planes' device-time half in the port, held against the
JAX package on the CPU: ``utils/device_profile`` (trace parsing, the
measured rows and calibration events, the capture window),
``utils/profiler`` (the step profile by module), ``master/calibration``
and ``utils/scaling``.

The reference's synthetic traces (``tests/test_device_profile.py``,
``tests/test_profiler.py``) go through both packages' parsers; kineto
traces, which only the port reads, are checked against what their
events say.  Every random input comes from a generator seeded here (the
``rng`` fixture is shared by the whole run).
"""

import collections
import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

import torch_worlds
from dlrover_tpu.common import telemetry as jtelemetry
from dlrover_tpu.master.calibration import CalibrationLedger as JLedger
from dlrover_tpu.utils import device_profile as jdp
from dlrover_tpu.utils import profiler as jprofiler
from dlrover_tpu_torch.common import telemetry as ttelemetry
from dlrover_tpu_torch.master.calibration import CalibrationLedger
from dlrover_tpu_torch.utils import device_profile as tdp
from dlrover_tpu_torch.utils import profiler as tprofiler
from dlrover_tpu_torch.utils import scaling

REL = 1e-12


def _close(got, want):
    """Equal structures; floats within REL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (got,
                                                                     want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=REL, abs=0.0), (got, want)
    else:
        assert got == want, (got, want)


# -- the reference's traces -------------------------------------------------------


def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name}}


def _op(pid, name, ts, dur, **args):
    e = {"ph": "X", "pid": pid, "tid": 1, "name": name, "ts": ts,
         "dur": dur}
    if args:
        e["args"] = args
    return e


_QKV = ('%fusion.1 = f32[] fusion(), metadata={op_name="jit(f)/jvp(M)/'
        'while/body/blocks/attn/qkv/dot_general"}')

REFERENCE_TRACES = {
    "device_plane": [
        _meta(1, "/device:TPU:0"), _meta(2, "/host:CPU"),
        _op(1, "dot.1", 0, 100), _op(1, "fusion.2", 100, 100),
        _op(1, "all-reduce.3", 150, 100), _op(2, "dot.99", 0, 500),
        _op(2, "PjitFunction(f)", 0, 500),
    ],
    "cpu_fallback": [
        _meta(7, "/host:CPU"), _op(7, "PjitFunction(f)", 0, 999),
        _op(7, "$profiler.py:91 start_trace", 0, 999),
        _op(7, "TfrtCpuExecutable::Execute", 0, 999),
        _op(7, "dlrover.step", 0, 999), _op(7, "jit_train_step", 0, 999),
        _op(7, "while.3", 0, 999), _op(7, "42", 0, 999),
        _op(7, "dot.4", 0, 50), _op(7, "broadcast_add_fusion", 50, 25),
        _op(7, "reduce-window", 75, 25),
    ],
    "legs": [
        _meta(1, "/device:GPU:0"), _op(1, "fusion.1", 0, 300),
        _op(1, "all-gather.2", 100, 100), _op(1, "reduce-scatter.4", 250, 80),
        _op(1, "all-to-all.5", 400, 20), _op(1, "collective-permute.6", 420,
                                              10),
    ],
    "metadata": [
        _meta(3, "/device:TPU:0"), _meta(9, "/host:CPU"),
        _op(3, "fusion.1", 0, 1000, long_name=_QKV),
        _op(3, "fusion.1", 1000, 1000), _op(3, "jit_train", 0, 9999),
        _op(3, "while.13", 0, 8888), _op(9, "host_thing", 0, 7777),
        _op(3, "bitcast_dynamic-update-slice_fusion.15", 2000, 30),
        _op(3, "copy.2", 2030, 12),
    ],
    "no_device_ops": [_meta(1, "/host:CPU")],
}


def _write(path, events, gz=False):
    body = json.dumps({"traceEvents": events})
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        f.write(body)
    return str(path)


def _profile_fields(prof):
    return {
        "steps": prof.steps, "wall_s": prof.wall_s,
        "device_total_s": prof.device_total_s,
        "ops": sorted((op.name, op.time_s, op.count, op.detail, op.module)
                      for op in prof.ops),
        "by_module": prof.by_module(), "per_step": prof.per_step(),
        "table": prof.table(),
    }


@pytest.mark.parametrize("gz", [False, True], ids=["json", "gz"])
@pytest.mark.parametrize("name", sorted(REFERENCE_TRACES))
def test_reference_traces_parse_alike(tmp_path, name, gz):
    suffix = ".trace.json.gz" if gz else ".trace.json"
    path = _write(tmp_path / f"t{suffix}", REFERENCE_TRACES[name], gz)
    want, got = jdp.parse_device_trace(path), tdp.parse_device_trace(path)
    if want is None:
        assert got is None
    else:
        # The port's window also counts its own kernels' launches, which a
        # trace of the reference's format never holds.
        got_fields = dataclasses.asdict(got)
        assert got_fields.pop("kernels") == {}
        _close(got_fields, dataclasses.asdict(want))
    _close(_profile_fields(tprofiler.parse_chrome_trace(path, 2, 0.5)),
           _profile_fields(jprofiler.parse_chrome_trace(path, 2, 0.5)))
    assert tdp.find_trace_file(str(tmp_path)) == \
        jdp.find_trace_file(str(tmp_path)) == path


def test_a_malformed_trace_degrades_to_no_window(tmp_path):
    junk = tmp_path / "junk.trace.json"
    junk.write_text("this is not json{{{")
    assert jdp.parse_device_trace(str(junk)) is None
    assert tdp.parse_device_trace(str(junk)) is None


def test_classes_by_name_and_mfu_match_the_reference():
    for name in ("bitcast_dynamic-update-slice_fusion.15", "all-reduce.7",
                 "dot.3", "convolution.1", "copy.2", "loop_fusion", "x"):
        assert tprofiler._classify(name) == jprofiler._classify(name)
    got = tprofiler.StepProfile(steps=2, wall_s=1.0, device_total_s=1.0,
                                ops=[])
    want = jprofiler.StepProfile(steps=2, wall_s=1.0, device_total_s=1.0,
                                 ops=[])
    assert got.mfu(1e12, 4e12) == want.mfu(1e12, 4e12) == 0.5


def test_overlap_and_modeled_kinds_match_the_reference():
    gen = np.random.default_rng(21)
    for _ in range(20):
        a = [tuple(sorted(gen.uniform(0, 10, 2))) for _ in range(6)]
        b = [tuple(sorted(gen.uniform(0, 10, 2))) for _ in range(5)]
        assert tdp.overlap_seconds(a, b) == jdp.overlap_seconds(a, b)
    rows = [{"phase": p, "dur": float(d)} for p, d in zip(
        ("accumulate", "reduce", "update", "reduce_scatter", "allgather",
         "shard_update", "nonsense"), gen.uniform(0, 1, 7))]
    assert tdp.modeled_kind_seconds(rows) == jdp.modeled_kind_seconds(rows)
    assert tdp.PHASE_KINDS == jdp.PHASE_KINDS


# -- the telemetry the window books ---------------------------------------------


def _recording(module):
    rec = module.recorder()
    was = rec.enabled
    rec.configure(enabled=True)
    rec.drain()
    return rec, was


def _emitted(module, dp, window, rows):
    rec, was = _recording(module)
    try:
        n = dp.emit_measured_phases(window, step=50, t_span=10.0,
                                    wall_s=0.35, modeled_rows=rows,
                                    cache_key="abc123")
        events = rec.drain()
    finally:
        rec.configure(enabled=was)
    return n, [(e[0], e[1], e[3], e[4]) for e in events]


@pytest.mark.parametrize("legs", [False, True], ids=["no_legs", "legs"])
def test_emit_measured_phases_books_as_the_reference(legs):
    gen = np.random.default_rng(7)
    compute, collective, frac = (float(v) for v in gen.uniform(0, 1, 3))
    fields = dict(phases={"compute": compute, "collective": collective},
                  overlap_fraction=frac,
                  device_total_s=compute + collective, op_count=5)
    if legs:
        fields["legs"] = {"all_reduce": (collective / 3, 0.25),
                          "all_gather": (2 * collective / 3, 0.75)}
    rows = [{"phase": "accumulate", "dur": 0.25},
            {"phase": "reduce_scatter", "dur": 0.05},
            {"phase": "allgather", "dur": 0.02}]
    want = _emitted(jtelemetry, jdp, jdp.DeviceWindow(**fields), rows)
    got = _emitted(ttelemetry, tdp, tdp.DeviceWindow(**fields), rows)
    assert got == want and got[0] == 2


def test_calibration_ledger_matches_the_reference():
    gen = np.random.default_rng(11)
    want, got = JLedger(), CalibrationLedger()
    keys = ["k1", "k2", ""]
    for _ in range(200):
        key = keys[gen.integers(3)]
        phase = ("compute", "collective")[gen.integers(2)]
        measured, modeled = (float(v) for v in gen.uniform(-0.2, 2.0, 2))
        frac = float(gen.uniform(-0.2, 1.2))
        for ledger in (want, got):
            ledger.observe(key, phase, measured, modeled)
            ledger.observe_overlap(key, frac)
    for key in keys + [None]:
        _close(got.ratios(key), want.ratios(key))
        _close(got.overlap(key), want.overlap(key))
    for key in keys:
        assert got.observations(key) == want.observations(key)
    _close(got.state(), want.state())
    assert len(got) == len(want)
    restored = CalibrationLedger()
    restored.restore(want.state())
    _close(restored.state(), want.state())


# -- kineto traces --------------------------------------------------------------


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 10, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _kineto_gpu_trace():
    """A forward matmul in ``blocks.0.attn.qkv``, its backward kernel
    launched on autograd's thread (2) under the node carrying the forward
    op's sequence number, a kernel outside any module, an NCCL kernel and
    one gloo leg of the wire."""
    return [
        _x("user_annotation", "module:blocks.0.attn", 0, 100),
        _x("user_annotation", "module:blocks.0.attn.qkv", 5, 60),
        _x("cpu_op", "aten::linear", 10, 50, **{
            "Sequence number": 4, "Fwd thread id": 0, "External id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=100),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           200, 40, tid=2, **{"Sequence number": 4, "Fwd thread id": 1}),
        _x("cpu_op", "aten::mm", 205, 30, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 5, tid=2,
           correlation=101),
        _x("cuda_runtime", "cudaLaunchKernel", 300, 5, correlation=102),
        _x("cuda_runtime", "cudaLaunchKernel", 320, 5, correlation=103),
        _x("user_annotation", "wire:data/all_reduce", 400, 200),
        _x("user_annotation", "dlrover.step", 0, 700),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "module:x",
         "pid": 0, "tid": 7, "ts": 0, "dur": 999},
        _kernel("void gemm_kernel<...>", 30, 40, 100),
        _kernel("void gemm_kernel<...>", 220, 60, 101),
        _kernel("void at::native::vectorized_elementwise_kernel", 310, 10,
                102),
        _kernel("ncclDevKernel_AllGather_RING_LL", 330, 50, 103),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0,
         "tid": 8, "ts": 450, "dur": 20, "args": {}},
    ]


def test_a_kineto_module_is_taken_as_found():
    """A module from a kineto parse is the op's module as it stands: no
    rule of the reference's HLO paths drops or cuts its parts."""
    path = "blocks/body/checkpoint/mlp/wi"
    op = tprofiler.OpProfile("gemm", 1e-3, 1, module_path=path)
    assert op.module == path
    prof = tprofiler.StepProfile(1, 1.0, 2e-3, [
        op, tprofiler.OpProfile("elementwise_kernel", 1e-3, 1)])
    assert prof.by_module() == {path: 1e-3, "elementwise": 1e-3}
    assert prof.unattributed_s() == 1e-3


def test_kineto_kernels_take_their_modules_and_legs(tmp_path):
    path = _write(tmp_path / "k.trace.json", _kineto_gpu_trace())
    prof = tprofiler.parse_chrome_trace(path, 1, 1.0)
    assert prof.device_total_s == pytest.approx(180e-6, rel=REL)
    by_module = prof.by_module()
    assert by_module == pytest.approx({
        "blocks/attn/qkv": 100e-6, "elementwise": 10e-6,
        "collective": 50e-6, "copy": 20e-6}, rel=REL)
    assert sum(by_module.values()) == pytest.approx(prof.device_total_s,
                                                    rel=REL)
    assert prof.unattributed_s() == pytest.approx(80e-6, rel=REL)
    window = tdp.parse_device_trace(path)
    # compute: 40 + 60 + 10 + 20 us; collective: the NCCL kernel's 50 us
    # and the wire's 200 us host range, half of it under the memcpy.
    assert window.phases == pytest.approx(
        {"compute": 130e-6, "collective": 250e-6}, rel=REL)
    assert window.device_total_s == pytest.approx(380e-6, rel=REL)
    assert window.op_count == 6
    assert set(window.legs) == {"all_gather", "all_reduce"}
    assert window.legs["all_reduce"] == pytest.approx((200e-6, 0.1),
                                                      rel=REL)
    assert window.legs["all_gather"] == pytest.approx((50e-6, 0.0))


def test_a_window_counts_the_port_kernels_it_saw(tmp_path):
    """A card's window counts the launches of the port's own kernels by
    name and the calibration event carries them as flat attributes (the
    master's timeline shows which hand-written kernels a profiled step
    ran); a window without them has none."""
    events = _kineto_gpu_trace() + [
        _kernel("void flash_fwd_kernel<64, 2, 2>(CUtensorMap, CUtensorMap,"
                " CUtensorMap, FwdParams)", 500 + 10 * i, 5, 200 + i)
        for i in range(3)] + [
        _kernel("void flash_bwd_kv_tile_kernel<64, 2, true, 2, 1>("
                "CUtensorMap)", 600, 8, 300),
        _kernel("void my_flash_fwd_kernel_v2<1>()", 650, 4, 301)]
    window = tdp.parse_device_trace(_write(tmp_path / "f.json", events))
    assert window.kernels == {"flash_fwd_kernel": 3,
                              "flash_bwd_kv_tile_kernel": 1}
    assert tdp.parse_device_trace(_write(
        tmp_path / "g.json", _kineto_gpu_trace())).kernels == {}
    _, rows = _emitted(ttelemetry, tdp, window, [])
    (attrs,) = [a for name, _, _, a in rows if name == "calibration"]
    assert {k: v for k, v in attrs.items() if k.startswith("kernel_")} == {
        "kernel_flash_bwd_kv_tile_kernel": 1, "kernel_flash_fwd_kernel": 3}


def test_kineto_cpu_ops_count_their_self_time(tmp_path):
    """On the CPU the ops are the device: nested rows count once (self
    time), and a gloo op inside a wire range is the leg's host work."""
    events = [
        _x("user_annotation", "module:mlp.wi", 0, 100),
        _x("cpu_op", "aten::linear", 0, 100, **{"Sequence number": 1,
                                                "Fwd thread id": 0}),
        _x("cpu_op", "aten::t", 2, 8),
        _x("cpu_op", "aten::addmm", 20, 70),
        _x("cpu_op", "aten::copy_", 30, 10),
        _x("cpu_op", "AddmmBackward0", 200, 50, **{"Sequence number": 1,
                                                   "Fwd thread id": 1}),
        _x("cpu_op", "aten::mm", 210, 30),
        _x("user_annotation", "wire:data/reduce_scatter", 300, 60),
        _x("cpu_op", "c10d::reduce_scatter_tensor_", 305, 50),
        _x("cpu_op", "aten::add_", 400, 10),
    ]
    path = _write(tmp_path / "c.trace.json", events)
    prof = tprofiler.parse_chrome_trace(path, 1, 1.0)
    # 100 + 50 + 50 + 10 us of top-level ops, each counted once.
    assert prof.device_total_s == pytest.approx(210e-6, rel=REL)
    got = {(op.name, op.module): op.time_s for op in prof.ops}
    assert got == pytest.approx({
        ("aten::linear", "mlp/wi"): 22e-6, ("aten::t", "mlp/wi"): 8e-6,
        ("aten::addmm", "mlp/wi"): 60e-6, ("aten::copy_", "mlp/wi"): 10e-6,
        ("AddmmBackward0", "mlp/wi"): 20e-6, ("aten::mm", "mlp/wi"): 30e-6,
        ("c10d::reduce_scatter_tensor_", "other"): 50e-6,
        ("aten::add_", "other"): 10e-6}, rel=REL)
    window = tdp.parse_device_trace(path)
    assert window.phases == pytest.approx(
        {"compute": 160e-6, "collective": 60e-6}, rel=REL)
    assert set(window.legs) == {"reduce_scatter"}
    assert window.overlap_fraction == 0.0


def test_overlapping_async_legs_count_their_wall_time_once(tmp_path):
    """Asynchronous legs in flight together (the overlap engine's
    buckets) count the wall time they cover once, per leg and in all."""
    events = [
        _x("cpu_op", "aten::mm", 0, 100),
        _x("user_annotation", "wire:data/reduce_scatter", 50, 100),
        _x("user_annotation", "wire:data/reduce_scatter", 80, 100),
        _x("user_annotation", "wire:data/all_gather", 170, 40),
    ]
    window = tdp.parse_device_trace(_write(tmp_path / "a.trace.json",
                                           events))
    # reduce-scatter covers 50-180, the all-gather 170-210: 160 us in all.
    assert window.phases == pytest.approx(
        {"compute": 100e-6, "collective": 160e-6}, rel=REL)
    assert window.legs["reduce_scatter"] == pytest.approx(
        (130e-6, 50 / 130), rel=REL)
    assert window.legs["all_gather"] == pytest.approx((40e-6, 0.0))
    assert window.device_total_s == pytest.approx(260e-6, rel=REL)
    assert window.overlap_fraction == pytest.approx(50 / 160, rel=REL)


def test_a_real_cpu_capture_counts_each_op_once(tmp_path):
    """``capture`` of the port's small train step on the CPU: the parsed
    total is the top-level ops' time (each row once, not the nested sum),
    the modules sum to it, and the model's modules are found."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib as ttl

    cfg = gpt2_config("124m", **torch_worlds.TINY, dtype=torch.float32)
    train = ttl.build_train(cfg, ttl.make_optimizer("adamw",
                                                    learning_rate=1e-3),
                            global_batch_size=torch_worlds.BATCH,
                            seq_len=torch_worlds.SEQ, device="cpu")
    state = train.init(seed=0)
    batch = ttl.shard_batch(torch_worlds.lm_batch(0), train)
    seen = {}
    prof = tprofiler.capture(train.step, (state, batch), steps=1,
                             trace_dir=str(tmp_path), module=state.model,
                             on_profile=lambda p: seen.update(p=p))
    assert "p" in seen and prof.steps == 1 and prof.wall_s > 0
    path = tdp.find_trace_file(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = sorted(((e["tid"], float(e["ts"]), float(e["dur"]))
                  for e in events if e.get("cat") == "cpu_op"),
                 key=lambda r: (r[0], r[1], -r[2]))
    top, ends = 0.0, {}
    for tid, ts, dur in ops:
        if ts >= ends.get(tid, -1.0):
            top += dur
            ends[tid] = ts + dur
    nested = sum(dur for _, _, dur in ops)
    assert prof.device_total_s == pytest.approx(top / 1e6, rel=1e-9)
    assert nested > 1.5 * top
    by_module = prof.by_module()
    assert sum(by_module.values()) == pytest.approx(prof.device_total_s,
                                                    rel=1e-9)
    for module in ("blocks/attn/qkv", "blocks/mlp/wi", "blocks/mlp/wo",
                   "embed"):
        assert by_module.get(module, 0.0) > 0.0, (module, by_module)
    assert 0.0 < prof.unattributed_s() < prof.device_total_s
    window = tdp.parse_device_trace(path)
    assert window.device_total_s == pytest.approx(prof.device_total_s,
                                                  rel=1e-9)
    assert window.seconds("collective") == 0.0


def test_a_cpu_capture_gives_each_gemm_its_linear():
    """Under ``flash_only`` each block's linear layers take 4 GEMMs a
    layer in the step: the forward and its recompute by the ranges open
    around them, the dgrad and the wgrad by the backward rule.  (In a
    CPU capture the recompute reaches ``wo``'s GEMM; on the card torch's
    checkpoint stops the recompute before it, and ``chip_smoke.py`` wants
    3 there.)"""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib as ttl

    cfg = gpt2_config("124m", **torch_worlds.TINY, dtype=torch.float32,
                      attention_impl="flash", remat="flash_only")
    train = ttl.build_train(cfg, ttl.make_optimizer("adafactor",
                                                    learning_rate=1e-3),
                            global_batch_size=torch_worlds.BATCH,
                            seq_len=torch_worlds.SEQ, device="cpu")
    state = train.init(seed=0)
    batch = ttl.shard_batch(torch_worlds.lm_batch(0), train)
    prof = tprofiler.capture(train.step, (state, batch), steps=1,
                             module=state.model)
    gemms = collections.Counter()
    for op in prof.ops:
        if tprofiler._classify(op.name) == "matmul":
            gemms[op.module] += op.count
    for module in ("blocks/attn/qkv", "blocks/attn/out", "blocks/mlp/wi",
                   "blocks/mlp/wo"):
        assert gemms[module] == 4 * cfg.num_layers, (module, gemms)


def test_profiler_cadence_and_disable_latch(monkeypatch, tmp_path):
    off = tdp.DeviceProfiler(0)
    assert not off.wants(100) and not off.arm(100)
    prof = tdp.DeviceProfiler(10, trace_dir=str(tmp_path),
                              device=torch.device("cpu"))
    assert prof.wants(10) and prof.wants(20) and not prof.wants(11)
    assert not tdp.armed()
    assert prof.arm(10) and tdp.armed()
    with prof.annotation("step"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    window = prof.finish()
    assert not tdp.armed()
    assert window is not None and window.seconds("compute") > 0.0
    assert (prof.windows, prof.failed_windows) == (1, 0)
    assert os.listdir(tmp_path) == []

    def _boom(*a, **k):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(torch.profiler, "profile", _boom)
    assert not prof.arm(20)
    # Latched: the cadence no longer even wants a window.
    assert prof._disabled and not prof.wants(30)
    assert prof.finish() is None and not tdp.armed()


def test_a_wire_leg_range_opens_only_while_armed():
    assert tdp.leg_range("data", "all_reduce") is None
    tdp.close_range(None)
    with tdp.armed_window():
        rf = tdp.leg_range("data", "all_reduce")
        assert rf is not None
        tdp.close_range(rf)
    assert tdp._collective_leg("wire:data/all_reduce") == "all_reduce"
    assert tdp._collective_leg("ncclDevKernel_ReduceScatter_Sum") == \
        "reduce_scatter"
    assert tdp._collective_leg("all-reduce.3") == \
        jdp._collective_leg("all-reduce.3") == "all_reduce"


# -- the scaling probe -----------------------------------------------------------


def test_measure_scaling_on_cpu_worlds():
    """n = 1 and 2 in gloo worlds on the CPU, through the package's own
    launcher: the world of two measures its comm fraction from the wire's
    legs in its captured step."""
    out = scaling.measure_scaling([2, 1], device="cpu", steps=1)
    assert out["ok"] and out["ns"] == [1, 2]
    one, two = out["points"]
    assert one["efficiency"] == 1.0 and one["comm_source"] == "modeled"
    assert one["comm_fraction"] == 0.0 and not one["zero1"]
    assert two["zero1"] and two["comm_source"] == "measured"
    assert 0.0 < two["comm_fraction"] < 1.0
    assert len(out["table"]) == 3


def test_measure_scaling_refuses_more_worlds_than_cards():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="cards"):
        scaling.measure_scaling([cards + 1], device="cuda")
    assert scaling.measure_scaling([], device="cpu")["ok"] is False

"""The measurement planes' memory half in the port, held against the JAX
package on the CPU: ``utils/memory_profile`` (the buffer registry, the
snapshot and the OOM postmortem), ``master/memory_ledger``, the pools the
trainer, the prefetcher, the serving engine and the hot-row cache
register, and ``agent/monitor``.  Every random input comes from a
generator seeded here (the ``rng`` fixture is shared by the whole run).
"""

import gc
import json
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from dlrover_tpu.master.memory_ledger import MemoryLedger as JLedger
from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.trainer.elastic_trainer import ElasticTrainer as JTrainer
from dlrover_tpu.trainer.elastic_trainer import TrainerConfig as JConfig
from dlrover_tpu.utils import memory_profile as jmp
from dlrover_tpu_torch.agent import monitor
from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.master.memory_ledger import MemoryLedger
from dlrover_tpu_torch.models import gpt2_config, init_params
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    TrainerConfig,
)
from dlrover_tpu_torch.utils import memory_profile as tmp


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Both packages' registries empty around each test, and a job tag of
    the test's own (the trainers' shm arena)."""
    monkeypatch.setenv("DLROVER_TPU_JOB", f"tmp{os.getpid()}_{tmp_path.name}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    jmp.registry().clear()
    tmp.registry().clear()
    yield
    jmp.registry().clear()
    tmp.registry().clear()


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tmp._leaves(tree))


# -- the trainer's pools against the reference's -------------------------------


@pytest.mark.parametrize("opt", ["adafactor", "adamw"])
def test_trainer_pools_match_the_reference(opt):
    """``memory_report=True``: the ``params`` pool equals the reference's
    bytes, and so does ``opt_state`` but for the reference's integer step
    counts (int32 leaves of its state; the port counts steps in host
    integers)."""
    tiny = dict(torch_worlds.TINY)
    jt = JTrainer(jgpt2_config("124m", **tiny, dtype=jnp.float32),
                  JConfig(global_batch_size=8, seq_len=32, optimizer=opt,
                          memory_report=True), client=None)
    want = jmp.registry().pool_bytes()
    counts = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(
        jt.state.opt_state) if jnp.issubdtype(leaf.dtype, jnp.integer))
    trainer = ElasticTrainer(
        gpt2_config("124m", **tiny, dtype=torch.float32),
        TrainerConfig(global_batch_size=8, seq_len=32, optimizer=opt,
                      memory_report=True), device="cpu")
    trainer.state = trainer.train.init(params=state_dict_from_jax(
        jax.tree.map(np.asarray, jt.state.params), trainer.model_config))
    got = tmp.registry().pool_bytes()
    assert got["params"] == want["params"] == _nbytes(trainer.state.params())
    assert counts > 0
    assert got["opt_state"] == want["opt_state"] - counts
    assert got["opt_state"] == _nbytes(trainer.state.opt_state)
    assert {k: v for k, v in got.items() if k not in ("params",
                                                      "opt_state")} == \
        dict.fromkeys(tmp.POOLS[2:], 0)
    stats = tmp.device_memory_stats()
    assert stats["source"] == "registry_fallback"
    assert stats["bytes_in_use"] == got["params"] + got["opt_state"]
    assert stats["limit_bytes"] == 0 and stats["headroom_frac"] == -1.0
    trainer.close()


def test_the_memory_event_rides_the_report(tmp_path):
    rec = telemetry.recorder()
    was = rec.enabled
    rec.configure(enabled=True)
    rec.drain()
    try:
        trainer = ElasticTrainer(
            gpt2_config("124m", **torch_worlds.TINY, dtype=torch.float32),
            TrainerConfig(global_batch_size=8, seq_len=32, report_every=2,
                          memory_report=True), device="cpu")
        trainer.fit([torch_worlds.lm_batch(i) for i in range(4)],
                    max_steps=4)
        events = [e for e in rec.drain() if e[0] == "memory"]
    finally:
        rec.configure(enabled=was)
    assert [e[4]["step"] for e in events] == [2, 4]
    attrs = events[-1][4]
    pools = tmp.registry().pool_bytes()
    for pool in tmp.POOLS:
        assert attrs[f"pool_{pool}_b"] == pools[pool]
    assert attrs["modeled_b"] == pools["params"] + pools["opt_state"]
    assert attrs["measured_b"] == attrs["bytes_in_use"]
    assert attrs["cache_key"] == "uncacheable"
    # The reference's flat keys, and the reserved bytes beside them.
    assert {"bytes_in_use", "peak_bytes", "limit_bytes", "headroom_frac",
            "source", "reserved_bytes"} <= set(attrs)
    trainer.close()


# -- the other pools ---------------------------------------------------------------


def test_prefetch_serving_and_cache_pools_register():
    from dlrover_tpu_torch.data.loader import DevicePrefetcher
    from dlrover_tpu_torch.embedding.device_cache import DeviceHotRowCache
    from dlrover_tpu_torch.serving import ServingEngine

    reg = tmp.registry()
    batches = [{"x": torch.full((4, 8), float(i))} for i in range(4)]
    pf = DevicePrefetcher(batches, lambda b: b, depth=2, device="cpu")
    it = iter(pf)
    next(it)
    assert reg.pool_bytes()["prefetch"] == 2 * 4 * 8 * 4
    cache = DeviceHotRowCache(types.SimpleNamespace(dim=8), capacity=16,
                              max_unique=4, device="cpu")
    assert reg.pool_bytes()["embed_cache"] == 16 * 8 * 4
    cfg = gpt2_config("124m", **torch_worlds.TINY, dtype=torch.float32)
    engine = ServingEngine(cfg, init_params(cfg, seed=1, device="cpu"),
                           slots=2, buckets=(16,), device="cpu")
    pools = reg.pool_bytes()
    assert pools["kv_pool"] == engine.kv_device_bytes() > 0
    assert pools["params"] == _nbytes(dict(engine.model.state_dict()))
    # Weak: each owner's entry goes with it.
    del pf, it, cache, engine
    gc.collect()
    assert reg.pool_bytes() == dict.fromkeys(tmp.POOLS, 0)
    assert len(reg) == 0


def test_registry_holds_methods_weakly_and_prices_failures_zero():
    class Owner:
        def __init__(self):
            self.t = torch.zeros(10, dtype=torch.float32)

        def provide(self):
            return {"a": [self.t, (self.t[:5],)], "n": 3}

    reg = tmp.BufferRegistry()
    owner = Owner()
    reg.register("params", "owner", owner.provide)
    reg.register("nonsense", "lambda", lambda: np.zeros(4, np.float64))
    reg.register("kv_pool", "boom", lambda: 1 / 0)
    pools = reg.pool_bytes()
    assert pools["params"] == 60 and pools["other"] == 32
    assert pools["kv_pool"] == 0
    rows = reg.rows()
    assert [r["nbytes"] for r in rows] == [40, 32, 20]
    assert rows[0]["shape"] == [10] and rows[0]["dtype"] == "torch.float32"
    del owner
    gc.collect()
    assert reg.pool_bytes()["params"] == 0 and len(reg) == 2
    reg.unregister("boom")
    assert len(reg) == 1


def test_per_device_bytes_match_the_reference_on_arrays():
    gen = np.random.default_rng(5)
    for dtype in (np.float32, np.float16, np.int8, np.int64):
        arr = gen.normal(size=tuple(gen.integers(1, 9, 3))).astype(dtype)
        want = jmp.per_device_nbytes(arr)
        assert tmp.per_device_nbytes(arr) == want
        assert tmp.per_device_nbytes(torch.from_numpy(arr)) == want
    assert tmp.per_device_nbytes(3) == jmp.per_device_nbytes(3) == 0
    assert tmp.compiled_memory_analysis(object()) is None
    assert tmp.record_compiled_analysis("k", object()) is None
    assert tmp.compiled_analysis("k") is None


# -- the OOM postmortem --------------------------------------------------------------


def test_is_oom_error_knows_the_allocators_errors():
    assert tmp.is_oom_error(torch.OutOfMemoryError("CUDA out of memory."))
    for text in ("RESOURCE_EXHAUSTED: hbm", "Out of memory while", "x"):
        e = RuntimeError(text)
        assert tmp.is_oom_error(e) == jmp.is_oom_error(e)


def test_postmortem_classifies_and_never_raises(tmp_path, monkeypatch):
    big = torch.zeros(1000, dtype=torch.float32)
    small = torch.zeros(10, dtype=torch.float64)
    tmp.registry().register("opt_state", "big", lambda: [big])
    tmp.registry().register("params", "small", lambda: {"w": small})
    path = tmp.dump_oom_postmortem(
        str(tmp_path / "ckpt"), error=torch.OutOfMemoryError("planted"))
    with open(path) as f:
        report = json.load(f)
    assert report["error"] == "OutOfMemoryError: planted"
    assert report["pools_b"]["opt_state"] == 4000
    assert report["pools_b"]["params"] == 80
    assert [r["name"] for r in report["top"]] == ["big", "small"]
    assert report["rows_total"] == 2 and report["unclassified_live_b"] == 0

    def _boom():
        raise RuntimeError("registry broken")

    monkeypatch.setattr(tmp.registry(), "rows", _boom)
    assert tmp.dump_oom_postmortem(str(tmp_path / "x")) is None


# -- the master's ledger ---------------------------------------------------------------


def test_memory_ledger_matches_the_reference():
    gen = np.random.default_rng(13)
    want, got = JLedger(), MemoryLedger()
    for i in range(40):
        node = int(gen.integers(4))
        attrs = {f"pool_{p}_b": float(gen.integers(0, 1 << 30))
                 for p in tmp.POOLS}
        attrs.update(bytes_in_use=float(gen.integers(0, 1 << 34)),
                     peak_bytes=float(gen.integers(0, 1 << 34)),
                     limit_bytes=float(gen.integers(1 << 34, 1 << 36)),
                     step=i, unknown_attr=1.0)
        if gen.integers(3):
            attrs["headroom_frac"] = float(gen.uniform(0, 1))
        for ledger in (want, got):
            ledger.record(node, source="trainer", cache_key="k",
                          timestamp=float(i), **attrs)
        if i % 13 == 12:
            want.evict(node)
            got.evict(node)
    assert got.per_node() == want.per_node()
    assert got.ledger() == want.ledger()
    assert got.headroom_frac() == want.headroom_frac()
    assert got.state() == want.state() and len(got) == len(want)
    restored = MemoryLedger()
    restored.restore(want.state())
    assert restored.state() == want.state()


# -- the agent's files ------------------------------------------------------------------


def test_device_metrics_file_and_the_monitor_read_it(tmp_path, monkeypatch):
    path = str(tmp_path / "metrics.json")
    assert monitor.write_device_metrics() is None
    monkeypatch.setenv("DLROVER_TPU_METRICS_FILE", path)
    payload = monitor.write_device_metrics()
    with open(path) as f:
        assert json.load(f) == payload
    assert payload["device_mem_gb"] == 0.0  # no card in use here
    reports = []
    client = types.SimpleNamespace(
        report_resource=lambda *a, **k: reports.append((a, k)))
    mon = monitor.ResourceMonitor(client, interval=0.05, metrics_file=path)
    first = mon.sample()
    assert first["mem_gb"] > 0.0 and first["device_util"] == 0.0
    busy, total = monitor.read_cpu_times()
    assert 0.0 <= busy <= total
    mon.start()
    try:
        deadline = 50
        while not reports and deadline:
            time.sleep(0.05)
            deadline -= 1
    finally:
        mon.stop()
    assert reports and len(reports[0][0]) == 4

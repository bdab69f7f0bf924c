"""Port parity: the elastic loop at world 1 (``dlrover_tpu_torch.trainer.
elastic_trainer`` with ``numeric_health``, ``state_digest``, the runtime's
``env`` and ``virtual_mesh``, and the ported
``train_lm`` example) against the JAX package.

A 4-step ``fit`` through both packages from one JAX init holds to
``tests/test_torch_train.py``'s limits; the numeric monitor, the digest,
the mantissa flipper, the grad-accumulation rule and the virtual mesh's
logical shape match exactly.  The rest holds the port's loop to the
reference's contracts: the lagged, prefetched fit equal to the
synchronous one, resume at the committed step with the state bit-equal,
the booked grad-accumulation reference, no NaN state checkpointed, the
epoch accounting, the embedding booking, a checkpoint skipped while
the saver is busy and then made by the end-of-fit barrier, and every
unported option refused with its ROADMAP queue item.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.runtime import virtual_mesh as jvm
from dlrover_tpu.trainer import numeric_health as jnh
from dlrover_tpu.trainer import state_digest as jsd
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu.trainer.elastic_trainer import ElasticTrainer as JTrainer
from dlrover_tpu.trainer.elastic_trainer import TrainerConfig as JConfig
from dlrover_tpu_torch.common import faults, telemetry
from dlrover_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from dlrover_tpu_torch.models import gpt2_config
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.runtime import env as tenv
from dlrover_tpu_torch.runtime import mesh as tmesh
from dlrover_tpu_torch.runtime import virtual_mesh as tvm
from dlrover_tpu_torch.trainer import numeric_health as tnh
from dlrover_tpu_torch.trainer import state_digest as tsd
from dlrover_tpu_torch.trainer import train_lib as ttl
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer,
    TrainerCallback,
    TrainerConfig,
)
from dlrover_tpu_torch.utils.profiler import pipeline_counters

# tests/test_torch_train.py's model, batch and limits.
TINY = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
            max_seq_len=64)
BATCH, SEQ = 8, 32
METRIC_RTOL = 2e-6
PARAM_ATOL = 3e-5


@pytest.fixture(autouse=True)
def _isolated_shm(monkeypatch, tmp_path):
    """The shm arena outlives processes and is named by the job tag."""
    monkeypatch.setenv("DLROVER_TPU_JOB", f"tet{os.getpid()}_{tmp_path.name}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    yield
    _unlink_arena()


def _batches(n, seed=0, vocab=TINY["vocab_size"]):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, size=(BATCH, SEQ + 1), dtype=np.int32)
        out.append({"inputs": toks[:, :-1].copy(),
                    "targets": toks[:, 1:].copy()})
    return out


def _config(**kw):
    kw.setdefault("report_every", 2)
    kw.setdefault("ckpt_every", 1000)
    return TrainerConfig(global_batch_size=BATCH, seq_len=SEQ,
                         learning_rate=1e-3, **kw)


def _trainer(cfg_kw=None, **kw):
    model = gpt2_config("124m", **TINY, dtype=torch.float32,
                        **(cfg_kw or {}))
    return ElasticTrainer(model, _config(**kw), device="cpu")


def _snapshot(state):
    from dlrover_tpu_torch.checkpoint import shm_handler as sh

    return {"".join(p): v.clone() if isinstance(v, torch.Tensor) else v
            for p, v in sh.tree_flatten_with_path(state.checkpoint_tree())}


def _assert_bit_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert torch.equal(g.reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), k
        else:
            assert g == w, k


# -- fit against the reference ------------------------------------------------


def test_fit_matches_the_reference_trainer():
    """4 steps of AdamW through both trainers from one JAX init: per-step
    loss and grad norm within METRIC_RTOL, parameters within PARAM_ATOL
    (the key slice of the qkv bias excluded, as tests/test_torch_train.py
    explains)."""
    batches = _batches(4, seed=3)
    jcfg = jgpt2_config("124m", **TINY, dtype=jnp.float32)
    jtrainer = JTrainer(jcfg, JConfig(global_batch_size=BATCH, seq_len=SEQ,
                                      learning_rate=1e-3, ckpt_every=1000,
                                      report_every=2), client=None)
    init = jax.tree.map(np.asarray, jtrainer.state.params)
    jseen = []
    jtrainer.fit(batches, max_steps=4, on_step=lambda s, m: jseen.append(
        (s, float(m["loss"]), float(m["grad_norm"]))))
    trainer = _trainer()
    cfg = trainer.model_config
    trainer.state = trainer.train.init(params=state_dict_from_jax(init, cfg))
    tseen = []
    trainer.fit(batches, max_steps=4, on_step=lambda s, m: tseen.append(
        (s, float(m["loss"]), float(m["grad_norm"]))))
    assert [s for s, _, _ in tseen] == [s for s, _, _ in jseen] == [1, 2, 3,
                                                                    4]
    np.testing.assert_allclose([x[1:] for x in tseen],
                               [x[1:] for x in jseen], rtol=METRIC_RTOL)
    want = state_dict_from_jax(jax.tree.map(np.asarray,
                                            jtrainer.state.params), cfg)
    got = trainer.state.params()
    hd = cfg.resolved_head_dim
    for name, w in want.items():
        g = got[name]
        if name.endswith("attn.qkv.bias"):
            keep = torch.ones(w.shape, dtype=torch.bool)
            keep[..., hd:2 * hd] = False
            g, w = g[keep], w[keep]
        torch.testing.assert_close(g, w, rtol=0, atol=PARAM_ATOL, msg=name)
    assert trainer.step == jtrainer.step == 4


class _Recorder(TrainerCallback):
    def __init__(self):
        self.events = []

    def on_train_begin(self, trainer):
        self.events.append(("begin",))

    def on_step_end(self, trainer, step, metrics):
        self.events.append(("step", step, float(metrics["loss"]),
                            float(metrics["grad_norm"])))

    def on_evaluate(self, trainer, step, eval_metrics):
        self.events.append(("eval", step, eval_metrics["eval_loss"]))

    def on_checkpoint(self, trainer, step):
        self.events.append(("ckpt", step))

    def on_epoch_end(self, trainer, epoch):
        self.events.append(("epoch", epoch))

    def on_train_end(self, trainer, step):
        self.events.append(("end", step))


def _unlink_arena():
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    arena = f"/dev/shm/{SharedMemoryHandler('h0').name}"
    if os.path.exists(arena):
        os.unlink(arena)


def test_lagged_prefetched_fit_equals_the_synchronous_fit(tmp_path,
                                                          monkeypatch):
    """Same batches: the pipelined loop (metrics_lag 2, prefetch 2) gives
    the synchronous loop's metrics bit for bit, the same callbacks in the
    same order (eval and checkpoint barriers included), the same state,
    and no per-step sync."""
    batches, evals = _batches(6, seed=4), _batches(2, seed=9)

    def run(tag, **kw):
        # Each run its own arena: a trainer restores from shm first.
        _unlink_arena()
        monkeypatch.setenv("DLROVER_TPU_JOB",
                           f"tet{os.getpid()}_{tmp_path.name}_{tag}")
        rec = _Recorder()
        trainer = _trainer(eval_every=3, eval_batches=1, ckpt_every=3,
                           checkpoint_dir=str(tmp_path / tag), **kw)
        trainer.callbacks.append(rec)
        pipeline_counters().reset()
        trainer.fit(batches, max_steps=6, eval_loader=evals)
        summary = pipeline_counters().summary()
        state = _snapshot(trainer.state)
        trainer.close()
        _unlink_arena()
        return rec.events, state, summary

    sync_events, sync_state, sync_summary = run("sync")
    lag_events, lag_state, lag_summary = run("lag", metrics_lag=2,
                                             prefetch_to_device=2)
    assert lag_events == sync_events
    assert [e[0] for e in sync_events] == (
        ["begin"] + ["step"] * 3 + ["eval", "ckpt"] + ["step"] * 3
        + ["eval", "ckpt", "epoch", "end"])
    _assert_bit_equal(lag_state, sync_state)
    assert sync_summary["sync_block_count"] == 3      # reports at 2, 4, 6
    assert lag_summary["sync_block_count"] == 0
    assert lag_summary["flush_block_count"] == 4      # 1-2, 3, 4-5, 6
    assert lag_summary["place_count"] >= 6


@pytest.mark.parametrize("lag", [1, 2, 3])
def test_a_lagged_flush_leaves_the_newest_step_running(lag):
    """Between barriers, every ``lag`` steps one wait materializes the
    ring's entries but the newest, whose step is still running; the
    end-of-fit barrier flushes the rest.  Each step's metrics reach
    ``on_step`` after the next step was dispatched, equal to the
    synchronous loop's."""
    steps = 7
    batches = _batches(steps, seed=11)

    def run(**kw):
        trainer = _trainer(**kw)
        seen = []
        pipeline_counters().reset()
        trainer.fit(batches, max_steps=steps, on_step=lambda s, m: seen.append(
            (s, trainer.step, float(m["loss"]), float(m["grad_norm"]))))
        flushes = [b.steps for b in pipeline_counters().blocks(
            "metrics-flush")]
        trainer.close()
        return seen, flushes

    sync, _ = run()
    lagged, flushes = run(metrics_lag=lag)
    # 7 steps are 1 more than a multiple of each lag: the last flush is
    # the end of fit's, of step 7 alone.
    assert flushes == [tuple(range(at, at + lag))
                       for at in range(1, steps, lag)] + [(steps,)]
    for step, now, *_ in lagged:
        assert now > step or now == steps
    assert [(s, *m) for s, _, *m in lagged] == [(s, *m) for s, _, *m in sync]


def test_evaluate_accumulates_on_device_with_one_fetch():
    trainer = _trainer()
    counters = pipeline_counters()
    counters.reset()
    out = trainer.evaluate(_batches(3, seed=5), max_batches=3)
    assert out["eval_batches"] == 3 and out["eval_tokens"] == 3 * BATCH * SEQ
    want = np.mean([float(trainer.train.eval_step(
        trainer.state, ttl.shard_batch(b, trainer.train))["loss"])
        for b in _batches(3, seed=5)])
    np.testing.assert_allclose(out["eval_loss"], want, rtol=1e-6)
    assert len(counters.blocks("eval-fetch")) == 1
    assert counters.sync_block_count() == 0


# -- checkpoint and resume ------------------------------------------------------


def test_resume_at_the_committed_step_with_the_state_bit_equal(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _trainer(checkpoint_dir=ckpt, ckpt_every=5)
    assert first.fit(_batches(8), max_steps=5) == 5
    saved = _snapshot(first.state)
    first.close()
    second = _trainer(checkpoint_dir=ckpt, ckpt_every=5)
    assert second.step == 5
    _assert_bit_equal(_snapshot(second.state), saved)
    assert second._ckpt.last_extra["grad_accum_ref"] == {"accum": 1,
                                                         "world": 1}
    assert second.fit(_batches(8, seed=1), max_steps=7) == 7
    second.close()
    # Resuming AT max_steps re-commits the state under this world.
    third = _trainer(checkpoint_dir=ckpt, ckpt_every=5)
    assert third.step == 7
    assert third.fit(_batches(2), max_steps=7) == 7
    third.close()
    from dlrover_tpu_torch.common.storage import (
        CheckpointDirLayout,
        PosixDiskStorage,
    )

    assert CheckpointDirLayout(ckpt).latest_step(PosixDiskStorage()) == 7


def test_booked_grad_accum_reference_resolves_as_the_reference(tmp_path):
    """A checkpoint booked at (accum 2, world 2), restored at world 1 by a
    trainer configured for accum 1: grad_accum is the reference's
    ``elastic_grad_accum`` of the booking, and the step is rebuilt."""
    ckpt = str(tmp_path / "ckpt")
    booked = _trainer(checkpoint_dir=ckpt, grad_accum=2,
                      grad_accum_ref_world=2)
    want = jtl.elastic_grad_accum(2, 2, 1, BATCH, 1)
    assert booked.grad_accum == want == 4
    booked.fit(_batches(1), max_steps=1)
    booked.close()
    plain = _trainer(checkpoint_dir=ckpt)
    assert plain.step == 1
    assert (plain._ref_accum, plain._ref_world) == (2, 2)
    assert plain.grad_accum == plain.train.grad_accum == want
    assert plain.vmesh.logical_shape == (2, 1, 1, 1, 1, 1)
    assert plain._accum_extra()["grad_accum_ref"] == {"accum": 2, "world": 2}
    plain.close()


class _BusySaver:
    """Stands for a saver still persisting the previous checkpoint: every
    save while it is busy is skipped (returns False); ``wait`` ends the
    persist."""

    def __init__(self, ckpt):
        self.ckpt, self.busy, self.calls, self.waits = ckpt, True, [], 0
        self.save = ckpt.save_checkpoint

    def save_checkpoint(self, step, state, storage_type, extra=None,
                        layout=None):
        self.calls.append((step, not self.busy))
        if self.busy:
            return False
        return self.save(step, state, storage_type, extra=extra,
                         layout=layout)

    def wait(self, timeout=600.0):
        self.waits += 1
        self.busy = False
        return self.ckpt.wait(timeout)

    def __getattr__(self, name):
        return getattr(self.ckpt, name)


@pytest.mark.parametrize("lag", [0, 2])
def test_a_skipped_save_is_not_booked_and_fit_ends_saved(tmp_path, lag):
    """A cadence save that the busy saver skips leaves the step unsaved
    and fires no ``on_checkpoint``; the end-of-fit barrier waits for the
    saver and saves the final step, which a new trainer resumes."""
    ckpt = str(tmp_path / "ckpt")
    trainer = _trainer(checkpoint_dir=ckpt, ckpt_every=2, metrics_lag=lag)
    rec = _Recorder()
    trainer.callbacks.append(rec)
    busy = trainer._ckpt = _BusySaver(trainer._ckpt)
    pipeline_counters().reset()
    assert trainer.fit(_batches(4), max_steps=4) == 4
    # Cadence saves at 2 and 4 skipped; the barrier tries, waits, saves.
    assert busy.calls == [(2, False), (4, False), (4, False), (4, True)]
    assert busy.waits == 1
    assert [e for e in rec.events if e[0] == "ckpt"] == [("ckpt", 4)]
    assert len(pipeline_counters().blocks("checkpoint-wait")) == 1
    assert trainer._last_saved == 4
    saved = _snapshot(trainer.state)
    trainer.close()
    resumed = _trainer(checkpoint_dir=ckpt)
    assert resumed.step == 4
    _assert_bit_equal(_snapshot(resumed.state), saved)
    resumed.close()


def test_a_skipped_cadence_save_returns_false(tmp_path):
    trainer = _trainer(checkpoint_dir=str(tmp_path / "ckpt"))
    trainer.fit(_batches(1), max_steps=1)
    busy = trainer._ckpt = _BusySaver(trainer._ckpt)
    trainer.step = 3
    assert trainer.save_checkpoint() is False
    assert trainer._last_saved == 1 and busy.waits == 0
    assert trainer.save_checkpoint(wait_for_saver=True) is True
    assert trainer._last_saved == 3 and busy.waits == 1
    trainer.close()


@pytest.mark.parametrize("lag", [0, 2])
def test_a_nan_state_is_never_checkpointed(tmp_path, lag):
    trainer = _trainer(checkpoint_dir=str(tmp_path / "ckpt"), ckpt_every=2,
                       metrics_lag=lag)
    with torch.no_grad():
        trainer.state.model.embed.embedding.fill_(float("nan"))
    trainer.fit(_batches(4), max_steps=4)
    assert trainer._state_poisoned
    assert trainer._ckpt._engine.latest_memory_step() == -1
    assert any(a.kind == "nan" for a in trainer.numeric_monitor.anomalies)
    trainer.close()
    assert _trainer(checkpoint_dir=str(tmp_path / "ckpt")).step == 0


def test_epoch_and_resume_accounting(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    rec = _Recorder()
    trainer = _trainer(checkpoint_dir=ckpt, ckpt_every=100)
    trainer.callbacks.append(rec)
    batches = _batches(3)
    assert trainer.fit(batches, max_steps=100, epochs=2) == 6
    assert trainer.epoch == 2
    assert [e for e in rec.events if e[0] in ("epoch", "ckpt")] == [
        ("epoch", 1), ("epoch", 2), ("ckpt", 6)]
    trainer.close()
    # A restored step implies the epoch of a sized loader: 6 // 3 = 2,
    # so a 3-epoch budget has one epoch left.
    resumed = _trainer(checkpoint_dir=ckpt, ckpt_every=100)
    assert resumed.fit(batches, max_steps=100, epochs=3) == 9
    assert resumed.epoch == 3
    # At or past the budget: nothing runs.
    assert resumed.fit(batches, max_steps=100, epochs=3) == 9
    resumed.close()


def test_fit_freezes_what_was_alive_out_of_the_collector():
    """What is alive when ``fit`` starts sits in the collector's permanent
    generation during the steps (a full collection there scans only what
    the loop made) and is handed back when it returns, even on a raise."""
    import gc

    trainer = _trainer()
    alive = len(gc.get_objects())
    frozen = []
    trainer.fit(_batches(2), max_steps=2,
                on_step=lambda step, m: frozen.append(gc.get_freeze_count()))
    # Most of the process was alive before the fit (the collection at its
    # start frees only garbage).
    assert len(frozen) == 2 and min(frozen) > alive // 2
    assert gc.get_freeze_count() == 0
    with pytest.raises(ValueError, match="re-iterable"):
        trainer.fit(iter(_batches(2)), max_steps=4, epochs=2)
    assert gc.get_freeze_count() == 0


def test_epochs_refuse_a_one_shot_iterator():
    trainer = _trainer()
    with pytest.raises(ValueError, match="re-iterable"):
        trainer.fit(iter(_batches(2)), max_steps=4, epochs=2)
    # Without epochs a generator is one pass.
    assert trainer.fit((b for b in _batches(2)), max_steps=4) == 2


def test_embedding_booking_rides_extra_and_comes_back(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    plane = ShardedEmbeddingTable("plane", dim=4, world=1, native=False)
    keys = np.arange(20, dtype=np.int64)
    _, rows, _ = plane.lookup(keys)
    plane.apply_gradients(keys, np.ones((len(keys), 4), np.float32))
    trainer = _trainer(checkpoint_dir=ckpt, ckpt_every=1)
    trainer.attach_embedding_plane(plane, directory=str(tmp_path / "embed"))
    trainer.fit(_batches(1), max_steps=1)
    booked = plane.booking()
    assert trainer._accum_extra()["embed"] == booked
    trainer.close()
    fresh = ShardedEmbeddingTable("plane", dim=4, world=1, native=False)
    assert fresh.booking() != booked
    resumed = _trainer(checkpoint_dir=ckpt)
    assert resumed._ckpt.last_extra["embed"] == booked
    resumed.attach_embedding_plane(fresh)
    assert fresh.booking() == booked
    resumed.close()
    plane.close()
    fresh.close()


def test_moe_config_trains_and_the_harvest_is_off(caplog):
    """An MoE model trains through ``fit``, and (since the router
    statistics were ported; the name is the test's first) the harvest is
    on: one ``moe`` telemetry event a report, its vector the one
    ``build_moe_stats_fn`` gives for the step's batch."""
    from dlrover_tpu_torch.common import telemetry
    from dlrover_tpu_torch.trainer import train_lib

    telemetry.recorder().configure(enabled=True)
    telemetry.recorder().drain()
    trainer = _trainer(cfg_kw=dict(num_experts=4, top_k=2), report_every=1)
    assert trainer.fit(_batches(3), max_steps=3) == 3
    assert callable(trainer._moe_stats_fn)
    events = [attrs for name, _, _, _, attrs in telemetry.recorder().drain()
              if name == "moe"]
    assert [e["step"] for e in events] == [1, 2, 3]
    vec = train_lib.build_moe_stats_fn(trainer.train)(
        trainer.state, train_lib.shard_batch(_batches(3)[-1], trainer.train))
    assert events[-1]["experts"] == 4 and events[-1]["top_k"] == 2
    assert 0.0 <= events[-1]["drop_fraction"] < 1.0
    load = json.loads(events[-1]["load"])
    assert len(load) == 4 and abs(sum(load) - 1.0) < 1e-5
    assert 0.0 < events[-1]["entropy"] <= np.log(4) + 1e-6
    np.testing.assert_allclose(
        [events[-1]["entropy"], events[-1]["drop_fraction"]] + load,
        vec.double().numpy(), atol=1e-6)
    trainer.close()


# -- the SDC seam ------------------------------------------------------------------


class _FakeMaster:
    """The duck-typed master client the trainer reports to."""

    def __init__(self):
        self.digests = []

    def report_step(self, step, tokens=0, loss=None, anomalies=()):
        pass

    def report_telemetry(self, events, dropped):
        pass

    def report_digest(self, step, digest, check_every=0):
        self.digests.append((step, digest))


def test_sdc_digests_queue_and_the_flip_seam_changes_them():
    master = _FakeMaster()
    clean = _trainer(sdc_check_every=2)
    clean.client = master
    clean.fit(_batches(4), max_steps=4)
    final = int(tsd.digest_state(clean.state))
    assert master.digests[-1] == (4, tsd.format_digest(final))
    assert [s for s, _ in master.digests] == [2, 4]
    assert clean._pending_digests == []
    faults.configure("sdc.flip:error@2", seed=0)
    try:
        flipped = _trainer(sdc_check_every=2)
        flipped.client = _FakeMaster()
        flipped.fit(_batches(4), max_steps=4)
    finally:
        faults.reset()
    d = flipped.client.digests
    assert d[0] == master.digests[0]
    assert d[1][0] == 4 and d[1][1] != tsd.format_digest(final)


@pytest.mark.parametrize("every", [1, 2])
def test_sdc_digests_without_a_master_keep_only_the_newest(every):
    trainer = _trainer(sdc_check_every=every)
    assert trainer.client is None
    trainer.fit(_batches(6), max_steps=6)
    assert len(trainer._pending_digests) == 1
    step, value = trainer._pending_digests[0]
    assert step == 6 and int(value) == int(tsd.digest_state(trainer.state))


# -- refusals ---------------------------------------------------------------------


@pytest.mark.parametrize("field,value,item", [
    ("auto_tune", True, 10),
    ("warmup_compile", True, 3), ("compile_cache_dir", "/tmp/cc", 3),
])
def test_unported_config_fields_are_refused(field, value, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item}"):
        _trainer(**{field: value})


# -- the measurement planes -------------------------------------------------------


@pytest.mark.parametrize("lag", [0, 2])
def test_profile_every_books_measured_rows(lag):
    """Every ``profile_every`` steps one step runs in a profiler window:
    a ``profile-sync`` host block, the measured compute row and one
    calibration event for that step, nothing for the others."""
    rec = telemetry.recorder()
    was = rec.enabled
    rec.configure(enabled=True)
    rec.drain()
    pipeline_counters().reset()
    try:
        trainer = _trainer(profile_every=2, metrics_lag=lag)
        trainer.fit(_batches(5), max_steps=5)
        events = rec.drain()
    finally:
        rec.configure(enabled=was)
    prof = trainer._device_profiler
    assert (prof.windows, prof.failed_windows) == (2, 0)
    measured = [e for e in events if e[4].get("source") == "measured"]
    assert [(e[0], e[4]["step"]) for e in measured] == [("compute", 2),
                                                        ("compute", 4)]
    calib = [e[4] for e in events if e[0] == "calibration"]
    assert [a["step"] for a in calib] == [2, 4]
    assert all(a["measured_compute"] > 0 and a["modeled_compute"] > 0
               and a["cache_key"] == "uncacheable" for a in calib)
    syncs = pipeline_counters().blocks("profile-sync")
    assert [e.steps for e in syncs] == [(2,), (4,)]
    trainer.close()


def test_both_planes_off_construct_nothing():
    pipeline_counters().reset()
    trainer = _trainer()
    assert trainer._device_profiler is None
    assert trainer._memory_registry is None
    trainer.fit(_batches(2), max_steps=2)
    assert not pipeline_counters().blocks("profile-sync")
    trainer.close()


def test_an_oom_writes_the_postmortem_and_propagates(tmp_path, monkeypatch):
    from dlrover_tpu_torch.utils import memory_profile

    memory_profile.registry().clear()
    ckpt = tmp_path / "ckpt"
    trainer = _trainer(checkpoint_dir=str(ckpt), memory_report=True)

    def oom(state, batch):
        raise torch.OutOfMemoryError("CUDA out of memory. (planted)")

    monkeypatch.setattr(trainer.train, "step", oom)
    with pytest.raises(torch.OutOfMemoryError, match="planted"):
        trainer.train_step(_batches(1)[0])
    with open(ckpt / "oom_postmortem.json") as f:
        report = json.load(f)
    assert report["error"].startswith("OutOfMemoryError: CUDA out of")
    params = sum(t.numel() * t.element_size()
                 for t in trainer.state.params().values())
    assert report["pools_b"]["params"] == params
    assert report["pools_b"]["opt_state"] > 0
    assert {r["pool"] for r in report["top"]} == {"params", "opt_state"}
    assert trainer.step == 0
    # Another error passes through without a postmortem.
    os.remove(ckpt / "oom_postmortem.json")
    monkeypatch.setattr(trainer.train, "step",
                        lambda s, b: (_ for _ in ()).throw(KeyError("x")))
    with pytest.raises(KeyError):
        trainer.train_step(_batches(1)[0])
    assert not (ckpt / "oom_postmortem.json").exists()
    trainer.close()
    memory_profile.registry().clear()


def test_a_captured_step_that_raises_closes_its_window(tmp_path,
                                                        monkeypatch):
    """An OOM inside a profiled step stops the profiler and closes the
    armed window before the error propagates; the next window opens."""
    from dlrover_tpu_torch.utils import device_profile as tdp

    trainer = _trainer(profile_every=1, checkpoint_dir=str(tmp_path))
    step = trainer.train.step
    window_dirs = []

    def oom(state, batch):
        assert tdp.armed() and torch.autograd._profiler_enabled()
        window_dirs.append(trainer._device_profiler._window_dir)
        raise torch.OutOfMemoryError("CUDA out of memory. (planted)")

    monkeypatch.setattr(trainer.train, "step", oom)
    with pytest.raises(torch.OutOfMemoryError, match="planted"):
        trainer.train_step(_batches(1)[0])
    prof = trainer._device_profiler
    assert not tdp.armed() and not torch.autograd._profiler_enabled()
    assert (prof.windows, prof.failed_windows) == (0, 1)
    assert prof._prof is None and prof._window_dir is None
    assert window_dirs[0] and not os.path.exists(window_dirs[0])
    assert (tmp_path / "oom_postmortem.json").exists()
    monkeypatch.setattr(trainer.train, "step", step)
    trainer.train_step(_batches(1)[0])
    assert (prof.windows, prof.failed_windows) == (1, 1)
    assert not tdp.armed() and not torch.autograd._profiler_enabled()
    trainer.close()


def test_reports_write_the_agents_device_metrics(tmp_path, monkeypatch):
    path = tmp_path / "metrics.json"
    monkeypatch.setenv("DLROVER_TPU_METRICS_FILE", str(path))
    trainer = _trainer()
    trainer.fit(_batches(2), max_steps=2)
    with open(path) as f:
        assert set(json.load(f)) >= {"device_mem_gb", "device_util",
                                     "timestamp"}
    trainer.close()


@pytest.mark.parametrize("field,value", [
    ("zero1", True), ("overlap", True), ("reduce_quant", "int8"),
    ("allgather_quant", "int8"), ("world", 2),
])
def test_data_parallel_config_fields_at_one_process(field, value):
    """The data-parallel options build at one process, as the reference's
    do at one data rank: ZeRO-1 and the overlap engine deactivate, the
    int8 wires have no wire, and ``world`` is a logical member count."""
    trainer = _trainer(**{field: value})
    assert (trainer.train.zero1, trainer.train.overlap, trainer.train.dp,
            trainer.train.wire) == (False, False, 1, None)
    assert trainer._world == (value if field == "world" else 1)
    trainer.fit(_batches(1), max_steps=1)
    assert trainer.step == 1
    trainer.close()


def test_a_model_parallel_mesh_and_aot_prewarm_are_refused():
    trainer = _trainer()
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        trainer.prewarm_worlds([1, 2], aot=True)
    with pytest.raises(ValueError, match="devices"):
        ElasticTrainer(trainer.model_config, trainer.config,
                       parallel=tmesh.ParallelConfig(data=1, fsdp=2),
                       device="cpu")
    trainer.close()


def test_live_resize_at_one_process_folds_the_logical_world(tmp_path):
    """``apply_world_change`` at one process: the reference's logical
    fold (the step's grad_accum follows the world, tokens/step and the
    step are unchanged), the state re-laid out in memory bit for bit, the
    sampler rebound, and the event booked; ``prewarm_worlds`` maps every
    world to its fold's grad_accum."""
    from dlrover_tpu_torch.data.loader import (
        ElasticDataLoader,
        ElasticDistributedSampler,
    )

    trainer = _trainer(world=4, grad_accum_ref_world=4)
    assert trainer.prewarm_worlds([1, 2, 4]) == {
        w: jtl.elastic_grad_accum(1, 4, w, BATCH, 1) for w in (1, 2, 4)}
    trainer.fit(_batches(2), max_steps=2)
    before = _snapshot(trainer.state)
    sampler = ElasticDistributedSampler(64, num_replicas=4, rank=3)
    trainer._active_loader = ElasticDataLoader(
        lambda i: {"inputs": np.zeros(SEQ, np.int32),
                   "targets": np.zeros(SEQ, np.int32)}, BATCH,
        source=sampler)
    assert trainer.apply_world_change(4)["noop"]
    detail = trainer.apply_world_change(2)
    assert detail["ok"] and not detail["fallback"]
    assert (detail["grad_accum"], detail["fold"]) == (
        jtl.elastic_grad_accum(1, 4, 2, BATCH, 1), 2)
    assert detail["sampler_rebound"] and sampler.num_replicas == 2
    assert sampler.rank == 1  # 3 % 2: the member keeps its identity
    assert trainer.step == 2 and trainer.grad_accum == detail["grad_accum"]
    _assert_bit_equal(_snapshot(trainer.state), before)
    trainer.fit(_batches(3)[2:], max_steps=3)
    assert trainer.step == 3
    trainer.close()


def test_runtime_env_contract(monkeypatch):
    for name in ("DLROVER_TPU_MASTER_ADDR", "DLROVER_TPU_COORDINATOR",
                 "DLROVER_TPU_NUM_PROCESSES", "DLROVER_TPU_RESTART_COUNT"):
        monkeypatch.delenv(name, raising=False)
    assert tenv.master_client() is None
    assert not tenv.under_agent() and tenv.restart_count() == 0
    assert (tenv.process_id(), tenv.num_processes(), tenv.node_id()) == (
        0, 1, 0)
    tenv.initialize()
    monkeypatch.setenv("DLROVER_TPU_RESTART_COUNT", "2")
    assert tenv.restart_count() == 2
    monkeypatch.setenv("DLROVER_TPU_COORDINATOR", "localhost:1")
    tenv.initialize()  # one process under the agent: nothing to join
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "2")
    # The agent's control-plane-only switch: a one-process group of its
    # own (the two-process join itself runs in spawned worlds,
    # tests/test_torch_resize.py and test_torch_zero1.py).
    monkeypatch.setenv("DLROVER_TPU_SKIP_JAX_INIT", "1")
    assert tenv.default_backend("cpu") == "gloo"
    assert tenv.default_backend("cuda") == "nccl"
    tenv.initialize(device="cpu")
    try:
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_backend() == "gloo"
        tenv.initialize(device="cpu")  # a live group is kept
    finally:
        torch.distributed.destroy_process_group()
    monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", "localhost:2")
    monkeypatch.setenv("DLROVER_TPU_NODE_ID", "3")
    from dlrover_tpu_torch.agent.master_client import MasterClient

    client = tenv.master_client()  # no connection until the first call
    assert isinstance(client, MasterClient)
    assert (client._addr, client.node_id) == ("localhost:2", 3)
    from dlrover_tpu.agent import training_agent as agent

    for name in ("ENV_MASTER_ADDR", "ENV_NODE_ID", "ENV_COORDINATOR",
                 "ENV_NUM_PROC", "ENV_PROC_ID", "ENV_RESTART_COUNT"):
        assert getattr(tenv, name) == getattr(agent, name)


# -- numeric health -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numeric_monitor_matches_the_reference(seed):
    """One seeded trace of (loss, grad_norm) with NaN, Inf, spikes,
    explosions and missing grad norms: the same anomaly stream."""
    rng = np.random.default_rng(seed)
    trace = []
    for step in range(1, 121):
        loss = 3.0 - 0.01 * step + float(rng.normal(0, 0.05))
        grad = float(abs(rng.normal(1.0, 0.1)))
        roll = rng.random()
        if roll < 0.04:
            loss = float("nan")
        elif roll < 0.06:
            grad = float("inf")
        elif roll < 0.12:
            loss *= float(rng.uniform(1.5, 4.0))
        elif roll < 0.18:
            grad *= float(rng.uniform(5.0, 40.0))
        trace.append((step, loss, None if roll > 0.95 else grad))
    kw = dict(window=16, min_samples=4)
    j, t = jnh.NumericHealthMonitor(**kw), tnh.NumericHealthMonitor(**kw)
    for step, loss, grad in trace:
        assert [a.encode() for a in t.check(step, loss, grad)] == [
            a.encode() for a in j.check(step, loss, grad)]
    assert [dataclasses.astuple(a) for a in t.anomalies] == [
        dataclasses.astuple(a) for a in j.anomalies]
    assert {a.kind for a in t.anomalies} == {"nan", "loss_spike",
                                             "grad_explosion"}


# -- the SDC digest --------------------------------------------------------------------


def _leaves(seed):
    """The same raw bits as numpy, JAX and torch leaves: fp32, bf16,
    int32, bool and 0-d."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=(7, 33)).astype(np.float32)
    bf16 = rng.integers(0, 1 << 16, size=(129,), dtype=np.uint16)
    i32 = rng.integers(-2 ** 31, 2 ** 31, size=(5, 4), dtype=np.int64
                       ).astype(np.int32)
    flags = rng.random((3, 9)) < 0.5
    scalar = np.float32(rng.normal())
    step = np.int32(rng.integers(0, 10 ** 6))
    jleaves = [jnp.asarray(f32),
               jax.lax.bitcast_convert_type(jnp.asarray(bf16), jnp.bfloat16),
               jnp.asarray(i32), jnp.asarray(flags), jnp.asarray(scalar),
               jnp.asarray(step)]
    tleaves = [torch.from_numpy(f32),
               torch.from_numpy(bf16.view(np.int16)).view(torch.bfloat16),
               torch.from_numpy(i32), torch.from_numpy(flags),
               torch.tensor(scalar), torch.tensor(step)]
    return jleaves, tleaves, int(step)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_digest_matches_the_reference_bit_for_bit(seed, monkeypatch):
    jleaves, tleaves, step = _leaves(seed)
    want = int(jsd._digest_tree(jleaves))
    got = tsd.digest_leaves(tleaves)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    assert tsd.format_digest(got) == jsd.format_digest(want)
    # Leaves longer than a row are summed by rows, in groups.
    monkeypatch.setattr(tsd, "ROW_BYTES", 64)
    monkeypatch.setattr(tsd, "GROUP_ROWS", 3)
    assert int(tsd.digest_leaves(tleaves)) == want
    # A Python int leaf is the reference's int32 step counter.
    assert int(tsd.digest_leaves(tleaves[:-1] + [step])) == want
    # Order matters; one flipped bit anywhere changes the digest.
    assert int(tsd.digest_leaves(tleaves[::-1])) != want
    flipped = [t.clone() for t in tleaves]
    flipped[1].view(torch.int16).view(-1)[77] ^= 1 << 3
    assert int(tsd.digest_leaves(flipped)) != want


@pytest.mark.parametrize("row_bytes,group_rows,direct_rows",
                         [(4, 3, 2), (16, 2, 4), (64, 3, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_digest_sums_long_leaves_in_place_and_packs_the_rest(
        seed, row_bytes, group_rows, direct_rows, monkeypatch):
    """Leaves of whole rows and at least ``DIRECT_ROWS`` rows are summed
    where they lie, the rest packed and padded; either way the digest is
    the reference's."""
    jleaves, tleaves, step = _leaves(seed)
    want = int(jsd._digest_tree(jleaves))
    monkeypatch.setattr(tsd, "ROW_BYTES", row_bytes)
    monkeypatch.setattr(tsd, "GROUP_ROWS", group_rows)
    monkeypatch.setattr(tsd, "DIRECT_ROWS", direct_rows)
    assert int(tsd.digest_leaves(tleaves)) == want
    assert int(tsd.digest_leaves([step] + tleaves[:-1])) == int(
        jsd._digest_tree([jleaves[-1]] + jleaves[:-1]))


def test_digest_of_a_non_contiguous_leaf_and_of_nothing():
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    view = base.t()
    assert int(tsd.digest_leaves([view])) == int(
        jsd._digest_tree([jnp.asarray(view.contiguous().numpy())]))
    assert int(tsd.digest_leaves([])) == int(jsd._digest_tree([])) == 0


@pytest.mark.parametrize("chunk", [16, 100, 4096, 1 << 20])
def test_digest_kernels_chunk_table_covers_each_leaf_once(chunk):
    """The byte-sum kernel's table (``state_digest.chunk_table``): walked
    as the kernel walks it (each row's bytes added to its leaf), it gives
    every leaf's byte sum, the plain version's; rows are at most
    ``chunk`` bytes, consecutive within a leaf, none for an empty leaf."""
    rng = np.random.default_rng(chunk)
    buf = rng.integers(0, 256, size=20000, dtype=np.uint8)
    spans = [(3, 5000), (5003, 0), (5003, 1), (6001, 13000), (19001, 999)]
    base = 1 << 40
    table = tsd.chunk_table([base + a for a, _ in spans],
                            [n for _, n in spans], chunk)
    assert table.dtype == tsd.CHUNK_DTYPE and table.dtype.itemsize == 24
    got = np.zeros(len(spans), np.int64)
    for row in table:
        assert 0 < row["nbytes"] <= chunk
        at = int(row["addr"]) - base
        got[row["leaf"]] += int(buf[at:at + int(row["nbytes"])].sum(
            dtype=np.int64))
    want = [int(buf[a:a + n].sum(dtype=np.int64)) for a, n in spans]
    assert got.tolist() == want
    assert 1 not in table["leaf"]
    leaves = [torch.from_numpy(buf[a:a + n].copy()) for a, n in spans]
    assert tsd.byte_sums(leaves, torch.device("cpu")).tolist() == want
    # The table's rows are the kernel's ``struct Chunk``, field for field.
    import os
    import re

    from dlrover_tpu_torch.ops import kernel_lib

    src = open(os.path.join(kernel_lib.CSRC, "byte_sums.cu")).read()
    body = re.search(r"struct Chunk \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(unsigned long long|long long) (\w+);", body)
    assert fields == [("unsigned long long", "addr"), ("long long", "nbytes"),
                      ("long long", "leaf")]
    assert list(tsd.CHUNK_DTYPE.names) == [n for _, n in fields]


class _JState:
    """What the reference's flipper reads: ``params`` and ``replace``."""

    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _JState(params)


@pytest.mark.parametrize("bit,leaf_index,flat_index", [
    (10, 0, 0), (3, 1, 77), (22, 5, 1000), (10, 11, 12345), (7, 2, 5),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flip_mantissa_bit_flips_the_references_bit(bit, leaf_index,
                                                    flat_index, dtype):
    jcfg = jgpt2_config("124m", **TINY)
    from dlrover_tpu.models.transformer import TransformerLM as JModel
    import flax

    variables = JModel(jcfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))
    jparams = jax.tree.map(
        lambda x: x.astype(jnp.dtype(dtype)),
        flax.linen.meta.unbox(variables["params"]))
    cfg = gpt2_config("124m", **TINY,
                      param_dtype=getattr(torch, dtype))
    train = ttl.build_train(cfg, ttl.make_optimizer("adamw"),
                            global_batch_size=BATCH, seq_len=SEQ,
                            device="cpu")
    # bf16 -> fp32 -> bf16 is exact.
    as_np = (lambda tree: jax.tree.map(
        lambda x: np.asarray(x, np.float32), tree))
    state = train.init(params=state_dict_from_jax(as_np(jparams), cfg))
    before = state.params()
    before = {k: v.clone() for k, v in before.items()}
    jflipped = jsd.flip_mantissa_bit(_JState(jparams), bit=bit,
                                     leaf_index=leaf_index,
                                     flat_index=flat_index)
    assert tsd.flip_mantissa_bit(state, bit=bit, leaf_index=leaf_index,
                                 flat_index=flat_index) is state
    want = state_dict_from_jax(as_np(jflipped.params), cfg)
    got = state.params()
    changed = [k for k in got if not torch.equal(
        got[k].view(-1).view(torch.uint8),
        before[k].view(-1).view(torch.uint8))]
    assert len(changed) == 1
    for k, w in want.items():
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           w.reshape(-1).view(torch.uint8)), k


# -- grad accumulation, the virtual mesh and the cache key ------------------------


GRAD_ACCUM_CASES = [
    (ref_accum, ref_world, world, gbs, dp)
    for ref_accum in (1, 2, 3, 4)
    for ref_world, world in ((1, 1), (2, 1), (4, 1), (4, 2), (2, 4), (3, 2),
                             (8, 3), (0, 2))
    for gbs, dp in ((8, 1), (16, 2), (12, 1), (6, 4), (7, 1))
]


def test_elastic_grad_accum_matches_the_reference():
    for case in GRAD_ACCUM_CASES:
        assert ttl.elastic_grad_accum(*case) == jtl.elastic_grad_accum(
            *case), case


@pytest.mark.parametrize("logical,physical", [(1, 1), (2, 1), (4, 2),
                                              (4, 3), (3, 5)])
def test_virtual_mesh_accounting_matches_the_reference(logical, physical):
    fake_mesh = types.SimpleNamespace(devices=np.zeros((1,)),
                                      axis_names=("data",))
    j = jvm.VirtualMesh(fake_mesh, logical_world=logical,
                        physical_world=physical)
    t = tvm.VirtualMesh((1,), logical_world=logical, physical_world=physical)
    assert t.logical_shape == j.logical_shape
    for ref_accum, gbs, dp in ((1, 8, 1), (2, 16, 2), (3, 12, 1),
                               (4, 16, 1), (1, 6, 2)):
        assert t.grad_accum_for(ref_accum, gbs, dp) == \
            j.grad_accum_for(ref_accum, gbs, dp)
    with pytest.raises(ValueError):
        tvm.VirtualMesh((1,), logical_world=0, physical_world=1)


# -- the ported example ---------------------------------------------------------------


def test_example_main_runs_on_the_cpu(tmp_path, monkeypatch):
    from dlrover_tpu_torch.common import telemetry
    from dlrover_tpu_torch.examples import train_lm

    monkeypatch.delenv("DLROVER_TPU_MASTER_ADDR", raising=False)
    monkeypatch.delenv("DLROVER_TPU_RESTART_COUNT", raising=False)
    timeline = tmp_path / "tl.json"
    argv = ["--device", "cpu", "--steps", "3", "--ckpt-every", "2",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--layers", "1",
            "--d-model", "32", "--heads", "2", "--vocab", "64",
            "--seq-len", "16", "--batch-size", "4", "--metrics-lag", "2",
            "--prefetch", "1", "--sdc-check-every", "1",
            "--timeline", str(timeline)]
    telemetry.recorder().drain()
    assert train_lm.main(argv) == 0
    import json

    names = {e["name"] for e in json.loads(timeline.read_text())[
        "traceEvents"] if "name" in e}
    assert {"step", "checkpoint"} <= names
    from dlrover_tpu_torch.common.storage import (
        CheckpointDirLayout,
        PosixDiskStorage,
    )

    assert CheckpointDirLayout(str(tmp_path / "ckpt")).latest_step(
        PosixDiskStorage()) == 3


@pytest.mark.parametrize("flags", [
    ["--zero1"], ["--live-relayout"], ["--ref-world", "2"],
    ["--reduce-quant", "int8"], ["--optimizer", "sgd"],
    ["--zero1", "--overlap", "--overlap-bucket-mb", "0.01",
     "--allgather-quant", "int8", "--grad-accum", "2"],
    ["--attention-impl", "ring"],
])
def test_example_takes_the_data_parallel_flags(flags, monkeypatch):
    """At one process the flags build and train (ZeRO-1 and the overlap
    engine deactivate, as the reference's do at one data rank)."""
    from dlrover_tpu_torch.examples import train_lm

    monkeypatch.delenv("DLROVER_TPU_MASTER_ADDR", raising=False)
    assert train_lm.main(["--device", "cpu", "--steps", "1", "--layers",
                          "1", "--d-model", "32", "--heads", "2", "--vocab",
                          "64", "--seq-len", "16", "--batch-size", "4"]
                         + flags) == 0


def test_example_captures_device_time(monkeypatch):
    """``--profile-every`` runs the trainer's capture windows."""
    from dlrover_tpu_torch.examples import train_lm

    monkeypatch.delenv("DLROVER_TPU_MASTER_ADDR", raising=False)
    pipeline_counters().reset()
    assert train_lm.main(["--device", "cpu", "--steps", "2", "--layers",
                          "1", "--d-model", "32", "--heads", "2", "--vocab",
                          "64", "--seq-len", "16", "--batch-size", "4",
                          "--profile-every", "2"]) == 0
    assert [e.steps for e in pipeline_counters().blocks("profile-sync")] \
        == [(2,)]


@pytest.mark.parametrize("flags,item", [
    (["--auto-tune"], 10), (["--warmup-compile"], 3),
    (["--compile-cache-dir", "cache"], 3),
])
def test_example_refuses_unported_flags(flags, item):
    from dlrover_tpu_torch.examples import train_lm

    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        train_lm.main(["--device", "cpu", "--steps", "1"] + flags)

"""Port parity: the optimizers of the training options (``optax_ports.lion``,
``optimizers/{agd,mup,wsam}.py``, ``train_lib.make_optimizer("lion" |
"agd")``) against optax and the reference (``dlrover_tpu/optimizers``,
``dlrover_tpu/trainer/train_lib.py``).

* Transformations on a tree: the same gradients through both for 3
  updates, fp32; parameters within ``RTOL`` of each leaf's scale (the
  same float32 formulas; the step's scalars are computed on the host
  here and by XLA there, which may differ in the last bit).
* ``build_train`` against ``build_sharded_train`` at world 1 for 3 steps,
  the tolerances of ``tests/test_torch_train.py``.  Lion's update is a
  sign: where the interpolation it takes the sign of lies within
  reassociation noise of 0, the two packages may step a value opposite
  ways, ``2 lr`` apart, so a few values (``LION_FLIP_SHARE``) may differ
  by up to ``2 lr`` a step.
* µP: every leaf's class (matrix-like or not) on the layer-stacked tree
  equals the reference's on its scan-stacked tree, and
  ``adamw -> mup_scale`` updates equal the reference's.
* WSAM: both branches (``decouple`` and the mixed gradient), with and
  without ``adaptive``, 3 steps against the reference.
* Flash Checkpoint: a Lion and an AGD state saved and restored bit for
  bit.
"""

import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.parallel import rules as jrules
from dlrover_tpu.runtime.mesh import ParallelConfig, build_mesh
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.checkpoint import shm_handler as tsh
from dlrover_tpu_torch.models import gpt2_config
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.optimizers import agd as tagd
from dlrover_tpu_torch.optimizers import mup as tmup
from dlrover_tpu_torch.optimizers import optax_ports as ox
from dlrover_tpu_torch.optimizers import wsam as twsam
from dlrover_tpu_torch.trainer import train_lib as ttl

# The modules (the reference package's __init__ exports its functions
# under the same names).
jagd = importlib.import_module("dlrover_tpu.optimizers.agd")
jmup = importlib.import_module("dlrover_tpu.optimizers.mup")
jwsam = importlib.import_module("dlrover_tpu.optimizers.wsam")

RTOL = 1e-6
SHAPES = {"blocks.attn.qkv.kernel": (2, 16, 2, 24), "blocks.mlp.wo.bias":
          (2, 16), "embed.embedding": (32, 16), "ln_final.scale": (16,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(jtx, ttx, params, grads_seq):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for grads in grads_seq:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v.copy())
                             for k, v in grads.items()}, ts, tp)
        tp = ox.apply_updates(tp, tu)
    return {k: np.asarray(v) for k, v in jp.items()}, \
        {k: v.numpy() for k, v in tp.items()}


def _assert_close(got, want, rtol=RTOL):
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=rtol * scale, err_msg=k)


def _grads(n=3, scale=1e-2):
    return [_tree(100 + i, scale) for i in range(n)]


@pytest.mark.parametrize("schedule", [False, True], ids=["const", "sched"])
def test_lion_matches_optax(schedule):
    lr = optax.linear_schedule(0.0, 1e-2, 3) if schedule else 1e-2
    tlr = ox.linear_schedule(0.0, 1e-2, 3) if schedule else 1e-2
    want, got = _run_both(optax.lion(lr, weight_decay=0.1),
                          ox.lion(tlr, weight_decay=0.1), _tree(0), _grads())
    _assert_close(got, want)


@pytest.mark.parametrize("kw", [
    {}, dict(amsgrad=True), dict(clip=0.5, weight_decay=0.1),
    dict(b2=0.95, delta=1e-3)], ids=["default", "amsgrad", "clip", "delta"])
@pytest.mark.parametrize("schedule", [False, True], ids=["const", "sched"])
def test_agd_matches_the_reference(kw, schedule):
    lr = optax.linear_schedule(0.0, 1e-2, 3) if schedule else 1e-2
    tlr = ox.linear_schedule(0.0, 1e-2, 3) if schedule else 1e-2
    want, got = _run_both(jagd.agd(lr, **kw), tagd.agd(tlr, **kw),
                          _tree(0), _grads())
    _assert_close(got, want)


def test_agd_state_is_the_references():
    tx = tagd.agd(1e-3, amsgrad=True)
    params = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    state = tx.init(params)
    assert isinstance(state, tagd.AGDState) and state.count == 0
    _, state = tx.update({k: torch.ones_like(v) for k, v in params.items()},
                         state, params)
    assert state.count == 1 and state.max_exp_avg_sq is not None
    assert tagd.agd(1e-3).init(params).max_exp_avg_sq is None
    with pytest.raises(ValueError, match="requires params"):
        tx.update(params, state, None)


# -- build_train against build_sharded_train at world 1 ---------------------------

TINY = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
            max_seq_len=64)
BATCH, SEQ = 8, 32
METRIC_RTOL = 2e-6
PARAM_ATOL = 3e-5
LION_FLIP_SHARE = 1e-3


def _batch(i=0):
    tok = np.random.default_rng(i).integers(
        0, TINY["vocab_size"], size=(BATCH, SEQ + 1), dtype=np.int32)
    return {"inputs": tok[:, :-1], "targets": tok[:, 1:]}


def _jax_run(opt, lr):
    cfg = jgpt2_config("124m", **TINY, dtype=jnp.float32)
    train = jtl.build_sharded_train(
        JModel(cfg), jtl.make_optimizer(opt, learning_rate=lr),
        build_mesh(ParallelConfig(), devices=jax.devices()[:1]),
        jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ)
    state = train.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state.params)
    metrics = []
    for i in range(3):
        state, m = train.step(state, jtl.shard_batch(_batch(i), train))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return init, metrics, jax.tree.map(np.asarray, state.params)


def _port_train(opt, lr, init=None, steps=3, seed=0):
    cfg = gpt2_config("124m", **TINY, dtype=torch.float32)
    train = ttl.build_train(cfg, ttl.make_optimizer(opt, learning_rate=lr),
                            global_batch_size=BATCH, seq_len=SEQ,
                            device="cpu")
    state = train.init(seed=seed, params=(
        state_dict_from_jax(init, cfg) if init is not None else None))
    metrics = []
    for i in range(steps):
        state, m = train.step(state, _batch(i))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return cfg, train, state, metrics


@pytest.mark.parametrize("opt,lr", [("lion", 1e-3), ("agd", 1e-3)])
def test_train_steps_match_jax_build_sharded_train(opt, lr):
    init, jmetrics, jparams = _jax_run(opt, lr)
    cfg, _, state, tmetrics = _port_train(opt, lr, init)
    np.testing.assert_allclose(tmetrics, jmetrics, rtol=METRIC_RTOL)
    want = state_dict_from_jax(jparams, cfg)
    got = state.params()
    hd = cfg.resolved_head_dim
    off = total = 0
    for name, w in want.items():
        g = got[name]
        if name.endswith("attn.qkv.bias"):  # see tests/test_torch_train.py
            keep = torch.ones(w.shape, dtype=torch.bool)
            keep[..., hd:2 * hd] = False
            g, w = g[keep], w[keep]
        err = (g - w).abs()
        if opt == "lion":
            assert err.max() <= 2 * lr * 3 + PARAM_ATOL, name
            off += int((err > PARAM_ATOL).sum())
            total += err.numel()
        else:
            assert err.max() <= PARAM_ATOL, (name, err.max())
    assert off <= LION_FLIP_SHARE * max(total, 1), (off, total)


# -- µP ---------------------------------------------------------------------------


def _jax_params(cfg):
    tokens = jnp.zeros((1, 8), jnp.int32)
    return jax.tree.map(np.asarray, JModel(cfg).init(
        jax.random.PRNGKey(0), tokens)["params"])


def _jax_paths(tree):
    from flax.core import meta

    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(meta.unbox(tree)):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[name] = leaf
    return out


@pytest.mark.parametrize("overrides", [{}, dict(tie_embeddings=False),
                                       dict(num_experts=4)],
                         ids=["gpt2", "untied", "moe"])
def test_mup_classes_equal_the_references(overrides):
    jcfg = jgpt2_config("124m", **TINY, dtype=jnp.float32, **overrides)
    tcfg = gpt2_config("124m", **TINY, dtype=torch.float32, **overrides)
    jtree = _jax_paths(_jax_params(jcfg))
    stacked = ox.stack_layers(state_dict_from_jax(
        jax.tree.map(np.asarray, __import__("flax").core.meta.unbox(
            _jax_params(jcfg))), tcfg))
    assert len(jtree) == len(stacked)
    for jname, leaf in jtree.items():
        tname = jname.replace("/", ".")
        assert tname in stacked, jname
        assert stacked[tname].dim() == leaf.ndim
        assert tmup.is_matrix_like(tname, stacked[tname].dim()) == \
            jmup.is_matrix_like(jname, leaf.ndim), jname


def test_mup_scale_updates_and_config_match_the_reference():
    width = 4.0
    want, got = _run_both(optax.chain(optax.adamw(1e-2), jmup.mup_scale(width)),
                          ox.chain(ox.adamw(1e-2), tmup.mup_scale(width)),
                          _tree(0), _grads())
    _assert_close(got, want)
    jcfg = jmup.mup_config(jgpt2_config("124m", **TINY), 16)
    tcfg = tmup.mup_config(gpt2_config("124m", **TINY), 16)
    assert jcfg.logit_scale == tcfg.logit_scale == 0.25


# -- WSAM ---------------------------------------------------------------------------


def _wsam_data():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 2)).astype(np.float32)
    params = {"w1": (rng.standard_normal((8, 12)) * 0.3).astype(np.float32),
              "b1": np.zeros((12,), np.float32),
              "w2": (rng.standard_normal((12, 2)) * 0.3).astype(np.float32)}
    return x, y, params


def _jloss(p, x, y):
    return jnp.mean((jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] - y) ** 2)


def _tloss(p, x, y):
    return ((torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] - y) ** 2).mean()


@pytest.mark.parametrize("decouple", [True, False], ids=["decouple", "mixed"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "adaptive"])
def test_wsam_matches_the_reference(decouple, adaptive):
    x, y, params = _wsam_data()
    jcfg = jwsam.WSAMConfig(rho=0.05, gamma=0.8, adaptive=adaptive,
                            decouple=decouple, learning_rate=1e-2)
    tcfg = twsam.WSAMConfig(rho=0.05, gamma=0.8, adaptive=adaptive,
                            decouple=decouple, learning_rate=1e-2)
    jtx, ttx = optax.adamw(1e-2), ox.adamw(1e-2)
    jstep = jax.jit(jwsam.make_wsam_step(_jloss, jtx, jcfg))
    tstep = twsam.make_wsam_step(_tloss, ttx, tcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    tx_, ty_ = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(x), jnp.asarray(y))
        tp, ts, tl = tstep(tp, ts, tx_, ty_)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    _assert_close({k: v.numpy() for k, v in tp.items()},
                  {k: np.asarray(v) for k, v in jp.items()}, rtol=2e-6)
    assert not any(v.requires_grad for v in tp.values())


# -- Flash Checkpoint ---------------------------------------------------------------


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    job = f"topt{os.getpid()}_{tmp_path.name}"
    monkeypatch.setenv("DLROVER_TPU_JOB", job)
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    yield tmp_path
    for path in glob.glob(f"/dev/shm/dlrover_tpu_ckpt_{job}_*"):
        os.unlink(path)


@pytest.mark.parametrize("opt", ["lion", "agd"])
def test_optimizer_state_round_trips_through_flash_checkpoint(opt, isolated):
    _, train, state, _ = _port_train(opt, 1e-3, steps=2)
    tree = state.checkpoint_tree()
    ckpt = Checkpointer(str(isolated / "ckpt"), host_index=0, num_hosts=1,
                        local_saver=True, device="cpu")
    try:
        assert ckpt.save_checkpoint(2, tree, StorageType.MEMORY)
        template = train.init(seed=5).checkpoint_tree()
        step, loaded = ckpt.load_checkpoint(state_template=template)
    finally:
        ckpt.close()
    assert step == 2
    want = tsh.tree_flatten_with_path(tree)
    got = tsh.tree_flatten_with_path(loaded)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), path
        else:
            assert g == w, path
    # The restored state steps on exactly as the saved one does.
    a = train.restore(2, loaded)
    b = train.restore(2, tree)
    _, ma = train.step(a, _batch(5))
    _, mb = train.step(b, _batch(5))
    assert ma["loss"].item() == mb["loss"].item()
    assert all(torch.equal(x, y) for x, y in zip(
        a.params().values(), b.params().values()))

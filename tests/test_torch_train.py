"""Port parity: the training slice (``dlrover_tpu_torch.optimizers`` and
``dlrover_tpu_torch.trainer.train_lib``) against optax and the JAX
``build_sharded_train``.

Same numpy inputs through both packages, fp32.  The optimizer ports hold
to optax at 1e-6 relative over 3 updates; the train step holds to the JAX
step on the default 8-device CPU mesh (data parallel, so its sums are
taken in another order) at the tolerances stated by each test.
"""

import dataclasses

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
from dlrover_tpu_torch.models import gpt2_config
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.optimizers import optax_ports as ox
from dlrover_tpu_torch.trainer import train_lib as ttl

RTOL = 1e-6


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _run_both(jtx, ttx, params, grads_seq):
    """Apply ``grads_seq`` through an optax transformation and its port
    from the same ``params``; returns both final param trees."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for grads in grads_seq:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.as_tensor(v) for k, v in grads.items()},
                            ts, tp)
        tp = ox.apply_updates(tp, tu)
    return _np_tree(jp), {k: v.numpy() for k, v in tp.items()}


def _assert_trees_close(got, want, rtol=RTOL):
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=rtol * scale, err_msg=k)


# Leaves: factored 2-D, 1-D, a 3-D qkv-shaped kernel [d, H, 3*hd] (ties in
# the two largest dims), an unfactorable small 2-D, and a stacked
# [layers, ...] block leaf whose layer axis is one of its two largest.
LEAF_SHAPES = {
    "dense": (256, 192),
    "bias": (300,),
    "qkv": (192, 4, 192),
    "small": (64, 32),
    "blocks.w": (160, 3, 130),
}


def _leaves(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in LEAF_SHAPES.items()}


def test_adafactor_matches_optax(rng):
    params = _leaves(rng)
    grads = [_leaves(rng, 0.1) for _ in range(3)]
    want, got = _run_both(optax.adafactor(1e-2), ox.adafactor(1e-2),
                          params, grads)
    _assert_trees_close(got, want)


def test_adafactor_on_layer_stacked_tree_matches_optax(rng):
    """The port's per-layer tensors, stacked as the JAX scan stacks them,
    give optax's update on the stacked leaf; treating each layer as its
    own leaf (per-layer RMS) is a different optimizer."""
    layers, shape = 3, (192, 144)
    params = {"blocks.k": rng.normal(size=(layers, *shape)).astype(
        np.float32)}
    # Layers of very different scale, so block RMS over the stack differs
    # from any single layer's.
    params["blocks.k"] *= np.array([0.1, 1.0, 10.0], np.float32)[:, None,
                                                                  None]
    grads = [{"blocks.k": rng.normal(size=(layers, *shape)).astype(
        np.float32)} for _ in range(3)]
    want, _ = _run_both(optax.adafactor(1e-2), ox.adafactor(1e-2), params,
                        grads)

    per_layer = {f"blocks.{i}.k": torch.as_tensor(params["blocks.k"][i])
                 for i in range(layers)}
    tx = ox.adafactor(1e-2)
    state = tx.init(ox.stack_layers(per_layer))
    for g in grads:
        per_layer_g = {f"blocks.{i}.k": torch.as_tensor(g["blocks.k"][i])
                       for i in range(layers)}
        updates, state = tx.update(ox.stack_layers(per_layer_g), state,
                                   ox.stack_layers(per_layer))
        for name, u in ox.unstack_layers(updates).items():
            per_layer[name] = per_layer[name] + u
    got = np.stack([per_layer[f"blocks.{i}.k"].numpy()
                    for i in range(layers)])
    _assert_trees_close({"blocks.k": got}, want)

    # The trap: optax over per-layer leaves moves the parameters elsewhere.
    split = {f"l{i}": params["blocks.k"][i] for i in range(layers)}
    split_grads = [{f"l{i}": g["blocks.k"][i] for i in range(layers)}
                   for g in grads]
    per_leaf, _ = _run_both(optax.adafactor(1e-2), ox.adafactor(1e-2),
                            split, split_grads)
    moved = np.stack([per_leaf[f"l{i}"] for i in range(layers)])
    assert np.abs(moved - want["blocks.k"]).max() > 1e-3


def test_adamw_matches_optax(rng):
    params = _leaves(rng)
    grads = [_leaves(rng, 0.1) for _ in range(3)]
    want, got = _run_both(
        optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.1),
        ox.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.1), params, grads)
    _assert_trees_close(got, want)


@pytest.mark.parametrize("scale", [0.001, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(rng, scale):
    grads = _leaves(rng, scale)
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    got, _ = ox.clip_by_global_norm(1.0).update(
        {k: torch.as_tensor(v) for k, v in grads.items()}, ())
    _assert_trees_close({k: v.numpy() for k, v in got.items()},
                        _np_tree(want))
    if scale < 1.0:  # below the limit: untouched, bit for bit
        for k in grads:
            assert np.array_equal(got[k].numpy(), grads[k])


@pytest.mark.parametrize("warmup,decay", [(0, 0), (10, 0), (10, 100)])
def test_make_schedule_matches_jax(warmup, decay):
    want = jtl.make_schedule(3e-4, warmup, decay)
    got = ttl.make_schedule(3e-4, warmup, decay)
    for step in (0, 1, 5, 10, 11, 50, 100, 150):
        w = want(step) if callable(want) else want
        g = got(step) if callable(got) else got
        np.testing.assert_allclose(g, float(w), rtol=RTOL, atol=1e-12)


def test_make_optimizer_refuses_unported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ttl.make_optimizer("q8_adam")
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttl.make_optimizer("nope")


def _ce_inputs(rng, b=2, s=12, d=16, v=40):
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    head = rng.normal(size=(v, d)).astype(np.float32)
    targets = rng.integers(0, v, size=(b, s))
    weights = (rng.random(size=(b, s)) > 0.3).astype(np.float32)
    return hidden, head, targets, weights


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_losses_match_jax(rng, z_loss):
    hidden, head, targets, weights = _ce_inputs(rng)
    logits = hidden @ head.T
    jl, jw = jtl.cross_entropy_loss(jnp.asarray(logits),
                                    jnp.asarray(targets),
                                    jnp.asarray(weights), z_loss=z_loss)
    tl_, tw = ttl.cross_entropy_loss(torch.as_tensor(logits),
                                     torch.as_tensor(targets),
                                     torch.as_tensor(weights), z_loss=z_loss)
    np.testing.assert_allclose(tl_.item(), float(jl), rtol=1e-6)
    assert tw.item() == float(jw)

    jc, _ = jtl.chunked_cross_entropy_loss(
        jnp.asarray(hidden), jnp.asarray(head), jnp.asarray(targets),
        jnp.asarray(weights), num_chunks=3, z_loss=z_loss)
    h = torch.as_tensor(hidden).requires_grad_()
    tc, _ = ttl.chunked_cross_entropy_loss(
        h, torch.as_tensor(head), torch.as_tensor(targets),
        torch.as_tensor(weights), num_chunks=3, z_loss=z_loss)
    np.testing.assert_allclose(tc.item(), float(jc), rtol=1e-6)
    # The checkpointed chunks give the gradient of the plain loss.
    tc.backward()
    h2 = torch.as_tensor(hidden).requires_grad_()
    full, _ = ttl.cross_entropy_loss(h2 @ torch.as_tensor(head).t(),
                                     torch.as_tensor(targets),
                                     torch.as_tensor(weights), z_loss=z_loss)
    full.backward()
    torch.testing.assert_close(h.grad, h2.grad, rtol=1e-5, atol=1e-7)


# -- the train step against JAX's build_sharded_train -----------------------------

TINY = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
            max_seq_len=64)
BATCH, SEQ = 8, 32
# Loss and grad norm: fp32, the JAX side 8-way data parallel.
METRIC_RTOL = 2e-6
# Parameters after 3 steps: Adam and Adafactor divide by a running RMS of
# the gradient, which turns fp32 reassociation differences of ~1e-7 into
# relative update differences of about the same size; atol 3e-5 absolute
# on parameters of scale 0.1-1.  Excluded: the key slice of the fused qkv
# bias, whose gradient is exactly zero in exact arithmetic (a shift of
# every key leaves the softmax unchanged), so both frameworks update it
# from rounding noise that the optimizers' normalisation amplifies.
PARAM_ATOL = 3e-5


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY["vocab_size"], size=(BATCH, SEQ + 1),
                          dtype=np.int32)
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


def _jax_run(opt_name, impl, remat, lr):
    cfg = jgpt2_config("124m", **TINY, dtype=jnp.float32,
                       attention_impl=impl, remat=remat)
    train = jtl.build_sharded_train(
        JModel(cfg), jtl.make_optimizer(opt_name, learning_rate=lr),
        build_mesh(ParallelConfig()), jrules.DEFAULT_RULES,
        global_batch_size=BATCH, seq_len=SEQ,
    )
    state = train.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state.params)
    batch = jtl.shard_batch(_batch(), train)
    metrics = []
    for _ in range(3):
        state, m = train.step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    metrics.append((float(train.eval_step(state, batch)["loss"]), 0.0))
    return init, metrics, jax.tree.map(np.asarray, state.params)


def _port_run(opt_name, init, impl, remat, lr, **build):
    cfg = gpt2_config("124m", **TINY, dtype=torch.float32,
                      attention_impl=impl, remat=remat)
    train = ttl.build_train(
        cfg, ttl.make_optimizer(opt_name, learning_rate=lr),
        global_batch_size=BATCH, seq_len=SEQ, device="cpu", **build,
    )
    state = train.init(params=state_dict_from_jax(init, cfg))
    metrics = []
    for _ in range(3):
        state, m = train.step(state, _batch())
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    assert m["step"] == 3 and m["tokens"].item() == BATCH * SEQ
    assert m["aux_loss"].item() == 0.0
    metrics.append((train.eval_step(state, _batch())["loss"].item(), 0.0))
    return cfg, metrics, state.params()


@pytest.mark.parametrize(
    "opt_name,impl,remat,lr",
    [("adafactor", "xla", "none", 1e-2),
     ("adamw", "xla", "none", 1e-3),
     ("adafactor", "flash", "flash_only", 1e-2)],
)
def test_train_steps_match_jax_build_sharded_train(opt_name, impl, remat,
                                                   lr):
    init, jmetrics, jparams = _jax_run(opt_name, impl, remat, lr)
    cfg, tmetrics, tparams = _port_run(opt_name, init, impl, remat, lr)
    # Per step (loss, grad_norm), then eval_step's loss after step 3.
    np.testing.assert_allclose(tmetrics, jmetrics, rtol=METRIC_RTOL)
    want = state_dict_from_jax(jparams, cfg)
    hd = cfg.resolved_head_dim
    for name, w in want.items():
        got = tparams[name]
        if name.endswith("attn.qkv.bias"):
            keep = torch.ones(w.shape, dtype=torch.bool)
            keep[..., hd:2 * hd] = False
            got, w = got[keep], w[keep]
        torch.testing.assert_close(got, w, rtol=0, atol=PARAM_ATOL,
                                   msg=name)


def _grads(remat, impl="flash", grad_accum=1, dtype=torch.float32,
           ce_chunks=0):
    cfg = gpt2_config("124m", **TINY, dtype=dtype, param_dtype=dtype,
                      attention_impl=impl, remat=remat)
    train = ttl.build_train(cfg, ttl.make_optimizer("adamw"),
                            global_batch_size=BATCH, seq_len=SEQ,
                            device="cpu", grad_accum=grad_accum,
                            ce_chunks=ce_chunks)
    state = train.init(seed=0)
    captured = {}
    update = train.optimizer.update

    def spy(grads, opt_state, params):
        captured.update({k: v.clone() for k, v in grads.items()})
        return update(grads, opt_state, params)

    train.optimizer = train.optimizer._replace(update=spy)
    _, metrics = train.step(state, _batch())
    return captured, metrics


def test_remat_policies_give_equal_gradients():
    base, _ = _grads("none")
    for remat in ("full", "flash_only"):
        other, _ = _grads(remat)
        for k in base:
            torch.testing.assert_close(other[k], base[k], rtol=1e-6,
                                       atol=1e-7, msg=f"{remat}: {k}")


def test_grad_accum_matches_one_batch():
    one, m1 = _grads("none", impl="xla")
    two, m2 = _grads("none", impl="xla", grad_accum=2)
    assert abs(m1["loss"].item() - m2["loss"].item()) < 1e-6
    for k in one:
        torch.testing.assert_close(two[k], one[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_chunked_ce_step_matches_full_logits():
    full, m1 = _grads("none", impl="xla")
    chunked, m2 = _grads("none", impl="xla", ce_chunks=4)
    assert abs(m1["loss"].item() - m2["loss"].item()) < 1e-6
    for k in full:
        torch.testing.assert_close(chunked[k], full[k], rtol=1e-5,
                                   atol=1e-6, msg=k)


def test_bf16_params_step_is_finite():
    _, metrics = _grads("flash_only", dtype=torch.bfloat16)
    assert np.isfinite(metrics["loss"].item())
    assert np.isfinite(metrics["grad_norm"].item())


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2),
                                             ("flash_only", 1)])
def test_flash_forward_runs_once_per_layer_under_flash_only(
        monkeypatch, remat, per_layer):
    """The plain forward (what a CPU tensor takes instead of the kernel)
    runs L times per step under flash_only and none, 2L under full."""
    calls = []
    plain = tfa.mha_reference
    monkeypatch.setattr(tfa, "mha_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    _grads(remat)
    assert len(calls) == per_layer * TINY["num_layers"]


def test_build_train_refuses_later_slices():
    cfg = gpt2_config("124m", **TINY)
    opt = ttl.make_optimizer()
    for kw in (dict(zero1=True), dict(overlap=True),
               dict(reduce_quant="int8"), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="later slice"):
            ttl.build_train(cfg, opt, global_batch_size=8, seq_len=32,
                            device="cpu", **kw)
    with pytest.raises(ValueError, match="divisible"):
        ttl.build_train(cfg, opt, global_batch_size=8, seq_len=32,
                        device="cpu", grad_accum=3)
    with pytest.raises(ValueError, match="decode"):
        ttl.build_train(dataclasses.replace(cfg, decode=True), opt,
                        global_batch_size=8, seq_len=32, device="cpu")

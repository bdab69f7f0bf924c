"""Port parity: the data-parallel step (``train_lib.build_train`` on a
``data`` mesh of 2 and 4 spawned gloo processes) against the JAX
``build_sharded_train`` on a ``data`` 2 (or 4) mesh of the 8-device CPU
mesh, from one JAX init, fp32, 3 steps on batches 0..2 (each rank takes
its own rows).

Cases, for sgd, AdamW, Adafactor (each behind the global-norm clip) and
q8_adam: replicated, ZeRO-1, ZeRO-1 with two microbatches, the overlap
engine (ZeRO-1, two microbatches, small buckets), and the int8 wires
(int8 reduce-scatter and all-gather under the overlap engine).

Tolerances, and why:
* fp (``METRIC_RTOL``, ``PARAM_ATOL``): the sums are taken in another
  order (each rank's partial gradient, then the wire's sum; JAX sums in
  one program), so losses and grad norms agree to fp32 reassociation and
  parameters to ``tests/test_torch_train.py``'s 3e-5, the key slice of
  the fused qkv bias left out for the reason given there.  The ZeRO-1
  step equals the replicated step to the same limits.
* q8_adam: a moment an ulp from a code boundary may take the next code
  (``tests/test_torch_train.py``'s low-bit limits).
* int8 (by design, ROADMAP Queue 3): the port quantizes each rank's
  partial gradient on the wire, the reference the summed one; and the
  int8 all-gather rounds every updated parameter to its block's step.
  Held against the reference's int8 step and against the port's
  replicated fp step: each leaf within ``2 U + steps * max|p| / 127`` (U
  the other run's largest total update of the leaf: an update may be
  rounded away or, where the gradient is at the rounding's level,
  flipped; then the all-gather's own rounding), and the loss within
  ``INT8_LOSS_RTOL``.  That bound passes a step that drops its update,
  so step 1 is also held against the replicated step's step-1
  parameters put through the all-gather's block rounding: of the values
  of split leaves drawn at init, those in another quantization bin than
  the rounded reference's must be at most ``INT8_STEP1_SHARE`` of those
  a dropped update puts in another bin.  A run at learning rate 0 (a planted step that applies
  no update, through the same path) must fail it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.parallel import rules as jrules
from dlrover_tpu.runtime.mesh import ParallelConfig, build_mesh
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models import gpt2_config
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax

TINY, BATCH, SEQ = torch_worlds.TINY, torch_worlds.BATCH, torch_worlds.SEQ
STEPS = 3
METRIC_RTOL = 2e-6
PARAM_ATOL = 3e-5
LOW_BIT_METRIC_RTOL, LOW_BIT_PARAM_ATOL, LOW_BIT_PARAM_SHARE = 2e-5, 3e-4, \
    1e-3
INT8_LOSS_RTOL = 1e-2
INT8_STEP1_SHARE = 0.25

OPTIMIZERS = {"sgd": 1e-2, "adamw": 1e-3, "adafactor": 1e-2,
              "q8_adam": 1e-3}
MODES = {
    "replicated": {},
    "zero1": dict(zero1=True),
    "zero1_accum2": dict(zero1=True, grad_accum=2),
    "overlap": dict(zero1=True, overlap=True, grad_accum=2,
                    overlap_bucket_mb=0.02),
    "int8": dict(zero1=True, overlap=True, reduce_quant="int8",
                 allgather_quant="int8", overlap_bucket_mb=0.02),
}
WORLDS = (2, 4)
# The JAX side's runs (each a compile): every optimizer replicated at
# data 2; every flag for Adafactor (the optimizer whose reductions over a
# leaf ZeRO-1 must keep global) at data 2, and the overlap case at 4.
JAX_RUNS = ([(opt, "replicated", 2) for opt in OPTIMIZERS]
            + [("adafactor", m, 2) for m in MODES if m != "replicated"]
            + [("adafactor", "overlap", 4)])


def _init():
    cfg = jgpt2_config("124m", **TINY, dtype=jnp.float32)
    train = jtl.build_sharded_train(
        JModel(cfg), jtl.make_optimizer("sgd"),
        build_mesh(ParallelConfig(), devices=jax.devices()[:1]),
        jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ)
    params = jax.tree.map(np.asarray, train.init(
        jax.random.PRNGKey(0)).params)
    tcfg = gpt2_config("124m", **TINY, dtype=torch.float32)
    return params, {k: v.numpy() for k, v in state_dict_from_jax(
        params, tcfg).items()}


@pytest.fixture(scope="module")
def init():
    return _init()


@pytest.fixture(scope="module")
def port_runs(init, tmp_path_factory):
    _, state_dict = init
    cases = [(f"{opt}/{mode}", opt, lr, kw)
             for opt, lr in OPTIMIZERS.items() for mode, kw in MODES.items()]
    # One step of the int8 wires, of the replicated step, and of the int8
    # wires at learning rate 0 (the planted step that drops its update).
    cases += [(f"{opt}/{mode}@1", opt, rate, MODES[base], 1)
              for opt, lr in OPTIMIZERS.items()
              for mode, base, rate in (("int8", "int8", lr),
                                       ("replicated", "replicated", lr),
                                       ("int8_lr0", "int8", 0.0))]
    out = {}
    for n in WORLDS:
        out[n] = torch_worlds.run_world(
            n, torch_worlds.run_train_cases,
            {"init": state_dict, "cases": cases},
            tmp_path_factory.mktemp(f"zero1_{n}"))
    return out


def _jax_run(init_params, opt, mode, n):
    kw = {k: v for k, v in MODES[mode].items()}
    cfg = jgpt2_config("124m", **TINY, dtype=jnp.float32)
    train = jtl.build_sharded_train(
        JModel(cfg), jtl.make_optimizer(opt, learning_rate=OPTIMIZERS[opt]),
        build_mesh(ParallelConfig(data=n), devices=jax.devices()[:n]),
        jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ, **kw)
    state = train.init(jax.random.PRNGKey(0))
    # The one init the port starts from (the optimizers' states start at
    # constants, whatever the parameters).
    state = state.replace(params=jax.device_put(
        init_params, train.state_shardings.params))
    metrics = []
    for i in range(STEPS):
        state, m = train.step(state, jtl.shard_batch(
            torch_worlds.lm_batch(i), train))
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["tokens"])))
    tcfg = gpt2_config("124m", **TINY, dtype=torch.float32)
    params = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, state.params), tcfg).items()}
    return metrics, params


def _masked(name, a):
    if name.endswith("attn.qkv.bias"):
        hd = TINY["d_model"] // TINY["num_heads"]
        keep = np.ones(a.shape, bool)
        keep[..., hd:2 * hd] = False
        return a[keep]
    return a


def _assert_close(got, want, opt):
    gm, gp = got
    wm, wp = want
    low_bit = opt == "q8_adam"
    rtol = LOW_BIT_METRIC_RTOL if low_bit else METRIC_RTOL
    np.testing.assert_allclose(np.asarray(gm), np.asarray(wm), rtol=rtol)
    for name, w in wp.items():
        diff = np.abs(_masked(name, gp[name]) - _masked(name, w))
        if low_bit:
            assert diff.max() <= 10 * LOW_BIT_PARAM_ATOL, name
            assert (diff > LOW_BIT_PARAM_ATOL).mean() <= \
                LOW_BIT_PARAM_SHARE, name
        else:
            assert diff.max() <= PARAM_ATOL, (name, diff.max())


@pytest.mark.parametrize("opt,mode,n", JAX_RUNS)
def test_step_matches_jax_build_sharded_train(init, port_runs, opt, mode,
                                              n):
    jparams, _ = init
    want = _jax_run(jparams, opt, mode, n)
    metrics, params, flags, _ = port_runs[n][0][f"{opt}/{mode}"]
    assert flags["dp"] == n
    assert flags["zero1"] == (mode != "replicated")
    assert flags["overlap"] == (mode in ("overlap", "int8"))
    if mode == "int8":
        fp_metrics, fp_params = want
        _assert_int8_bound((metrics, params), (fp_metrics, fp_params),
                           opt, init[1])
        return
    _assert_close((metrics, params), want, opt)


def _assert_int8_bound(got, fp, opt, init_params):
    gm, gp = got
    fm, fp_params = fp
    np.testing.assert_allclose(np.asarray(gm)[:, 0], np.asarray(fm)[:, 0],
                               rtol=INT8_LOSS_RTOL)
    for name, w in fp_params.items():
        moved = np.abs(w - init_params[name]).max()
        bound = 2 * moved + STEPS * np.abs(w).max() / 127
        diff = np.abs(gp[name] - w).max()
        assert diff <= bound, (opt, name, diff, bound)


def _gather_roundtrip(whole, dim, n):
    """``whole`` as the int8 all-gather re-replicates it from its ``n``
    shards along ``dim`` (each shard moved to dim 0, flattened,
    block-quantized and dequantized by the plain K5a/K5b), and each
    value's block step."""
    from dlrover_tpu_torch.ops import quantization as tq

    t = torch.from_numpy(whole)
    values, steps = [], []
    for shard in torch.chunk(t, n, dim=dim):
        moved = torch.movedim(shard, dim, 0)
        flat = moved.float().reshape(-1)
        q, scales = tq.quantize_reference(flat)
        for out, got in ((values, tq.dequantize_reference(
                q, scales, tuple(flat.shape))), (steps, scales[:, None].expand(
                    -1, tq.BLOCK).reshape(-1)[:flat.numel()])):
            out.append(torch.movedim(got.reshape(moved.shape), 0, dim))
    return (torch.cat(values, dim=dim).to(t.dtype).numpy(),
            torch.cat(steps, dim=dim).numpy())


def _step1_differ(got, ref, init_params, dims, n):
    """Over the split leaves drawn at init: the values of ``got`` in
    another quantization bin (more than half a block step away) than
    ``ref`` put through the all-gather's rounding, and the values the
    rounded init (a dropped update) has in another bin."""
    from dlrover_tpu_torch.optimizers import optax_ports as ox

    def stacked(tree):
        return {k: v.numpy() for k, v in ox.stack_layers(
            {k: torch.from_numpy(v) for k, v in tree.items()}).items()}

    got, ref, init_params = map(stacked, (got, ref, init_params))
    differ = dropped = 0
    for name, dim in dims.items():
        if dim is None or not init_params[name].any():
            continue
        want, steps = _gather_roundtrip(ref[name], dim, n)
        drop, _ = _gather_roundtrip(init_params[name], dim, n)
        differ += int((np.abs(got[name] - want) > steps / 2).sum())
        dropped += int((np.abs(drop - want) > steps / 2).sum())
    return differ, dropped


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("n", WORLDS)
def test_int8_step_one_keeps_its_update(port_runs, init, opt, n):
    """The int8 step 1 against the replicated step 1 through the
    all-gather's rounding: at most ``INT8_STEP1_SHARE`` as many values in
    another bin as a dropped update leaves; the planted step at learning
    rate 0, through the same path, fails."""
    runs = port_runs[n][0]
    ref = runs[f"{opt}/replicated@1"][1]
    dims = runs[f"{opt}/int8@1"][2]["split_dims"]
    assert any(d is not None for d in dims.values())
    differ, dropped = _step1_differ(runs[f"{opt}/int8@1"][1], ref, init[1],
                                    dims, n)
    assert dropped > 0
    assert differ <= INT8_STEP1_SHARE * dropped, (differ, dropped)
    planted, _ = _step1_differ(runs[f"{opt}/int8_lr0@1"][1], ref, init[1],
                               dims, n)
    assert planted > INT8_STEP1_SHARE * dropped, (planted, dropped)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", [m for m in MODES if m != "replicated"])
def test_zero1_step_equals_the_replicated_step(port_runs, init, opt, n,
                                               mode):
    """Every mode at world n against the replicated step at world n: fp
    to reassociation, int8 to its bound; every replica's parameters
    identical (one digest on every rank)."""
    runs = port_runs[n]
    got = runs[0][f"{opt}/{mode}"]
    base = runs[0][f"{opt}/replicated"]
    digests = {r[f"{opt}/{mode}"][3] for r in runs}
    assert len(digests) == 1
    assert all(t == BATCH * SEQ for _, _, t in got[0])
    if mode == "int8":
        _assert_int8_bound(got[:2], base[:2], opt, init[1])
    else:
        _assert_close(got[:2], base[:2], opt)


@pytest.mark.parametrize("n", WORLDS)
def test_zero1_shards_and_overlap_plan(port_runs, n):
    """ZeRO-1 halves (quarters) the update's state bytes where leaves
    split; q8_adam keeps a leaf whole where a shard would not be whole
    blocks; the overlap plan is the reference's plan of the stacked
    tree."""
    from dlrover_tpu.parallel import overlap as jov

    runs = port_runs[n][0]
    stats = runs["adafactor/zero1"][2]["zero1_stats"]
    assert stats["dp"] == n and stats["sharded_leaves"] >= 1
    assert stats["bytes_per_device_after"] < stats["bytes_per_device_before"]
    q8 = runs["q8_adam/zero1"][2]["zero1_stats"]
    assert q8["sharded_leaves"] + q8["replicated_leaves"] == \
        stats["sharded_leaves"] + stats["replicated_leaves"]
    plan = runs["adafactor/overlap"][2]["overlap_plan"]
    cfg = jgpt2_config("124m", **TINY, dtype=jnp.float32)
    abstract = jax.eval_shape(
        lambda: JModel(cfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"])
    from flax.linen import meta

    want = jov.plan_buckets(meta.unbox(abstract), 0.02).describe()
    assert plan == want

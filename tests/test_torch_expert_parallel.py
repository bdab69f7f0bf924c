"""Port parity: the expert axis (``runtime/mesh.py``, ``parallel/rules.
batch_group_axes``, ``parallel/quantized_collectives.all_to_all`` and
``quantized_all_to_all``, ``models/moe.py``'s a2a dispatch and batch
group, ``parallel/sharding.ExpertGroup``, ``train_lib.build_train`` and
``build_moe_stats_fn`` with an MoE config at more than one rank) against
the JAX package on the 8 virtual CPU devices.  Each world (2 and 4
spawned gloo processes) is spawned once for all its cases; every case
seeds its own generator.

* The all-to-alls, forward and backward (the cotangent's gradient of the
  input), against the reference's ``quantized_all_to_all`` and
  ``jax.lax.all_to_all`` under ``shard_map``, on chunks that pad a
  block: the plain exchange bit for bit; the int8 one equal to the
  reference's within one block step of either side's rounding (the
  dequantized values of a block are its codes times one fp32 scale, so
  two computations of the same codes agree to an fp32 rounding; a value
  whose code sits on a rounding boundary may take the next code).
* The MoE layer at ``expert=2`` and ``4`` (``"a2a"``, and ``"einsum"``,
  which runs the same exchange on an expert axis) against the
  reference's einsum layer on the whole batch with the same parameters:
  output, aux loss, and the gradients of the input, the router and every
  expert within ``LAYER_TOL`` (fp32 sums in another order); ``"a2a_int8"``
  within ``INT8_LAYER_RTOL`` of the output's scale.  (The reference's own
  a2a-against-einsum bitwise test does not hold on this CPU mesh, so the
  port is held to the einsum.)  The router statistics against the
  reference layer's sown vector.
* ``build_train`` against ``build_sharded_train`` (einsum, the same
  math) at ``expert=2`` and ``4`` (a2a; einsum at 2; Adafactor),
  ``data=2 x expert=2`` with ZeRO-1 and ``grad_accum=2`` (AdamW), and
  ``data=2`` grouped against the reference's grouped step (Adafactor):
  3 steps, metrics within ``METRIC_RTOL`` and parameters within
  ``PARAM_ATOL`` (``test_torch_model_parallel.py``'s); the a2a_int8 step
  within its stated bound.  The router statistics at init against
  ``build_moe_stats_fn``.  The expert legs' wire bytes against the count
  from the shapes.
* The expert leaves' boxes against the reference's ``NamedSharding``s,
  device by device; saves at ``expert=2`` and ``data=2 x expert=2``
  restored in one process bit for bit; the refusals.
"""

import concurrent.futures
import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import torch_worlds
from dlrover_tpu.models import moe as jmoe
from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.parallel import quantized_collectives as jqc
from dlrover_tpu.parallel import rules as jrules
from dlrover_tpu.runtime.mesh import ParallelConfig as JParallel
from dlrover_tpu.runtime.mesh import build_mesh as jbuild_mesh
from dlrover_tpu.runtime.mesh import shard_map_compat
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import (
    TransformerLM,
    param_logical_axes,
    stacked_logical_axes,
)
from dlrover_tpu_torch.parallel import quantized_collectives as tqc
from dlrover_tpu_torch.parallel import rules as trules
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.runtime import mesh as tmesh

BATCH, SEQ = torch_worlds.BATCH, torch_worlds.SEQ
STEPS = 3
METRIC_RTOL = 2e-6
PARAM_ATOL = 3e-5
# One MoE layer in fp32, sums over a few dozen terms in another order.
LAYER_TOL = 2e-5
# The int8 layer: each leg rounds a value to its block's step, at most
# 1/254 of the block's absmax; two legs and the expert products between
# them: within 2% of the output's largest value (the reference's own
# test holds its int8 layer to 5e-2).
INT8_LAYER_RTOL = 2e-2
# The a2a_int8 step (Adafactor, lr 1e-2): the wire rounds activations
# and their gradients by at most 1/254 of a block's absmax a leg, so a
# gradient moves by about 1% and the loss by less: the loss and grad norm
# within 1e-2 of the fp step's.  Each parameter within ``U + P`` of the
# fp step's (``test_torch_zero1.py``: U the fp step's largest total
# update of the leaf, P the path bound of an unfactored leaf, U for a
# factored one); the fp32 all-gather of the ranks' experts adds nothing.
INT8_METRIC_RTOL = 1e-2
INT8_STATS_CHOICES = 4

MESHES = {
    "expert2": (dict(data=1, expert=2), 2),
    "expert4": (dict(data=1, expert=4), 4),
    "data2_expert2": (dict(data=2, expert=2), 4),
    "data2": (dict(data=2), 2),
}
#: (port dispatch, mesh, optimizer, learning rate, build_train options,
#: the reference's dispatch)
CASES = [
    ("a2a", "expert2", "adafactor", 1e-2, {}, "einsum"),
    ("einsum", "expert2", "adafactor", 1e-2, {}, "einsum"),
    ("a2a", "data2_expert2", "adamw", 1e-3,
     dict(zero1=True, grad_accum=2), "einsum"),
    ("grouped", "data2", "adafactor", 1e-2, {}, "grouped"),
    ("a2a", "expert4", "adafactor", 1e-2, {}, "einsum"),
]
INT8_CASES = [("a2a_int8", "expert2", "adafactor", 1e-2, {}, "einsum")]
#: Sharded saves (the world each runs in: its mesh) of the a2a model,
#: each restored into one process.
SAVES = {2: dict(data=1, expert=2), 4: dict(data=2, expert=2)}

#: (id, quantized, shape of one member's input, dtype, split, concat).
A2A_CASES = [
    ("q-rows", True, (12, 100), "float32", 0, 0),
    ("q-inner", True, (5, 4, 77), "float32", 1, 0),
    ("q-bf16", True, (4, 3, 90), "bfloat16", 0, 1),
    ("fp-rows", False, (12, 100), "float32", 0, 0),
    ("fp-moe", False, (4, 2, 3, 16), "float32", 0, 1),
]
A2A_WORLDS = dict.fromkeys([c[0] for c in A2A_CASES], (2, 4))
LAYER_CASES = [("a2a", 2), ("einsum", 2), ("a2a_int8", 2), ("a2a", 4)]


def _key(dispatch, mesh, opt, kw):
    return f"moe_{dispatch}/{mesh}/{opt}" + (
        "/zero1_accum2" if kw.get("zero1") else "")


def _jcfg(dispatch):
    return jgpt2_config("124m", **torch_worlds.MOE, moe_dispatch=dispatch,
                        dtype=jnp.float32)


def _jax_init():
    train = jtl.build_sharded_train(
        JModel(_jcfg("einsum")), jtl.make_optimizer("sgd"),
        jbuild_mesh(JParallel(), devices=jax.devices()[:1]),
        jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ)
    params = jax.tree.map(np.asarray, train.init(
        jax.random.PRNGKey(0)).params)
    return params, {k: v.numpy() for k, v in state_dict_from_jax(
        params, torch_worlds.moe_config("einsum")).items()}


def _layer_params():
    c = torch_worlds.LAYER
    rng = np.random.default_rng(41)
    return {"router.kernel": (rng.normal(size=(c["d"], c["e"]))
                              / np.sqrt(c["d"])).astype(np.float32),
            "wi": (rng.normal(size=(c["e"], c["d"], c["f"]))
                   / np.sqrt(c["d"])).astype(np.float32),
            "wo": (rng.normal(size=(c["e"], c["f"], c["d"]))
                   / np.sqrt(c["f"])).astype(np.float32)}


def _layer_inputs():
    c = torch_worlds.LAYER
    rng = np.random.default_rng(42)
    x = rng.normal(size=(c["b"], c["s"], c["d"])).astype(np.float32)
    cot = rng.normal(size=(c["b"], c["s"], c["d"])).astype(np.float32)
    return x, cot


@pytest.fixture(scope="module")
def init():
    return _jax_init()


@pytest.fixture(scope="module")
def port_runs(init, tmp_path_factory):
    """Each world's cases (all-to-alls, layers, train cases) and its
    sharded save."""
    _, state = init
    cases = [(_key(d, mesh, o, kw), f"moe_{d}", MESHES[mesh][0],
              MESHES[mesh][1], o, lr, kw)
             for d, mesh, o, lr, kw, _ in CASES + INT8_CASES]
    refused = [("moe_grouped/expert2", "moe_grouped",
                MESHES["expert2"][0], 2, "adafactor", 1e-2, {})]
    root = tmp_path_factory.mktemp("ep")
    job = f"ep{os.getpid()}"
    saves = {n: {"save": str(root / f"ckpt{n}"), "job": f"{job}_{n}",
                 "parallel": parallel, "model": "moe_a2a"}
             for n, parallel in SAVES.items()}
    x, cot = _layer_inputs()
    payload = {"init": {m: state for m in {c[1] for c in cases + refused}},
               "cases": cases + refused, "saves": saves, "a2a": A2A_CASES,
               "layers": {"params": _layer_params(), "x": x, "cot": cot,
                          "cases": [(f"{d}/{n}", d, n)
                                    for d, n in LAYER_CASES]}}
    prev = os.environ.get("DLROVER_TPU_SOCKET_DIR")
    os.environ["DLROVER_TPU_SOCKET_DIR"] = str(root / "socks")
    os.makedirs(root / "socks", exist_ok=True)
    out = {}
    try:
        # The two worlds run side by side (6 processes).
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            worlds = {n: pool.submit(torch_worlds.run_world, n,
                                     torch_worlds.run_ep_cases, payload,
                                     root / f"w{n}") for n in (2, 4)}
            worlds = {n: f.result() for n, f in worlds.items()}
        for n, ranks in worlds.items():
            out[("save", n)] = [r.pop("save") for r in ranks]
            out[("save_dir", n)] = saves[n]["save"]
            out[("a2a", n)] = [r.pop("a2a") for r in ranks]
            out[("layers", n)] = [r.pop("layers") for r in ranks]
            for key in ranks[0]:
                out[key] = ranks
        yield out
    finally:
        if prev is None:
            os.environ.pop("DLROVER_TPU_SOCKET_DIR", None)
        else:
            os.environ["DLROVER_TPU_SOCKET_DIR"] = prev
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))


# -- the all-to-alls --------------------------------------------------------------


def _jax_a2a(case, n):
    """The reference's exchange of a case under ``shard_map`` on ``n``
    devices: every member's output and its input's gradient."""
    _, quant, shape, dtype, split, concat = case
    xs, gs = torch_worlds.a2a_case_inputs(case, n)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mesh = JMesh(np.array(jax.devices()[:n]), ("expert",))
    spec = P("expert", *([None] * len(shape)))

    @functools.partial(shard_map_compat, mesh=mesh, in_specs=spec,
                       out_specs=spec)
    def exchange(v):
        if quant:
            return jqc.quantized_all_to_all(
                v[0], "expert", split_axis=split, concat_axis=concat)[None]
        return jax.lax.all_to_all(v[0], "expert", split, concat,
                                  tiled=True)[None]

    def loss(v):
        return jnp.sum(exchange(v).astype(jnp.float32) * jnp.asarray(gs))

    x = jnp.asarray(xs, jdtype)
    y, dx = jax.jit(lambda v: (exchange(v), jax.grad(loss)(v)))(x)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)), str(y.dtype))


@pytest.mark.parametrize("case,n", [(c, n) for c in A2A_CASES
                                    for n in A2A_WORLDS[c[0]]],
                         ids=[f"{c[0]}-{n}" for c in A2A_CASES
                              for n in A2A_WORLDS[c[0]]])
def test_all_to_all_matches_the_references(port_runs, case, n):
    y, dx, dtype = _jax_a2a(case, n)
    ranks = port_runs[("a2a", n)]
    got_y = np.stack([r[case[0]][1] for r in ranks])
    got_dx = np.stack([r[case[0]][2] for r in ranks])
    assert all(r[case[0]][0] == f"torch.{dtype}" for r in ranks)
    if not case[1]:
        np.testing.assert_array_equal(got_y, y)
        np.testing.assert_array_equal(got_dx, dx)
        return
    # A value's block step, from the reference's (fp32) exchange of the
    # same inputs: a code on a rounding boundary may differ by one.
    xs, gs = torch_worlds.a2a_case_inputs(case, n)
    for got, want, src in ((got_y, y, xs), (got_dx, dx, gs)):
        step = np.abs(src).max() / 127
        assert np.abs(got - want).max() <= step * (1 + 1e-6) + (
            np.abs(want).max() * 2 ** -7 if case[3] == "bfloat16" else 0)
        # Nearly every value is the reference's to an fp32 rounding.
        close = np.isclose(got, want, rtol=1e-6, atol=1e-7 * step)
        assert close.mean() >= 0.99, close.mean()


def test_a2a_wire_bytes_match_the_reference():
    for n in (1, 255, 256, 257, 512, 4096 + 3):
        for quant in ("int8", "none"):
            assert tqc.a2a_wire_bytes(n, quant) == jqc.a2a_wire_bytes(
                n, quant)
    assert tqc.a2a_wire_bytes(100, "none", elem_bytes=2) == 200


# -- the MoE layer ---------------------------------------------------------------------


def _jax_layer():
    """The reference's einsum layer on the whole batch: output, aux,
    the gradients of ``sum(out * cot) + aux`` and the sown statistics."""
    c = torch_worlds.LAYER
    params = _layer_params()
    x, cot = _layer_inputs()
    layer = jmoe.MoEMlp(num_experts=c["e"], d_ff=c["f"], top_k=2,
                        activation="gelu", dtype=jnp.float32,
                        param_dtype=jnp.float32, dispatch="einsum")
    tree = {"router": {"kernel": jnp.asarray(params["router.kernel"])},
            "wi": jnp.asarray(params["wi"]), "wo": jnp.asarray(params["wo"])}

    def loss(tree, x):
        out, aux = layer.apply({"params": tree}, x)
        return jnp.sum(out * jnp.asarray(cot)) + aux, (out, aux)

    (_, (out, aux)), (g, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(tree, jnp.asarray(x))
    _, inter = jax.jit(functools.partial(
        layer.apply, mutable=["intermediates"]))({"params": tree},
                                                 jnp.asarray(x))
    stats = np.asarray(jax.tree_util.tree_leaves(inter)[0]).reshape(-1)
    grads = {"router.kernel": np.asarray(g["router"]["kernel"]),
             "wi": np.asarray(g["wi"]), "wo": np.asarray(g["wo"])}
    return np.asarray(out), float(aux), np.asarray(dx), grads, stats


@pytest.fixture(scope="module")
def jax_layer():
    return _jax_layer()


@pytest.mark.parametrize("dispatch,n", LAYER_CASES,
                         ids=[f"{d}-ep{n}" for d, n in LAYER_CASES])
def test_moe_layer_on_the_expert_axis_matches_the_einsum_layer(
        port_runs, jax_layer, dispatch, n):
    out, aux, dx, grads, stats = jax_layer
    ranks = [r[f"{dispatch}/{n}"] for r in port_runs[("layers", n)]]
    got = np.concatenate([r["out"] for r in ranks])
    got_dx = np.concatenate([r["dx"] for r in ranks])
    # Every rank's aux and statistics are the batch group's.
    assert len({r["aux"] for r in ranks}) == 1
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["stats"], ranks[0]["stats"])
    got_grads = {
        "router.kernel": sum(r["grads"]["router.kernel"] for r in ranks),
        "wi": np.concatenate([r["grads"]["wi"] for r in ranks]),
        "wo": np.concatenate([r["grads"]["wo"] for r in ranks])}
    assert got_grads["wi"].shape == grads["wi"].shape
    np.testing.assert_allclose(ranks[0]["aux"], aux, rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["stats"], stats, rtol=1e-5,
                               atol=1e-6)
    if dispatch == "a2a_int8":
        for g, w in [(got, out), (got_dx, dx)] + [
                (got_grads[k], grads[k]) for k in grads]:
            assert np.abs(g - w).max() <= INT8_LAYER_RTOL * np.abs(w).max()
        # ... and not the fp exchange's bits: the wire did round.
        assert not np.array_equal(got, out)
        return
    np.testing.assert_allclose(got, out, atol=LAYER_TOL, rtol=0)
    np.testing.assert_allclose(got_dx, dx, atol=LAYER_TOL, rtol=0)
    for k, w in grads.items():
        np.testing.assert_allclose(got_grads[k], w, atol=LAYER_TOL, rtol=0,
                                   err_msg=k)


# -- the step -------------------------------------------------------------------------

_JAX_RUNS = {}


def _jax_run(init_params, dispatch, mesh, opt, lr, kw):
    """The reference's 3 steps, once per (dispatch, mesh, optimizer,
    options) in the module."""
    key = (dispatch, mesh, opt, tuple(sorted(kw.items())))
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    mesh_kw, n = MESHES[mesh]
    train = jtl.build_sharded_train(
        JModel(_jcfg(dispatch)), jtl.make_optimizer(opt, learning_rate=lr),
        jbuild_mesh(JParallel(**mesh_kw), devices=jax.devices()[:n]),
        jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ, **kw)
    state = train.init(jax.random.PRNGKey(0))
    state = state.replace(params=jax.device_put(
        init_params, train.state_shardings.params))
    stats = np.asarray(jtl.build_moe_stats_fn(JModel(_jcfg(dispatch)), train)(
        state, jtl.shard_batch(torch_worlds.lm_batch(0), train)))
    metrics = []
    for i in range(STEPS):
        state, m = train.step(state, jtl.shard_batch(
            torch_worlds.lm_batch(i), train))
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["tokens"]), float(m["aux_loss"])))
    params = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, state.params),
        torch_worlds.moe_config(dispatch)).items()}
    _JAX_RUNS[key] = (metrics, params, stats)
    return _JAX_RUNS[key]


def _masked(name, a):
    if name.endswith("attn.qkv.bias"):
        hd = torch_worlds.MOE["d_model"] // torch_worlds.MOE["num_heads"]
        keep = np.ones(a.shape, bool)
        keep[..., hd:2 * hd] = False
        return a[keep]
    return a


def _a2a_bytes(n, quant, micro):
    """The expert axis's all-to-all bytes of one step and rank: per layer
    and microbatch, the dispatch and combine legs in the forward and
    again in the backward, each over the microbatch's ``[E, rows, C, D]``
    fp32 expert inputs (``remat="none"``: no recompute; every member's
    chunk is whole 256-value blocks, so ``a2a_wire_bytes`` is exact)."""
    cfg = torch_worlds.MOE
    rows = BATCH // n // micro
    cap = max(1, int(1.25 * SEQ * cfg["top_k"] / cfg["num_experts"]))
    leg = cfg["num_experts"] * rows * cap * cfg["d_model"]
    per = tqc.a2a_wire_bytes(leg, "int8" if quant else "none")
    return 4 * cfg["num_layers"] * micro * per


def _path_bound(lr, steps, rms):
    """How far Adafactor moves a value of an unfactored leaf in
    ``steps`` steps at most (``test_torch_zero1.py``)."""
    return lr * max(rms, 1e-3) * sum(t ** 0.4 for t in range(1, steps + 1))


@pytest.mark.parametrize("dispatch,mesh,opt,lr,kw,ref", CASES + INT8_CASES,
                         ids=[_key(d, m, o, k) for d, m, o, _, k, _ in
                              CASES + INT8_CASES])
def test_step_matches_jax_build_sharded_train(init, port_runs, dispatch,
                                              mesh, opt, lr, kw, ref):
    key = _key(dispatch, mesh, opt, kw)
    ranks = port_runs[key]
    want_metrics, want, want_stats = _jax_run(init[0], ref, mesh, opt, lr,
                                              kw)
    mesh_kw, n = MESHES[mesh]
    sizes = JParallel(**mesh_kw).sizes(n)
    for r, got in enumerate(ranks):
        # The batch group is data x expert, in rank order.
        assert got[key]["batch"] == (r, n)
        np.testing.assert_array_equal(got[key]["metrics"],
                                      ranks[0][key]["metrics"])
        np.testing.assert_array_equal(got[key]["stats"],
                                      ranks[0][key]["stats"])
    if dispatch == "a2a_int8":
        # The wire rounds the first layer's output, so the second layer
        # may route a few choices elsewhere: the drop fraction and the
        # loads (a layer mean over 2 layers of 512 choices each) within
        # ``INT8_STATS_CHOICES`` choices, the entropy within 1e-3.
        share = INT8_STATS_CHOICES / (2 * BATCH * SEQ * 2)
        np.testing.assert_allclose(ranks[0][key]["stats"][0], want_stats[0],
                                   rtol=1e-3)
        np.testing.assert_allclose(ranks[0][key]["stats"][1:],
                                   want_stats[1:], atol=share)
    else:
        np.testing.assert_allclose(ranks[0][key]["stats"], want_stats,
                                   rtol=1e-5, atol=1e-6)
    got_m = np.asarray(ranks[0][key]["metrics"])
    want_m = np.asarray(want_metrics)[:, :3]
    got = torch_worlds.assemble_params(ranks, key)
    assert set(got) == set(want)
    wire = ranks[0][key]["wire"]
    if sizes["expert"] > 1:
        assert wire["expert/all_to_all"] == _a2a_bytes(
            n, dispatch == "a2a_int8", kw.get("grad_accum", 1))
    else:
        assert not any(k.startswith("expert/") for k in wire)
    if dispatch == "a2a_int8":
        np.testing.assert_allclose(got_m, want_m, rtol=INT8_METRIC_RTOL)
        init_sd = init[1]
        for name, w in want.items():
            # Every leaf of the tiny model is unfactored (no two of its
            # stacked dimensions reach 128); its rms at the larger of the
            # init's and the end's.
            moved = np.abs(w - init_sd[name]).max()
            rms = max(np.sqrt(np.mean(np.square(a)))
                      for a in (init_sd[name], w))
            path = max(moved, _path_bound(lr, STEPS, rms))
            diff = np.abs(got[name] - w).max()
            assert diff <= moved + path, (name, diff, moved + path)
        return
    np.testing.assert_allclose(got_m, want_m, rtol=METRIC_RTOL)
    for name, w in want.items():
        diff = np.abs(_masked(name, got[name]) - _masked(name, w))
        assert diff.max() <= PARAM_ATOL, (name, diff.max())


def test_grouped_on_the_expert_axis_is_refused(port_runs):
    got = port_runs["moe_grouped/expert2"][0]["moe_grouped/expert2"]
    assert "grouped" in got["refused"] or "expert" in got["refused"]


# -- the shard functions -------------------------------------------------------------


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def _padded(spec, ndim):
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


@pytest.mark.parametrize("mesh", ["expert2", "expert4", "data2_expert2"])
def test_expert_leaves_split_as_the_references_shardings(mesh):
    mesh_kw, n = MESHES[mesh]
    jm = jbuild_mesh(JParallel(**mesh_kw), devices=jax.devices()[:n])
    jcfg = _jcfg("einsum")
    tokens = jnp.zeros((1, SEQ), jnp.int32)
    with nn.logical_axis_rules(jrules.DEFAULT_RULES):
        boxed = jax.eval_shape(
            lambda: JModel(jcfg).init(jax.random.PRNGKey(0), tokens))
    logical = dict(_flat(nn.get_partition_spec(boxed)["params"]))
    train = jtl.build_sharded_train(
        JModel(jcfg), jtl.make_optimizer("sgd"), jm, jrules.DEFAULT_RULES,
        global_batch_size=BATCH, seq_len=SEQ)
    shardings = dict(_flat(jax.tree.map(
        lambda s: s, train.state_shardings.params,
        is_leaf=lambda x: hasattr(x, "spec"))))
    shapes = dict(_flat(jax.tree.map(lambda a: tuple(a.shape),
                                     nn.meta.unbox(boxed)["params"])))
    port = TransformerLM(torch_worlds.moe_config("a2a"), device="meta")
    axes = stacked_logical_axes(param_logical_axes(port))
    assert set(axes) == set(logical)
    sizes = dict(zip(jm.axis_names, jm.devices.shape))
    layouts = sharding.leaf_layouts(
        axes, {k: tuple(v) for k, v in shapes.items()},
        trules.DEFAULT_RULES, sizes)
    split = []
    for name, names in axes.items():
        ndim = len(shapes[name])
        assert _padded(logical[name], ndim) == tuple(names), name
        spec = _padded(shardings[name].spec, ndim)
        assert trules.logical_to_mesh_axes(names, trules.DEFAULT_RULES) \
            == spec, name
        boxes = shardings[name].devices_indices_map(tuple(shapes[name]))
        for coord in np.ndindex(*jm.devices.shape):
            coords = dict(zip(jm.axis_names, coord))
            box = tuple(
                (s.start or 0, shapes[name][d] if s.stop is None else s.stop)
                for d, s in enumerate(boxes[jm.devices[coord]]))
            assert layouts[name].index(coords, sizes) == box, (name, coord)
        if layouts[name].splits:
            split.append(name)
    # The experts split on their expert dimension, nothing else.
    assert sorted(split) == ["blocks.moe.wi", "blocks.moe.wo"]
    assert all(layouts[n].splits == ((1, ("expert",)),) for n in split)


# -- checkpoints ------------------------------------------------------------------


def _assert_pieces_equal(got, whole):
    assert set(got) == set(whole)
    for path, (shape, index, _, value) in got.items():
        want = whole[path]
        if not isinstance(value, np.ndarray):
            assert value == want, path
            continue
        part = want[tuple(slice(b, e) for b, e in index)]
        assert value.dtype == part.dtype, path
        np.testing.assert_array_equal(value.view(np.uint8),
                                      np.ascontiguousarray(part).view(
                                          np.uint8), err_msg="".join(path))


@pytest.mark.parametrize("n", list(SAVES), ids=["expert2", "data2_expert2"])
def test_an_expert_save_restores_in_one_process(port_runs, n, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    os.makedirs(tmp_path / "socks", exist_ok=True)
    job = f"ep{os.getpid()}_{n}r"
    try:
        one = torch_worlds.save_and_restore(
            0, 1, {"restore": {n: port_runs[("save_dir", n)]}, "job": job,
                   "model": "moe_a2a"})
    finally:
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))
    pieces = [r["saved"] for r in port_runs[("save", n)]]
    # Each rank wrote its experts' boxes.
    split = [p for p, v in pieces[0].items()
             if v[1] != tuple((0, d) for d in v[0])]
    assert any("moe" in "".join(p) for p in split)
    whole = torch_worlds.assemble(pieces)
    step, got = one[n]
    assert step == 2
    _assert_pieces_equal(got, whole)


# -- the boundary ----------------------------------------------------------------


def test_check_axes_lets_the_expert_axis_through():
    tmesh.check_axes({"data": 2, "expert": 2})


class _Mesh:
    def __init__(self, **sizes):
        self.mesh_dim_names = tmesh.MESH_AXES
        self.shape = tuple(sizes.get(a, 1) for a in tmesh.MESH_AXES)


def test_batch_group_is_data_and_expert():
    assert trules.batch_group_axes(_Mesh(data=2, expert=2),
                                   trules.DEFAULT_RULES) == ("data", "expert")
    assert trules.batch_group_axes(_Mesh(expert=4),
                                   trules.DEFAULT_RULES) == ("expert",)


@pytest.mark.parametrize("sizes", [{"fsdp": 2}, {"tensor": 2}],
                         ids=["fsdp", "tensor"])
def test_moe_on_fsdp_or_tensor_is_refused(sizes):
    from dlrover_tpu_torch.models.transformer import check_parallel

    with pytest.raises(NotImplementedError, match="item 6's remainder"):
        check_parallel(torch_worlds.moe_config("a2a"), sizes)


def test_grouped_layer_on_an_expert_axis_raises():
    from dlrover_tpu_torch.models import moe

    class _Group:
        ep = 2

    with pytest.raises(ValueError, match="grouped"):
        moe.MoEMlp(16, 4, 32, dispatch="grouped", group=_Group(),
                   device="cpu")

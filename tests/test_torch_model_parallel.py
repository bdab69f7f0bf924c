"""Port parity: the fsdp and tensor axes (``parallel/sharding.py``, the
layers' ``kernel_axes``, ``train_lib.build_train`` on an fsdp or tensor
mesh, ``models/from_jax.shard_state_dict``, two-axis checkpoint records)
against the JAX package's ``build_sharded_train`` on the same
``ParallelConfig`` over as many of the 8 virtual CPU devices.

* The step: 3 steps at ``fsdp=2``, ``tensor=2``, ``fsdp=2 x tensor=2``
  and ``data=2 x fsdp=2`` with ZeRO-1, on a tiny GPT-2 (tied head, fused
  qkv, biases, learned positions) and a tiny Llama (GQA, SwiGLU, untied
  head), Adafactor, and AdamW on the Llama, each rank in a spawned gloo process; the
  weights are a JAX init carried across and cut to each rank's boxes.
  Tolerances as ``tests/test_torch_zero1.py``'s: metrics within
  ``METRIC_RTOL`` (2e-6) and parameters within ``PARAM_ATOL`` (3e-5),
  fp32 reassociation (the row-parallel products and the vocab-parallel
  log-sum-exp are sums of partial sums in another order), the key slice
  of the fused qkv bias left out for the reason given there.  q8_adam at
  ``fsdp=2`` on a GPT-2 wide enough that each fsdp slice is whole
  256-value blocks, with the low-bit limits of ``test_torch_train.py``;
  on the tiny GPT-2 the step refuses it.
* The shard functions: every parameter's logical axes, its mesh spec and
  each device's box, against the reference's ``get_partition_spec``,
  ``NamedSharding`` specs and ``devices_indices_map``.
* Checkpoints: a save at ``fsdp=2`` and at ``fsdp=2 x tensor=2``
  (leaves split on two dimensions by two axes, Adafactor's factored
  state among them) restores into one process bit for bit.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.models.llama import llama_config as jllama_config
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.parallel import rules as jrules
from dlrover_tpu.runtime.mesh import ParallelConfig as JParallel
from dlrover_tpu.runtime.mesh import build_mesh as jbuild_mesh
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import (
    TransformerLM,
    param_logical_axes,
    stacked_logical_axes,
)
from dlrover_tpu_torch.parallel import rules as trules
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.runtime import mesh as tmesh

BATCH, SEQ = torch_worlds.BATCH, torch_worlds.SEQ
STEPS = 3
METRIC_RTOL = 2e-6
PARAM_ATOL = 3e-5
LOW_BIT_METRIC_RTOL, LOW_BIT_PARAM_ATOL, LOW_BIT_PARAM_SHARE = 2e-5, 3e-4, \
    1e-3

MESHES = {
    "fsdp2": (dict(data=1, fsdp=2), 2),
    "tensor2": (dict(data=1, tensor=2), 2),
    "fsdp2_tensor2": (dict(data=1, fsdp=2, tensor=2), 4),
    "data2_fsdp2": (dict(data=2, fsdp=2), 4),
}
#: (model, mesh, optimizer, learning rate, build_train options)
CASES = [
    ("gpt2", "fsdp2", "adafactor", 1e-2, {}),
    ("gpt2", "tensor2", "adafactor", 1e-2, {}),
    ("gpt2", "fsdp2_tensor2", "adafactor", 1e-2, {}),
    ("gpt2", "data2_fsdp2", "adafactor", 1e-2, dict(zero1=True)),
    ("llama", "tensor2", "adafactor", 1e-2, {}),
    ("llama", "fsdp2_tensor2", "adamw", 1e-3, {}),
    ("wide", "fsdp2", "q8_adam", 1e-3, {}),
    # The training options: Lion and AGD on fsdp and tensor boxes, and a
    # transposed MLP wo ([d_model, d_ff], axes (embed, mlp)) split by
    # tensor on its dimension 1.
    ("gpt2", "fsdp2", "lion", 1e-3, {}),
    ("llama", "tensor2", "agd", 1e-3, {}),
    ("gpt2_wot", "tensor2", "adafactor", 1e-2, {}),
]
# Lion steps by a sign: a value whose interpolation lies within
# reassociation noise of 0 may step the other way, 2 lr apart.
LION_FLIP_SHARE = 1e-3
REFUSED = [("gpt2", "fsdp2", "q8_adam", 1e-3, {})]
#: Sharded saves (the world each runs in: its mesh), each restored into
#: one process.
SAVES = {2: dict(fsdp=2, data=1), 4: dict(fsdp=2, tensor=2, data=1)}


def _key(model, mesh, opt, kw):
    return f"{model}/{mesh}/{opt}" + ("/zero1" if kw.get("zero1") else "")


def _jcfg(model):
    if model == "llama":
        return jllama_config("tiny", **torch_worlds.LLAMA, dtype=jnp.float32)
    return jgpt2_config("124m", **(torch_worlds.WIDE if model == "wide"
                                   else torch_worlds.TINY),
                        dtype=jnp.float32,
                        wo_transposed=model == "gpt2_wot")


def _jax_init(model):
    train = jtl.build_sharded_train(
        JModel(_jcfg(model)), jtl.make_optimizer("sgd"),
        jbuild_mesh(JParallel(), devices=jax.devices()[:1]),
        jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ)
    params = jax.tree.map(np.asarray, train.init(
        jax.random.PRNGKey(0)).params)
    return params, {k: v.numpy() for k, v in state_dict_from_jax(
        params, torch_worlds.mp_config(model)).items()}


@pytest.fixture(scope="module")
def inits():
    return {m: _jax_init(m) for m in ("gpt2", "llama", "wide", "gpt2_wot")}


@pytest.fixture(scope="module")
def port_runs(inits, tmp_path_factory):
    """Each world's cases, and in the same worlds the sharded saves of
    ``SAVES`` (key ``"save"``: each rank's saved pieces and digest; the
    checkpoint directory under ``"save_dir"``)."""
    cases = [(_key(m, mesh, o, kw), m, MESHES[mesh][0], MESHES[mesh][1],
              o, lr, kw) for m, mesh, o, lr, kw in CASES + REFUSED]
    root = tmp_path_factory.mktemp("mp")
    job = f"mp{os.getpid()}"
    saves = {n: {"save": str(root / f"ckpt{n}"), "job": f"{job}_{n}",
                 "parallel": parallel, "digest": True}
             for n, parallel in SAVES.items()}
    payload = {"init": {m: s for m, (_, s) in inits.items()},
               "cases": cases, "saves": saves}
    prev = os.environ.get("DLROVER_TPU_SOCKET_DIR")
    os.environ["DLROVER_TPU_SOCKET_DIR"] = str(root / "socks")
    os.makedirs(root / "socks", exist_ok=True)
    out = {}
    try:
        for n in (2, 4):
            ranks = torch_worlds.run_world(
                n, torch_worlds.run_mp_cases, payload, root / f"w{n}")
            for key in ranks[0]:
                out[key] = ranks
            out[("save", n)] = [r.pop("save") for r in ranks]
            out[("save_dir", n)] = saves[n]["save"]
        yield out
    finally:
        if prev is None:
            os.environ.pop("DLROVER_TPU_SOCKET_DIR", None)
        else:
            os.environ["DLROVER_TPU_SOCKET_DIR"] = prev
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))


def _jax_run(init_params, model, mesh, opt, lr, kw):
    mesh_kw, n = MESHES[mesh]
    train = jtl.build_sharded_train(
        JModel(_jcfg(model)), jtl.make_optimizer(opt, learning_rate=lr),
        jbuild_mesh(JParallel(**mesh_kw), devices=jax.devices()[:n]),
        jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ, **kw)
    state = train.init(jax.random.PRNGKey(0))
    state = state.replace(params=jax.device_put(
        init_params, train.state_shardings.params))
    metrics = []
    for i in range(STEPS):
        state, m = train.step(state, jtl.shard_batch(
            torch_worlds.lm_batch(i), train))
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["tokens"])))
    params = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, state.params),
        torch_worlds.mp_config(model)).items()}
    return metrics, params


def _masked(name, a, model):
    if model != "llama" and name.endswith("attn.qkv.bias"):
        cfg = torch_worlds.WIDE if model == "wide" else torch_worlds.TINY
        hd = cfg["d_model"] // cfg["num_heads"]
        keep = np.ones(a.shape, bool)
        keep[..., hd:2 * hd] = False
        return a[keep]
    return a


@pytest.mark.parametrize("model,mesh,opt,lr,kw", CASES,
                         ids=[_key(m, s, o, k) for m, s, o, _, k in CASES])
def test_step_matches_jax_build_sharded_train(inits, port_runs, model, mesh,
                                              opt, lr, kw):
    key = _key(model, mesh, opt, kw)
    ranks = port_runs[key]
    want_metrics, want = _jax_run(inits[model][0], model, mesh, opt, lr, kw)
    mesh_kw, n = MESHES[mesh]
    sizes = JParallel(**mesh_kw).sizes(n)
    batch_ranks = sizes["data"] * sizes["fsdp"]
    # Every rank reports the same metrics; the ranks of a tensor group
    # take the same rows.
    for r, got in enumerate(ranks):
        assert got[key]["batch"] == (r // sizes["tensor"], batch_ranks)
        assert got[key]["zero1"] == bool(kw.get("zero1"))
        np.testing.assert_array_equal(got[key]["metrics"],
                                      ranks[0][key]["metrics"])
    low_bit = opt == "q8_adam"
    np.testing.assert_allclose(
        np.asarray(ranks[0][key]["metrics"]), np.asarray(want_metrics),
        rtol=LOW_BIT_METRIC_RTOL if low_bit else METRIC_RTOL)
    got = torch_worlds.assemble_params(ranks, key)
    assert set(got) == set(want)
    flips = total = 0
    for name, w in want.items():
        diff = np.abs(_masked(name, got[name], model)
                      - _masked(name, w, model))
        if opt == "lion":
            assert diff.max() <= 2 * lr * STEPS + PARAM_ATOL, name
            flips += int((diff > PARAM_ATOL).sum())
            total += diff.size
        elif low_bit:
            assert diff.max() <= 10 * LOW_BIT_PARAM_ATOL, name
            assert (diff > LOW_BIT_PARAM_ATOL).mean() <= \
                LOW_BIT_PARAM_SHARE, name
        else:
            assert diff.max() <= PARAM_ATOL, (name, diff.max())
    assert flips <= LION_FLIP_SHARE * max(total, 1), (flips, total)
    wire = ranks[0][key]["wire"]
    for axis in ("fsdp", "tensor"):
        used = any(k.startswith(f"{axis}/") for k in wire)
        assert used == (sizes[axis] > 1), (axis, wire)


def test_a_q8_state_not_in_whole_blocks_is_refused(port_runs):
    (m, mesh, o, _, kw), = REFUSED
    got = port_runs[_key(m, mesh, o, kw)][0][_key(m, mesh, o, kw)]
    assert "whole 256-value blocks" in got["refused"]


# -- the shard functions ---------------------------------------------------------


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def _padded(spec, ndim):
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


@pytest.mark.parametrize("model", ["gpt2", "llama"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_leaf_splits_match_the_references_shardings(model, mesh):
    mesh_kw, n = MESHES[mesh]
    jm = jbuild_mesh(JParallel(**mesh_kw), devices=jax.devices()[:n])
    jcfg = _jcfg(model)
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
    port = TransformerLM(torch_worlds.mp_config(model), device="meta")
    axes = stacked_logical_axes(param_logical_axes(port))
    assert set(axes) == set(logical)
    sizes = dict(zip(jm.axis_names, jm.devices.shape))
    layouts = sharding.leaf_layouts(
        axes, {k: tuple(v) for k, v in shapes.items()},
        trules.DEFAULT_RULES, sizes)
    for name, names in axes.items():
        ndim = len(shapes[name])
        assert _padded(logical[name], ndim) == tuple(names), name
        spec = _padded(shardings[name].spec, ndim)
        assert trules.logical_to_mesh_axes(names, trules.DEFAULT_RULES) \
            == spec, name
        want = tuple((d, tuple(a for a in ((e,) if isinstance(e, str)
                                           else e) if sizes[a] > 1))
                     for d, e in enumerate(spec) if e is not None)
        assert layouts[name].splits == tuple(
            (d, a) for d, a in want if a), name
        boxes = shardings[name].devices_indices_map(tuple(shapes[name]))
        for coord in np.ndindex(*jm.devices.shape):
            coords = dict(zip(jm.axis_names, coord))
            box = tuple(
                (s.start or 0, shapes[name][d] if s.stop is None else s.stop)
                for d, s in enumerate(boxes[jm.devices[coord]]))
            assert layouts[name].index(coords, sizes) == box, (name, coord)


def test_whole_block_runs():
    lay = sharding.LeafSplit((2, 512, 768), ((1, ("fsdp",)),))
    assert sharding.runs_are_whole_blocks(lay, {"fsdp": 2}, 256)
    assert not sharding.runs_are_whole_blocks(
        sharding.LeafSplit((128, 64), ((1, ("fsdp",)),)), {"fsdp": 2}, 256)
    assert sharding.runs_are_whole_blocks(
        sharding.LeafSplit((512, 64), ((0, ("fsdp",)),)), {"fsdp": 2}, 256)


# -- checkpoints -----------------------------------------------------------------


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


@pytest.mark.parametrize("n", list(SAVES), ids=["fsdp2", "fsdp2_tensor2"])
def test_a_sharded_save_restores_in_one_process(port_runs, n, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    os.makedirs(tmp_path / "socks", exist_ok=True)
    job = f"mp{os.getpid()}_{n}r"
    try:
        one = torch_worlds.save_and_restore(
            0, 1, {"restore": {n: port_runs[("save_dir", n)]}, "job": job})
    finally:
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))
    saved = port_runs[("save", n)]
    pieces = [r["saved"] for r in saved]
    # Each rank wrote boxes of the split leaves: pieces of two shapes.
    split = [p for p, v in pieces[0].items()
             if v[1] != tuple((0, d) for d in v[0])]
    assert split
    whole = torch_worlds.assemble(pieces)
    step, got = one[n]
    assert step == 2
    _assert_pieces_equal(got, whole)
    # The SDC digest over the world completes each split leaf's byte sum:
    # every rank reports the whole state's digest.
    from dlrover_tpu_torch.trainer import state_digest

    leaves = [torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for v in whole.values()]
    want = int(state_digest.digest_leaves([2] + leaves))
    assert [r["digest"] for r in saved] == [want] * n


# -- refusals and the mesh's pure parts --------------------------------------------


class _Mesh:
    """What ``build_mesh`` would give at these axis sizes."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tmesh.MESH_AXES
        self.shape = tuple(sizes.get(a, 1) for a in tmesh.MESH_AXES)


def test_check_axes_lets_fsdp_and_tensor_through():
    tmesh.check_axes({"data": 2, "fsdp": 2, "tensor": 2})


def test_batch_group_is_data_and_fsdp():
    mesh = _Mesh(data=2, fsdp=2, tensor=2)
    assert trules.batch_group_axes(mesh, trules.DEFAULT_RULES) == (
        "data", "fsdp")
    assert trules.batch_shard_count(mesh, trules.DEFAULT_RULES) == 4
    assert trules.batch_group_axes(_Mesh(tensor=2),
                                   trules.DEFAULT_RULES) == ()


def test_mesh_coords_are_row_major_over_the_axes():
    mesh = _Mesh(data=2, fsdp=2, tensor=2)
    seen = {tuple(tmesh.mesh_coords(mesh, r)[a] for a in
                  ("data", "fsdp", "tensor")) for r in range(8)}
    assert len(seen) == 8
    assert tmesh.mesh_coords(mesh, 5) == {
        "data": 1, "fsdp": 0, "pipe": 0, "expert": 0, "seq": 0,
        "tensor": 1}


@pytest.mark.parametrize("overrides,sizes,match", [
    (dict(num_heads=6, num_kv_heads=6), {"tensor": 4}, "heads"),
    (dict(num_kv_heads=2), {"tensor": 4}, "KV heads"),
    (dict(num_kv_heads=4, d_ff=130), {"tensor": 4}, "d_ff"),
    (dict(num_kv_heads=4, vocab_size=130), {"tensor": 4}, "vocab_size"),
    (dict(d_model=66, num_heads=6), {"fsdp": 4}, "d_model"),
], ids=["heads", "kv_heads", "d_ff", "vocab", "d_model"])
def test_configs_that_do_not_divide_are_refused(overrides, sizes, match):
    from dlrover_tpu_torch.models import llama_config
    from dlrover_tpu_torch.models.transformer import check_parallel

    cfg = llama_config("tiny", **{**torch_worlds.LLAMA, **overrides})
    with pytest.raises(ValueError, match=match):
        check_parallel(cfg, sizes)


def test_an_moe_config_on_a_model_axis_is_refused():
    from dlrover_tpu_torch.models import moe_llama_config
    from dlrover_tpu_torch.models.transformer import check_parallel

    with pytest.raises(NotImplementedError, match="item 6"):
        check_parallel(moe_llama_config("tiny", num_experts=4),
                       {"fsdp": 2})


def test_leaf_split_boxes_and_replicas():
    sizes = {"data": 2, "fsdp": 2, "tensor": 2}
    lay = sharding.LeafSplit((8, 6), ((0, ("fsdp",)), (1, ("tensor",))))
    whole = torch.arange(48).reshape(8, 6)
    seen = torch.zeros_like(whole)
    for coord in np.ndindex(2, 2, 2):
        coords = dict(zip(("data", "fsdp", "tensor"), coord))
        box = lay.take(whole, coords, sizes)
        assert tuple(box.shape) == lay.local_shape(sizes) == (4, 3)
        index = lay.index(coords, sizes)
        assert torch.equal(box, whole[tuple(slice(b, e) for b, e in index)])
        assert lay.replica_id(coords, sizes) == coords["data"]
        if coords["data"] == 0:
            seen[tuple(slice(b, e) for b, e in index)] += 1
    assert bool((seen == 1).all())
    zero1 = lay.with_split(0, "data")
    assert zero1.dim_axes(0) == ("fsdp", "data")
    assert zero1.index({"data": 1, "fsdp": 1, "tensor": 0}, sizes) == (
        (6, 8), (0, 3))


def test_a_tensor_group_draws_the_same_samples(monkeypatch):
    """The sampler on a model-parallel mesh: its members are the batch
    group's ranks (data x fsdp, data-major, as ``shard_batch`` takes
    rows); the ranks of a tensor group draw the same samples."""
    from dlrover_tpu_torch.data.loader import (
        ElasticDistributedSampler,
        batch_group_member,
    )

    mesh = _Mesh(data=2, fsdp=2, tensor=2)
    drawn = {}
    for rank in range(8):
        monkeypatch.setattr(tmesh, "process_index", lambda r=rank: r)
        member = batch_group_member(mesh)
        coords = tmesh.mesh_coords(mesh)
        assert member == (coords["data"] * 2 + coords["fsdp"], 4)
        drawn[rank] = list(ElasticDistributedSampler(64, mesh=mesh, seed=3))
    for rank in range(0, 8, 2):
        assert drawn[rank] == drawn[rank + 1]
    groups = [set(drawn[r]) for r in range(0, 8, 2)]
    assert sum(map(len, groups)) == 64 and set().union(*groups) == set(
        range(64))

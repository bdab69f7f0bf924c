"""Port parity: the seq axis with Ulysses' all-to-alls
(``models/attention.ulysses_attention``, ``parallel/sharding.SeqGroup``,
``parallel/rules.sequence_axis``, ``train_lib.build_train`` on a mesh
with ``seq``) against the JAX package on the same ``ParallelConfig``
over as many of the 8 virtual CPU devices.

* ``ulysses_attention``: the output and the gradients of q, k and v of a
  seq group of 2 (each rank its slice of the sequence, in a spawned gloo
  process) against the reference's ``ulysses_attention`` under a
  ``seq=2`` mesh, with GQA and packed segments; fp32, within
  ``ULYSSES_ATOL`` (2e-6: the same products summed in another order).
* The step: 3 steps at ``seq=2``, ``seq=2 x tensor=2`` and ``data=2 x
  seq=2`` with ZeRO-1 against ``build_sharded_train``, on the tiny GPT-2
  (learned positions) and the tiny Llama (RoPE; GQA at ``seq=2`` and
  ``data=2 x seq=2``, as many KV heads as heads at ``seq=2 x tensor=2``,
  where its 2 KV heads a tensor rank would not split again), Adafactor
  and AdamW, at ``tests/test_torch_model_parallel.py``'s tolerances
  (metrics ``METRIC_RTOL`` 2e-6, parameters ``PARAM_ATOL`` 3e-5).  With
  every rank's position offset planted at 0 the same steps fail them.
* A save at ``seq=2`` restores into one process bit for bit.
* The refusals of ``check_parallel``, ``build_train`` and the mesh.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from dlrover_tpu.models.attention import ulysses_attention as j_ulysses
from dlrover_tpu.models.attention import xla_attention as j_xla
from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.models.llama import llama_config as jllama_config
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.parallel import rules as jrules
from dlrover_tpu.runtime.mesh import ParallelConfig as JParallel
from dlrover_tpu.runtime.mesh import build_mesh as jbuild_mesh
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.parallel import rules as trules
from dlrover_tpu_torch.runtime import mesh as tmesh

BATCH, SEQ = torch_worlds.BATCH, torch_worlds.SEQ
STEPS = 3
METRIC_RTOL = 2e-6
PARAM_ATOL = 3e-5
ULYSSES_ATOL = 2e-6

MESHES = {
    "seq2": (dict(data=1, seq=2), 2),
    "seq2_tensor2": (dict(data=1, seq=2, tensor=2), 4),
    "data2_seq2": (dict(data=2, seq=2), 4),
}
#: (model, mesh, optimizer, learning rate, build_train options)
CASES = [
    ("gpt2", "seq2", "adafactor", 1e-2, {}),
    ("llama", "seq2", "adamw", 1e-3, {}),
    ("gpt2", "seq2_tensor2", "adafactor", 1e-2, {}),
    ("llama_mha", "seq2_tensor2", "adamw", 1e-3, {}),
    ("gpt2", "data2_seq2", "adafactor", 1e-2, dict(zero1=True)),
    ("llama", "data2_seq2", "adafactor", 1e-2, dict(zero1=True)),
]
#: The same steps with every rank's tokens at offset 0.
PLANTED = [("gpt2", "seq2", "adafactor", 1e-2, {}),
           ("llama", "seq2", "adamw", 1e-3, {})]
SAVE = dict(seq=2, data=1)


def _key(model, mesh, opt, kw, planted=False):
    return (f"{model}/{mesh}/{opt}" + ("/zero1" if kw.get("zero1") else "")
            + ("/offset0" if planted else ""))


def _jcfg(model):
    if model.startswith("llama"):
        kw = dict(torch_worlds.LLAMA)
        if model == "llama_mha":
            kw["num_kv_heads"] = kw["num_heads"]
        return jllama_config("tiny", **kw, dtype=jnp.float32)
    return jgpt2_config("124m", **torch_worlds.TINY, dtype=jnp.float32)


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
    return {m: _jax_init(m) for m in ("gpt2", "llama", "llama_mha")}


@pytest.fixture(scope="module")
def port_runs(inits, tmp_path_factory):
    """Every case, planted case and the seq=2 save in a world of 2 and a
    world of 4 (key ``("save", 2)``: each rank's saved pieces;
    ``("save_dir", 2)``: the checkpoint directory; ``"ulysses"``: each
    rank's ``ulysses_attention`` results)."""
    def case(spec, planted=False):
        m, mesh, o, lr, kw = spec
        return (_key(m, mesh, o, kw, planted), m, MESHES[mesh][0],
                MESHES[mesh][1], o, lr, kw)

    root = tmp_path_factory.mktemp("sp")
    job = f"sp{os.getpid()}"
    payload = {"init": {m: s for m, (_, s) in inits.items()},
               "cases": [case(c) for c in CASES],
               "planted": [case(c, True) for c in PLANTED],
               "saves": {2: {"save": str(root / "ckpt2"), "job": f"{job}_2",
                             "parallel": SAVE}}}
    prev = os.environ.get("DLROVER_TPU_SOCKET_DIR")
    os.environ["DLROVER_TPU_SOCKET_DIR"] = str(root / "socks")
    os.makedirs(root / "socks", exist_ok=True)
    out = {}
    try:
        for n in (2, 4):
            ranks = torch_worlds.run_world(
                n, torch_worlds.run_sp_cases, payload, root / f"w{n}")
            for key in ranks[0]:
                out[key] = ranks
            if n == 2:
                out[("save", 2)] = [r.pop("save") for r in ranks]
                out[("save_dir", 2)] = str(root / "ckpt2")
        yield out
    finally:
        if prev is None:
            os.environ.pop("DLROVER_TPU_SOCKET_DIR", None)
        else:
            os.environ["DLROVER_TPU_SOCKET_DIR"] = prev
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))


# -- ulysses_attention ---------------------------------------------------------


@pytest.mark.parametrize("case", torch_worlds.ULYSSES_CASES,
                         ids=[c[0] for c in torch_worlds.ULYSSES_CASES])
def test_ulysses_attention_matches_the_reference(port_runs, case):
    q, k, v, dout, seg = torch_worlds.ulysses_inputs(case)
    mesh = jbuild_mesh(JParallel(data=1, seq=2), devices=jax.devices()[:2])

    def attn(q, k, v, seg):
        return j_xla(q, k, v, causal=True, segment_ids=seg)

    def run(q, k, v):
        return j_ulysses(attn, q, k, v,
                         None if seg is None else jnp.asarray(seg))

    with jtl.use_mesh(mesh):
        out, vjp = jax.vjp(run, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
        want = (out,) + vjp(jnp.asarray(dout))
    # Each rank holds its slice of the sequence of every result.
    got = [np.concatenate([r["ulysses"][case[0]][i] for r in
                           port_runs["ulysses"]], axis=1) for i in range(4)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=ULYSSES_ATOL, err_msg=name)


# -- the step ------------------------------------------------------------------


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
    """The GPT-2 fused qkv bias without its key slice (the reason is
    ``tests/test_torch_zero1.py``'s)."""
    if model == "gpt2" and name.endswith("attn.qkv.bias"):
        hd = torch_worlds.TINY["d_model"] // torch_worlds.TINY["num_heads"]
        keep = np.ones(a.shape, bool)
        keep[..., hd:2 * hd] = False
        return a[keep]
    return a


@pytest.fixture(scope="module")
def jax_runs(inits):
    memo = {}

    def run(model, mesh, opt, lr, kw):
        key = _key(model, mesh, opt, kw)
        if key not in memo:
            memo[key] = _jax_run(inits[model][0], model, mesh, opt, lr, kw)
        return memo[key]

    return run


@pytest.mark.parametrize("model,mesh,opt,lr,kw", CASES,
                         ids=[_key(m, s, o, k) for m, s, o, _, k in CASES])
def test_step_matches_jax_build_sharded_train(port_runs, jax_runs, model,
                                              mesh, opt, lr, kw):
    key = _key(model, mesh, opt, kw)
    ranks = port_runs[key]
    want_metrics, want = jax_runs(model, mesh, opt, lr, kw)
    mesh_kw, n = MESHES[mesh]
    sizes = JParallel(**mesh_kw).sizes(n)
    # The ranks of a seq (and tensor) group take the same rows; every rank
    # reports the same metrics.
    for r, got in enumerate(ranks):
        assert got[key]["batch"] == (
            r // (sizes["seq"] * sizes["tensor"]), sizes["data"])
        assert got[key]["zero1"] == bool(kw.get("zero1"))
        np.testing.assert_array_equal(got[key]["metrics"],
                                      ranks[0][key]["metrics"])
    np.testing.assert_allclose(np.asarray(ranks[0][key]["metrics"]),
                               np.asarray(want_metrics), rtol=METRIC_RTOL)
    got = torch_worlds.assemble_params(ranks, key)
    assert set(got) == set(want)
    for name, w in want.items():
        diff = np.abs(_masked(name, got[name], model) - _masked(name, w,
                                                                model))
        assert diff.max() <= PARAM_ATOL, (name, diff.max())
    # Ulysses' legs and the gradients' sum ride the seq axis's wire.
    wire = ranks[0][key]["wire"]
    assert wire["seq/all_to_all"] > 0 and wire["seq/all_reduce"] > 0, wire


@pytest.mark.parametrize("model,mesh,opt,lr,kw", PLANTED,
                         ids=[_key(m, s, o, k) for m, s, o, _, k in PLANTED])
def test_a_wrong_position_offset_fails_the_parity(port_runs, jax_runs, model,
                                                  mesh, opt, lr, kw):
    want_metrics, want = jax_runs(model, mesh, opt, lr, kw)
    ranks = port_runs[_key(model, mesh, opt, kw, planted=True)]
    got = np.asarray(ranks[0][_key(model, mesh, opt, kw, True)]["metrics"])
    loss_gap = np.abs(got[:, 0] - np.asarray(want_metrics)[:, 0]).max()
    assert loss_gap > 100 * METRIC_RTOL * abs(want_metrics[0][0]), loss_gap


# -- checkpoints -----------------------------------------------------------------


def test_a_seq2_save_restores_in_one_process(port_runs, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    os.makedirs(tmp_path / "socks", exist_ok=True)
    job = f"sp{os.getpid()}_r"
    try:
        one = torch_worlds.save_and_restore(
            0, 1, {"restore": {2: port_runs[("save_dir", 2)]}, "job": job})
    finally:
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))
    saved = port_runs[("save", 2)]
    pieces = [r["saved"] for r in saved]
    # seq splits no leaf: both ranks hold every leaf whole, rank 1 as a
    # replica that writes nothing.
    for rank, p in enumerate(pieces):
        assert all(v[1] == tuple((0, d) for d in v[0]) and v[2] == rank
                   for v in p.values() if isinstance(v[3], np.ndarray))
    whole = torch_worlds.assemble(pieces)
    step, got = one[2]
    assert step == 2
    assert set(got) == set(whole)
    for path, (_, _, _, value) in got.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value.view(np.uint8),
                                          whole[path].view(np.uint8))
        else:
            assert value == whole[path], path


# -- refusals --------------------------------------------------------------------


@pytest.mark.parametrize("overrides,sizes,match", [
    (dict(num_heads=6, num_kv_heads=6), {"seq": 4}, "heads"),
    (dict(num_kv_heads=2), {"seq": 2, "tensor": 2}, "KV heads per tensor"),
    (dict(num_kv_heads=2), {"seq": 4}, "KV heads per tensor"),
], ids=["heads", "kv_heads_seq_tensor", "kv_heads_seq"])
def test_configs_that_seq_cannot_split_are_refused(overrides, sizes, match):
    from dlrover_tpu_torch.models import llama_config
    from dlrover_tpu_torch.models.transformer import check_parallel

    cfg = llama_config("tiny", **{**torch_worlds.LLAMA, **overrides})
    with pytest.raises(ValueError, match=match):
        check_parallel(cfg, sizes)


class _Mesh:
    """What ``build_mesh`` would give at these axis sizes."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tmesh.MESH_AXES
        self.shape = tuple(sizes.get(a, 1) for a in tmesh.MESH_AXES)


def test_step_refusals_on_a_seq_mesh():
    from dlrover_tpu_torch.models import moe_llama_config
    from dlrover_tpu_torch.models.transformer import check_parallel
    from dlrover_tpu_torch.trainer import train_lib as ttl

    cfg = torch_worlds.mp_config("gpt2")
    with pytest.raises(ValueError, match="seq_len 30 does not divide"):
        ttl.build_train(cfg, ttl.make_optimizer("sgd"), global_batch_size=4,
                        seq_len=30, mesh=_Mesh(seq=4), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6's remainder"):
        check_parallel(moe_llama_config("tiny", num_experts=4), {"seq": 2})
    # Ring attention keeps the heads off the seq axis (ROADMAP Queue 1
    # item 9, tests/test_torch_ring_attention.py): the sequence is split.
    assert trules.sequence_axis(_Mesh(seq=2), trules.RING_RULES) == 2
    assert trules.grad_sum_axes(_Mesh(data=2, seq=2),
                                trules.RING_RULES) == ("data", "seq")
    assert trules.sequence_axis(_Mesh(seq=2), trules.DEFAULT_RULES) == 2
    assert trules.grad_sum_axes(_Mesh(data=2, seq=2),
                                trules.DEFAULT_RULES) == ("data", "seq")
    # The seq axis splits no parameter: the position table stays whole.
    assert trules.leaf_splits(("act_seq", "embed"), trules.DEFAULT_RULES,
                              {"seq": 2, "fsdp": 1}) == ()


def test_check_axes_takes_seq_and_still_refuses_pipe():
    """The mesh takes seq and pipe (ROADMAP Queue 1 item 9); a pipe axis
    beside a seq axis is still refused, as item 9's remainder."""
    from dlrover_tpu_torch.models.transformer import check_parallel

    tmesh.check_axes({"data": 1, "seq": 2, "tensor": 2})
    tmesh.check_axes({"data": 1, "seq": 2, "pipe": 2})
    with pytest.raises(NotImplementedError, match="item 9's remainder"):
        check_parallel(torch_worlds.mp_config("gpt2"), {"seq": 2, "pipe": 2})

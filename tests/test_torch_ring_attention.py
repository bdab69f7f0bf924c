"""Port parity: ring attention on the seq axis
(``parallel/ring_attention.py``, ``models/attention.py``'s ring branch,
``parallel/rules.RING_RULES``, ``train_lib.build_train`` with
``attention_impl="ring"``) against the JAX package on the same
``ParallelConfig`` over as many of the 8 virtual CPU devices.

* ``ring_attention``: the output and the gradients of q, k and v of seq
  groups of 2 and 4 (each rank its slice of the sequence, in a spawned
  gloo process) against the reference's ``ring_attention`` under a
  ``seq=2`` and a ``seq=4`` mesh, causal and not, with GQA and packed
  segments; fp32, within ``RING_ATOL`` (2e-6: the same products, the
  chunks' merges in another order).  A chunk in row tiles (``ROW_BLOCK``
  12 of 32 rows) is the plain attention's function; a bf16 ring of one
  is within ``RING_OP_RTOL`` of fp32 attention and a planted 1% scale is
  not.
* The step: 3 steps at ``seq=2``, ``data=2 x seq=2`` with ZeRO-1 and
  ``seq=2 x tensor=2`` against ``build_sharded_train`` with
  ``RING_RULES`` (the reference's ``test_ring_model_end_to_end``), on the
  tiny GPT-2 (learned positions, tied head) and the tiny Llama (RoPE,
  GQA), Adafactor and AdamW, at ``tests/test_torch_seq_parallel.py``'s
  tolerances (``METRIC_RTOL`` 2e-6, ``PARAM_ATOL`` 3e-5); the hops ride
  the seq axis's wire.
* ``fit`` with ring attention at ``seq=2``: its save restores into one
  process bit for bit; a live re-layout of the seq mesh is refused
  (ROADMAP Queue 1 item 9's remainder).
"""

import functools
import os

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
from dlrover_tpu.parallel.ring_attention import ring_attention as j_ring
from dlrover_tpu.runtime.mesh import ParallelConfig as JParallel
from dlrover_tpu.runtime.mesh import build_mesh as jbuild_mesh
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax

BATCH, SEQ = torch_worlds.BATCH, torch_worlds.SEQ
STEPS = 3
METRIC_RTOL = 2e-6
PARAM_ATOL = 3e-5
RING_ATOL = 2e-6

MESHES = {
    "seq2": (dict(data=1, seq=2), 2),
    "data2_seq2": (dict(data=2, seq=2), 4),
    "seq2_tensor2": (dict(data=1, seq=2, tensor=2), 4),
}
#: (model, mesh, optimizer, learning rate, build_train options)
CASES = [
    ("gpt2", "seq2", "adafactor", 1e-2, {}),
    ("llama", "seq2", "adamw", 1e-3, {}),
    ("gpt2", "data2_seq2", "adafactor", 1e-2, dict(zero1=True)),
    ("llama", "data2_seq2", "adafactor", 1e-2, dict(zero1=True)),
    ("gpt2", "seq2_tensor2", "adafactor", 1e-2, {}),
    ("llama", "seq2_tensor2", "adamw", 1e-3, {}),
]


def _key(model, mesh, opt, kw):
    return f"{model}/ring/{mesh}/{opt}" + ("/zero1" if kw.get("zero1")
                                           else "")


def _jcfg(model):
    if model == "llama":
        return jllama_config("tiny", **torch_worlds.LLAMA, dtype=jnp.float32,
                             attention_impl="ring")
    return jgpt2_config("124m", **torch_worlds.TINY, dtype=jnp.float32,
                        attention_impl="ring")


def _jax_init(model):
    train = jtl.build_sharded_train(
        JModel(_jcfg(model)), jtl.make_optimizer("sgd"),
        jbuild_mesh(JParallel(), devices=jax.devices()[:1]),
        jrules.RING_RULES, global_batch_size=BATCH, seq_len=SEQ)
    params = jax.tree.map(np.asarray, train.init(
        jax.random.PRNGKey(0)).params)
    return params, {k: v.numpy() for k, v in state_dict_from_jax(
        params, torch_worlds.mp_config(f"{model}/ring")).items()}


@pytest.fixture(scope="module")
def inits():
    return {m: _jax_init(m) for m in ("gpt2", "llama")}


@pytest.fixture(scope="module")
def port_runs(inits, tmp_path_factory):
    """Every case in a world of 2 and a world of 4, and the
    ``ring_attention`` cases in both (key ``("ring", n)``: each rank's
    results)."""
    def case(spec):
        m, mesh, o, lr, kw = spec
        return (_key(m, mesh, o, kw), f"{m}/ring", MESHES[mesh][0],
                MESHES[mesh][1], o, lr, kw)

    root = tmp_path_factory.mktemp("ring")
    job = f"ring{os.getpid()}"
    payload = {"init": {f"{m}/ring": s for m, (_, s) in inits.items()},
               "cases": [case(c) for c in CASES],
               "saves": {2: {"save": str(root / "ckpt2"), "job": f"{job}_2",
                             "parallel": dict(seq=2, data=1),
                             "model": "gpt2/ring", "relayout": 1}}}
    prev = os.environ.get("DLROVER_TPU_SOCKET_DIR")
    os.environ["DLROVER_TPU_SOCKET_DIR"] = str(root / "socks")
    os.makedirs(root / "socks", exist_ok=True)
    out = {}
    try:
        for n in (2, 4):
            ranks = torch_worlds.run_world(
                n, torch_worlds.run_ring_cases, payload, root / f"w{n}")
            out[("ring", n)] = [r.pop("ring") for r in ranks]
            if n == 2:
                out[("save", 2)] = [r.pop("save") for r in ranks]
                out[("save_dir", 2)] = str(root / "ckpt2")
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


# -- ring_attention ------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", torch_worlds.RING_CASES,
                         ids=[c[0] for c in torch_worlds.RING_CASES])
def test_ring_attention_matches_the_reference(port_runs, case, n):
    q, k, v, dout, seg = torch_worlds.ulysses_inputs(case[:7])
    mesh = jbuild_mesh(JParallel(data=1, seq=n), devices=jax.devices()[:n])
    fn = functools.partial(
        j_ring, causal=case[7],
        segment_ids=None if seg is None else jnp.asarray(seg))

    @jax.jit
    def run(q, k, v, dout):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(dout)

    with jtl.use_mesh(mesh):
        want = run(*map(jnp.asarray, (q, k, v, dout)))
    # Each rank holds its slice of the sequence of every result.
    got = [np.concatenate([r[case[0]][i] for r in port_runs[("ring", n)]],
                          axis=1) for i in range(4)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=RING_ATOL,
                                   err_msg=name)


# -- the step ------------------------------------------------------------------


def _jax_run(init_params, model, mesh, opt, lr, kw):
    mesh_kw, n = MESHES[mesh]
    train = jtl.build_sharded_train(
        JModel(_jcfg(model)), jtl.make_optimizer(opt, learning_rate=lr),
        jbuild_mesh(JParallel(**mesh_kw), devices=jax.devices()[:n]),
        jrules.RING_RULES, global_batch_size=BATCH, seq_len=SEQ, **kw)
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
        torch_worlds.mp_config(f"{model}/ring")).items()}
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


@pytest.mark.parametrize("model,mesh,opt,lr,kw", CASES,
                         ids=[_key(m, s, o, k) for m, s, o, _, k in CASES])
def test_ring_step_matches_jax_build_sharded_train(port_runs, inits, model,
                                                   mesh, opt, lr, kw):
    key = _key(model, mesh, opt, kw)
    ranks = port_runs[key]
    want_metrics, want = _jax_run(inits[model][0], model, mesh, opt, lr, kw)
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
    # The hops and the gradients' sum ride the seq axis's wire; no
    # all-to-all (Ulysses') runs.
    wire = ranks[0][key]["wire"]
    assert wire["seq/send"] > 0 and wire["seq/all_reduce"] > 0, wire
    assert "seq/all_to_all" not in wire, wire


def test_ring_attention_is_a_ring_of_one_without_a_seq_axis():
    """No group: the whole sequence is one chunk, the plain attention's
    function (the port's ``xla_attention``), forward and backward."""
    from dlrover_tpu_torch.models.attention import xla_attention
    from dlrover_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v, dout, seg = (None if a is None else torch.from_numpy(a)
                          for a in torch_worlds.ulysses_inputs(
                              torch_worlds.RING_CASES[2][:7], seed=3))
    got, want = [], []
    for fn, out in ((ring_attention, got), (xla_attention, want)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs, causal=True, segment_ids=seg)
        o.backward(dout)
        out += [o.detach()] + [t.grad for t in xs]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=RING_ATOL, msg=name)


@pytest.mark.parametrize("case", torch_worlds.RING_CASES,
                         ids=[c[0] for c in torch_worlds.RING_CASES])
def test_ring_attention_row_tiles_match_the_plain_attention(case,
                                                            monkeypatch):
    """A chunk taken ``ROW_BLOCK`` query rows at a time, the last tile
    short (12, 12 and 8 of 32 rows), forward and backward, is the plain
    attention's function within ``RING_ATOL``."""
    from dlrover_tpu_torch.models.attention import xla_attention
    from dlrover_tpu_torch.parallel import ring_attention as ra

    monkeypatch.setattr(ra, "ROW_BLOCK", 12)
    assert [t.stop - t.start for t in ra._row_tiles(32)] == [12, 12, 8]
    q, k, v, dout, seg = (None if a is None else torch.from_numpy(a)
                          for a in torch_worlds.ulysses_inputs(case[:7],
                                                               seed=4))
    got, want = [], []
    for fn, out in ((ra.ring_attention, got), (xla_attention, want)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs, causal=case[7], segment_ids=seg)
        o.backward(dout)
        out += [o.detach()] + [t.grad for t in xs]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=RING_ATOL, msg=name)


#: ``chip_smoke.RING_OP_RTOL``: a bf16 ring against plain fp32 attention,
#: each tensor's error over the reference's norm.
RING_OP_RTOL = 4e-3


def test_a_bf16_ring_against_fp32_attention_and_a_planted_scale(monkeypatch):
    """bf16 ``[1, 1024, 4, 128]``, causal, a ring of one in two row tiles:
    the output and the q/k/v gradients within ``RING_OP_RTOL`` of
    ``mha_reference`` / ``mha_backward_reference`` in fp32 (the check
    ``chip_smoke`` makes on the card at ``[1, 4096, 32, 128]``), and
    every tile's scores scaled 1% too much outside it, forward and
    backward."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import ring_attention as ra

    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((1, 1024, 4, 128), generator=gen)
                   .bfloat16() for _ in range(4))
    q32, k32, v32 = q.float(), k.float(), v.float()
    o32, lse = fa.mha_reference(q32, k32, v32, causal=True)
    ref = (o32,) + tuple(fa.mha_backward_reference(
        q32, k32, v32, o32, lse, do.float(), causal=True))

    def errors():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = ra.ring_attention(*leaves, causal=True)
        o.backward(do)
        got = (o.detach(),) + tuple(x.grad for x in leaves)
        return [float((g.float() - r).norm() / r.norm())
                for g, r in zip(got, ref)]

    plain = errors()
    assert max(plain) <= RING_OP_RTOL, plain
    scores = ra._scores
    monkeypatch.setattr(ra, "_scores", lambda *a: scores(
        *a[:6], a[6] * 1.01, a[7]))
    planted = errors()
    assert min(planted) > RING_OP_RTOL, planted


def test_a_ring_seq2_fit_saves_and_restores_in_one_process(port_runs,
                                                           tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    os.makedirs(tmp_path / "socks", exist_ok=True)
    job = f"ring{os.getpid()}_r"
    try:
        one = torch_worlds.save_and_restore(
            0, 1, {"restore": {2: port_runs[("save_dir", 2)]}, "job": job,
                   "model": "gpt2/ring"})
    finally:
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))
    saved = port_runs[("save", 2)]
    for r in saved:
        assert "item 9's remainder" in r["relayout"], r["relayout"]
    whole = torch_worlds.assemble([r["saved"] for r in saved])
    step, got = one[2]
    assert step == 2
    assert set(got) == set(whole)
    for path, (_, _, _, value) in got.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value.view(np.uint8),
                                          whole[path].view(np.uint8))
        else:
            assert value == whole[path], path

"""Port parity: the pipe axis and the pipeline (``parallel/pipeline.py``,
``parallel/sharding.PipeGroup``, ``models/transformer.py`` with
``pipeline_stages > 1``, ``train_lib.build_train`` on a mesh with
``pipe``) against the JAX package's ``PipelinedBlocks`` under
``build_sharded_train`` on the same ``ParallelConfig`` over as many of
the 8 virtual CPU devices.

* The step: 3 steps of the 4-layer tiny models at 2 stages and 4
  microbatches: GPipe and the circular schedule (``pipeline_interleave=
  2``) at ``pipe=2`` on GPT-2 (tied embedding: the head's gradient on the
  last stage and the lookup's on the first are summed) and Llama
  (untied), GPipe at ``data=2 x pipe=2`` with ZeRO-1 and at ``pipe=2 x
  tensor=2``; the loss, the gradient norm and the token count within
  ``METRIC_RTOL`` (2e-6) and every parameter within ``PARAM_ATOL`` (3e-5),
  ``tests/test_torch_seq_parallel.py``'s tolerances.  The JAX state starts
  from the plain 4-layer init reshaped to ``[S, L / S, ...]`` (as the
  reference's own ``tests/test_pipeline.py`` does) and the port from that
  pipelined tree through ``state_dict_from_jax``.  The schedule's ticks,
  useful ticks and handoff bytes are the shapes' counts.
* ``state_dict_from_jax`` of the pipelined tree, and the reference's
  validations with its messages.
* ``fit`` at ``pipe=2``: its save (each layer written whole by its
  stage) restores into one process bit for bit; a live re-layout of the
  pipe mesh is refused (ROADMAP Queue 1 item 9's remainder).
"""

import dataclasses
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
from dlrover_tpu.runtime.mesh import ParallelConfig as JParallel
from dlrover_tpu.runtime.mesh import build_mesh as jbuild_mesh
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax

BATCH, SEQ = torch_worlds.BATCH, torch_worlds.SEQ
STEPS = 3
METRIC_RTOL = 2e-6
PARAM_ATOL = 3e-5
STAGES = 2

MESHES = {
    "pipe2": (dict(data=1, pipe=2), 2),
    "data2_pipe2": (dict(data=2, pipe=2), 4),
    "pipe2_tensor2": (dict(data=1, pipe=2, tensor=2), 4),
}
#: (model, variant, mesh, optimizer, learning rate, build_train options)
CASES = [
    ("gpt2", "pp", "pipe2", "adafactor", 1e-2, {}),
    ("llama", "pp", "pipe2", "adamw", 1e-3, {}),
    ("gpt2", "pp_v2", "pipe2", "adafactor", 1e-2, {}),
    ("llama", "pp_v2", "pipe2", "adamw", 1e-3, {}),
    ("gpt2", "pp", "data2_pipe2", "adafactor", 1e-2, dict(zero1=True)),
    ("llama", "pp", "pipe2_tensor2", "adamw", 1e-3, {}),
]
SAVE = dict(pipe=2, data=1)


def _key(model, variant, mesh, opt, kw):
    return f"{model}/{variant}/{mesh}/{opt}" + ("/zero1" if kw.get("zero1")
                                                else "")


def _jcfg(model, variant=None):
    kw = dict(torch_worlds.LLAMA if model == "llama" else torch_worlds.TINY)
    kw.update(torch_worlds.VARIANTS[variant or "pp"])
    if variant is None:
        # The plain stack of the same layers.
        kw.update(pipeline_stages=1, num_microbatches=0,
                  pipeline_interleave=1)
    if model == "llama":
        return jllama_config("tiny", **kw, dtype=jnp.float32)
    return jgpt2_config("124m", **kw, dtype=jnp.float32)


def _staged(params):
    """A plain ``[L, ...]`` tree -> the pipelined ``[S, L / S, ...]``
    one."""
    def reshape(leaf):
        return leaf.reshape(STAGES, leaf.shape[0] // STAGES,
                            *leaf.shape[1:])

    out = dict(params)
    out["blocks"] = {"ticks": {"stages": {"layers": jax.tree.map(
        reshape, params["blocks"])}}}
    return out


def _jax_init(model):
    train = jtl.build_sharded_train(
        JModel(_jcfg(model)), jtl.make_optimizer("sgd"),
        jbuild_mesh(JParallel(), devices=jax.devices()[:1]),
        jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ)
    return _staged(jax.tree.map(np.asarray, train.init(
        jax.random.PRNGKey(0)).params))


@pytest.fixture(scope="module")
def inits():
    return {m: _jax_init(m) for m in ("gpt2", "llama")}


@pytest.fixture(scope="module")
def port_runs(inits, tmp_path_factory):
    """Every case in a world of 2 and a world of 4, and the pipe=2 save
    (key ``("save", 2)``: each rank's saved pieces; ``("save_dir", 2)``:
    the checkpoint directory)."""
    def case(spec):
        m, var, mesh, o, lr, kw = spec
        return (_key(m, var, mesh, o, kw), f"{m}/{var}", MESHES[mesh][0],
                MESHES[mesh][1], o, lr, kw)

    root = tmp_path_factory.mktemp("pp")
    job = f"pp{os.getpid()}"
    init = {}
    for m, var, *_ in CASES:
        init[f"{m}/{var}"] = {k: v.numpy() for k, v in state_dict_from_jax(
            inits[m], torch_worlds.mp_config(f"{m}/{var}")).items()}
    payload = {"init": init, "cases": [case(c) for c in CASES],
               "saves": {2: {"save": str(root / "ckpt2"), "job": f"{job}_2",
                             "parallel": SAVE, "model": "gpt2/pp",
                             "relayout": 1}}}
    prev = os.environ.get("DLROVER_TPU_SOCKET_DIR")
    os.environ["DLROVER_TPU_SOCKET_DIR"] = str(root / "socks")
    os.makedirs(root / "socks", exist_ok=True)
    out = {}
    try:
        for n in (2, 4):
            ranks = torch_worlds.run_world(
                n, torch_worlds.run_mp_cases, payload, root / f"w{n}")
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


# -- the step ------------------------------------------------------------------


def _jax_run(init_params, model, variant, mesh, opt, lr, kw):
    mesh_kw, n = MESHES[mesh]
    train = jtl.build_sharded_train(
        JModel(_jcfg(model, variant)),
        jtl.make_optimizer(opt, learning_rate=lr),
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
        torch_worlds.mp_config(f"{model}/{variant}")).items()}
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


@pytest.mark.parametrize(
    "model,variant,mesh,opt,lr,kw", CASES,
    ids=[_key(m, v, s, o, k) for m, v, s, o, _, k in CASES])
def test_pipeline_step_matches_jax_build_sharded_train(
        port_runs, inits, model, variant, mesh, opt, lr, kw):
    key = _key(model, variant, mesh, opt, kw)
    ranks = port_runs[key]
    want_metrics, want = _jax_run(inits[model], model, variant, mesh, opt,
                                  lr, kw)
    mesh_kw, n = MESHES[mesh]
    sizes = JParallel(**mesh_kw).sizes(n)
    # The ranks of a pipe (and tensor) group take the same rows; every
    # rank reports the same metrics (the last stage's loss reaches all).
    for r, got in enumerate(ranks):
        assert got[key]["batch"] == (
            r // (sizes["pipe"] * sizes["tensor"]), sizes["data"])
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
    # The schedule of one step: M + S - 1 (vM + S - 1) ticks, vM of them
    # useful on each stage; every hop a microbatch's activation (forward)
    # or its gradient (backward): (vS - 1) M hops, over the ranks.
    v = torch_worlds.VARIANTS[variant].get("pipeline_interleave", 1)
    micro = torch_worlds.VARIANTS[variant]["num_microbatches"]
    rows = BATCH // sizes["data"] // micro
    hop = rows * SEQ * torch_worlds.TINY["d_model"] * 4
    hops = 0
    for r, got in enumerate(ranks):
        counts = got[key]["pipeline"]
        assert counts["ticks"] == v * micro + STAGES - 1, counts
        assert counts["useful_ticks"] == v * micro, counts
        assert counts["handoff_bytes"] % hop == 0, counts
        hops += counts["handoff_bytes"] // hop
    assert hops == 2 * (v * STAGES - 1) * micro * n // STAGES
    wire = ranks[0][key]["wire"]
    assert wire["pipe/send"] > 0 and wire["pipe/all_reduce"] > 0, wire


# -- the mapping and the validations ------------------------------------------


def test_state_dict_from_jax_maps_the_pipelined_tree(inits):
    """Stage ``s``'s layer ``j`` of ``blocks/ticks/stages/layers`` is
    ``blocks.<s L / S + j>``: the pipelined tree maps onto the names the
    plain ``[L, ...]`` tree maps onto, value for value."""
    staged = inits["llama"]
    layers = staged["blocks"]["ticks"]["stages"]["layers"]
    plain = dict(staged)
    plain["blocks"] = jax.tree.map(
        lambda a: a.reshape(-1, *a.shape[2:]), layers)
    cfg = torch_worlds.mp_config("llama/pp")
    got = state_dict_from_jax(staged, cfg)
    want = state_dict_from_jax(plain, dataclasses.replace(
        cfg, pipeline_stages=1, num_microbatches=0))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    leaf = layers["attn"]["query"]["kernel"]
    assert torch.equal(got["blocks.3.attn.query.kernel"],
                       torch.from_numpy(leaf[1, 1].copy()))


def _raises(fn):
    with pytest.raises(Exception) as e:
        fn()
    return e


@pytest.mark.parametrize("overrides,batch", [
    (dict(pipeline_stages=3), 4),
    (dict(pipeline_stages=2, num_experts=2), 4),
    (dict(pipeline_stages=2, num_microbatches=2), 3),
], ids=["layers", "moe", "batch"])
def test_pipeline_validates_as_the_reference(overrides, batch):
    """The reference's ``PipelinedBlocks`` checks, with its messages (the
    MoE refusal adds that the reference refuses it too)."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )

    kw = dict(torch_worlds.TINY, num_layers=4, **overrides)
    want = _raises(lambda: JModel(jgpt2_config("124m", **kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((batch, 16), jnp.int32)))

    def port():
        cfg = gpt2_config("124m", **kw, dtype=torch.float32)
        model = TransformerLM(cfg, device="cpu")
        model.load_state_dict(init_params(cfg, device="cpu"))
        model(torch.zeros((batch, 16), dtype=torch.long))

    got = _raises(port)
    assert got.type is want.type
    assert str(got.value).startswith(str(want.value)), (got.value,
                                                        want.value)


# -- checkpoints -----------------------------------------------------------------


def test_a_pipe2_save_restores_in_one_process(port_runs, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    os.makedirs(tmp_path / "socks", exist_ok=True)
    job = f"pp{os.getpid()}_r"
    try:
        one = torch_worlds.save_and_restore(
            0, 1, {"restore": {2: port_runs[("save_dir", 2)]}, "job": job,
                   "model": "gpt2/pp"})
    finally:
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))
    saved = port_runs[("save", 2)]
    # fit ran at pipe=2; a live re-layout of a pipe mesh is item 9's
    # remainder.
    for r in saved:
        assert "item 9's remainder" in r["relayout"], r["relayout"]
    pieces = [r["saved"] for r in saved]
    # Each stage holds and writes its own layers whole; the leaves
    # outside the blocks are whole on both, written by stage 0.
    for stage, p in enumerate(pieces):
        layers = {int(path[1].split(".")[1]) for path in p
                  if path[0] == "['params']" and "blocks." in path[1]}
        assert layers == {2 * stage, 2 * stage + 1}, layers
        for path, (shape, index, replica, value) in p.items():
            if path[0] == "['params']" and "blocks." in path[1]:
                assert replica == 0 and index == tuple(
                    (0, d) for d in shape), path
            elif path[0] == "['params']":
                assert replica == stage, path
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

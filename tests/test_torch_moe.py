"""Port parity: the MoE slice (``dlrover_tpu_torch.ops.grouped_matmul``,
``dlrover_tpu_torch.models.moe`` and an MoE ``TransformerLM`` trained by
``build_train``) against the JAX package.

Same numpy inputs (each test seeds its own generator) and the same
JAX-initialised weights through both packages, in fp32.  The JAX grouped
matmul runs its Pallas kernels in interpret mode on the CPU, as
``tests/test_moe_grouped.py`` runs them; the port's CPU tensors take the
plain versions of K8 and K9.  Tolerances are stated where they are used.
Where routing could tie, the top-k indices of both sides are checked to
agree before outputs are compared.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import moe as jmoe
from dlrover_tpu.models.llama import moe_llama_config as jmoe_llama_config
from dlrover_tpu.models.transformer import TransformerConfig as JConfig
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.ops import grouped_matmul as jgm
from dlrover_tpu.parallel import rules as jrules
from dlrover_tpu.runtime.mesh import ParallelConfig, build_mesh
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models import moe as tmoe
from dlrover_tpu_torch.models import moe_llama_config
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import TransformerConfig as TConfig
from dlrover_tpu_torch.models.transformer import TransformerLM as TModel
from dlrover_tpu_torch.models.transformer import init_params
from dlrover_tpu_torch.ops import grouped_matmul as tgm
from dlrover_tpu_torch.rl.generation import SamplingParams
from dlrover_tpu_torch.serving import Request, ServePrograms, ServingEngine
from dlrover_tpu_torch.trainer import train_lib as ttl

# fp32 products of a few dozen terms summed in another order: 1e-5.
GMM_TOL = 1e-5
# One MoE layer (router, two or three expert products, weighted combine)
# in fp32: 2e-5 absolute on outputs of scale ~1.
LAYER_TOL = 2e-5


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# -- grouped matmul --------------------------------------------------------------

# (block_rows, group sizes, N): an empty expert and tail padding rows in
# each; in the second the last expert is empty too (JAX zeroes its dw).
GMM_CASES = [
    (8, [16, 0, 8, 24], 64),
    (8, [8, 16, 24, 0], 56),
    (128, [128, 0, 256, 128], 640),
]


@pytest.mark.parametrize("block,sizes,n", GMM_CASES)
def test_expert_of_block_matches_jax(block, sizes, n):
    gs = np.asarray(sizes, np.int32)
    want = np.asarray(jgm._expert_of_block(jnp.asarray(gs), n // block, block))
    got = tgm.expert_of_block(torch.as_tensor(gs), n // block, block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block,sizes,n", GMM_CASES)
def test_grouped_matmul_forward_and_vjp_match_jax(block, sizes, n):
    rng = np.random.default_rng(11)
    k, m = 16, 24
    gs = np.asarray(sizes, np.int32)
    # The tail rows are not zero here, so the last expert's claim on them
    # (the clamped block map) is part of what is compared.
    x = rng.normal(size=(n, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), k, m)).astype(np.float32)
    dy = rng.normal(size=(n, m)).astype(np.float32)

    want, vjp = jax.vjp(
        lambda a, b: jgm.grouped_matmul(a, b, jnp.asarray(gs), block),
        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))

    xt, wt = _t(x, True), _t(w, True)
    got = tgm.grouped_matmul(xt, wt, torch.as_tensor(gs), block)
    got.backward(_t(dy))
    for name, g, r in (("out", got, want), ("dx", xt.grad, want_dx),
                       ("dw", wt.grad, want_dw)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=GMM_TOL, atol=GMM_TOL, err_msg=name)
    # Experts that own no rows get exactly zero dw.
    for e, size in enumerate(sizes):
        if size == 0:
            assert not wt.grad[e].any()
    # The plain versions directly: dx reads w [E, K, M] transposed per
    # expert, as the kernel does, and dw is its own function.
    gs_t = torch.as_tensor(gs)
    np.testing.assert_allclose(
        tgm.grouped_matmul_reference(_t(dy), _t(w), gs_t,
                                     transpose_w=True).numpy(),
        np.asarray(want_dx), rtol=GMM_TOL, atol=GMM_TOL)
    np.testing.assert_allclose(
        tgm.grouped_matmul_dw_reference(_t(x), _t(dy), gs_t).numpy(),
        np.asarray(want_dw), rtol=GMM_TOL, atol=GMM_TOL)


def test_grouped_matmul_refuses_what_the_kernel_cannot_take():
    x = torch.zeros((24, 8))
    w = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="multiple of block_rows"):
        tgm.grouped_matmul(x, w, torch.tensor([8, 8]), 16)
    with pytest.raises(ValueError, match="no kernel"):
        tgm.grouped_matmul(x.to("meta"), w.to("meta"), torch.tensor([8, 8]),
                           8)


# -- gating ------------------------------------------------------------------------


def _logits(seed, b=2, s=24, e=4):
    return np.random.default_rng(seed).normal(size=(b, s, e)).astype(
        np.float32)


@pytest.mark.parametrize("k,capacity", [(1, 4), (2, 6), (2, 100)])
def test_top_k_gating_matches_jax(k, capacity):
    logits = _logits(3)
    jd, jc, jaux = jmoe.top_k_gating(jnp.asarray(logits), k, capacity)
    _, jidx, _ = jmoe._gate(jnp.asarray(logits), k)
    _, tidx, _ = tmoe.gate(_t(logits), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    td, tc, taux = tmoe.top_k_gating(_t(logits), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)


# -- the MoE layer -------------------------------------------------------------------

E, D, F_ = 4, 32, 64


def _layer_pair(dispatch, activation, capacity_factor=1.25, block=8,
                seed=0):
    kw = dict(num_experts=E, d_ff=F_, top_k=2,
              capacity_factor=capacity_factor, activation=activation,
              dtype=jnp.float32, param_dtype=jnp.float32, dispatch=dispatch,
              gmm_block_rows=block)
    jlayer = jmoe.MoEMlp(**kw)
    x0 = jnp.zeros((1, 8, D), jnp.float32)
    params = nn.meta.unbox(jlayer.init(jax.random.PRNGKey(seed), x0)[
        "params"])
    tlayer = tmoe.MoEMlp(D, E, F_, top_k=2, capacity_factor=capacity_factor,
                         activation=activation, dtype=torch.float32,
                         dispatch=dispatch, gmm_block_rows=block,
                         device="cpu")
    state = {"router.kernel": params["router"]["kernel"], "wi": params["wi"],
             "wo": params["wo"]}
    if activation == "swiglu":
        state["wg"] = params["wg"]
    tlayer.load_state_dict({k: _t(v) for k, v in state.items()})
    return jlayer, params, tlayer


def _check_routing_agrees(params, x):
    logits = np.asarray(x) @ np.asarray(params["router"]["kernel"])
    _, jidx, _ = jmoe._gate(jnp.asarray(logits), 2)
    _, tidx, _ = tmoe.gate(_t(logits), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("dispatch", ["einsum", "grouped", "a2a"])
def test_moe_layer_matches_jax(dispatch, activation):
    x = np.random.default_rng(5).normal(size=(2, 16, D)).astype(np.float32)
    jlayer, params, tlayer = _layer_pair(dispatch, activation)
    _check_routing_agrees(params, x)
    want, want_aux = jlayer.apply({"params": params}, jnp.asarray(x))
    got, got_aux = tlayer(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LAYER_TOL, rtol=0)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
def test_grouped_moe_layer_gradients_match_jax(activation):
    """Router and expert gradients through the grouped dispatch (dx and dw
    of every expert product, the gate's path into the combine, the aux
    loss) against ``jax.grad``: 2e-5 relative to each gradient's scale."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, D)).astype(np.float32)
    cot = rng.normal(size=(2, 16, D)).astype(np.float32)
    jlayer, params, tlayer = _layer_pair("grouped", activation)
    _check_routing_agrees(params, x)

    def jloss(p, xx):
        out, aux = jlayer.apply({"params": p}, xx)
        return jnp.sum(out * cot) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _t(x, True)
    out, aux = tlayer(xt)
    ((out * _t(cot)).sum() + aux).backward()
    pairs = [("router", tlayer.router.kernel.grad, jg["router"]["kernel"]),
             ("wi", tlayer.wi.grad, jg["wi"]), ("wo", tlayer.wo.grad,
                                                 jg["wo"]),
             ("x", xt.grad, jgx)]
    if activation == "swiglu":
        pairs.append(("wg", tlayer.wg.grad, jg["wg"]))
    for name, got, want in pairs:
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_grouped_equals_einsum_when_capacity_ample():
    """Mirrors ``tests/test_moe_grouped.py``: with capacity the einsum path
    never fills, both dispatches compute the same function (1e-5)."""
    x = _t(np.random.default_rng(0).normal(size=(2, 16, D)))
    x = x.float()
    _, _, einsum = _layer_pair("einsum", "gelu", capacity_factor=8.0)
    _, _, grouped = _layer_pair("grouped", "gelu", capacity_factor=8.0)
    out_e, aux_e = einsum(x)
    out_g, aux_g = grouped(x)
    torch.testing.assert_close(out_g, out_e, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(aux_g, aux_e, rtol=1e-5, atol=0)


def test_grouped_is_dropless_under_tight_capacity():
    x = _t(np.random.default_rng(1).normal(size=(2, 32, D))).float()
    _, _, ample = _layer_pair("einsum", "gelu", capacity_factor=8.0, seed=1)
    _, _, tight = _layer_pair("einsum", "gelu", capacity_factor=0.25,
                              seed=1)
    _, _, grouped = _layer_pair("grouped", "gelu", capacity_factor=0.25,
                                seed=1)
    want = ample(x)[0]
    torch.testing.assert_close(grouped(x)[0], want, rtol=1e-4, atol=1e-5)
    # The einsum path at that capacity drops choices, and it shows.
    assert (tight(x)[0] - want).abs().max() > 1e-2


def test_moe_layer_refuses_unknown_dispatch():
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        tmoe.MoEMlp(D, E, F_, dispatch="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        TModel(TConfig(**GPT2_MOE, moe_dispatch="nope"), device="cpu")


# -- the MoE model -------------------------------------------------------------------

GPT2_MOE = dict(vocab_size=96, num_layers=2, d_model=64, num_heads=4,
                max_seq_len=48, num_experts=4, top_k=2, d_ff=96)
LLAMA_MOE = dict(vocab_size=96, num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2, d_ff=96, max_seq_len=48)


def _jax_init(jcfg):
    params = nn.meta.unbox(JModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("dispatch", ["einsum", "grouped"])
def test_moe_transformer_logits_and_aux_match_jax(family, dispatch):
    """Two MoE layers: fp32 logits to atol 1e-4 (as the dense models'
    parity), the aux loss to 1e-6 relative."""
    if family == "gpt2":
        kw = dict(GPT2_MOE, moe_dispatch=dispatch)
        jcfg = JConfig(**kw, dtype=jnp.float32)
        tcfg = TConfig(**kw, dtype=torch.float32)
    else:
        kw = dict(LLAMA_MOE, moe_dispatch=dispatch)
        jcfg = jmoe_llama_config("tiny", num_experts=4, dtype=jnp.float32,
                                 **kw)
        tcfg = moe_llama_config("tiny", num_experts=4, dtype=torch.float32,
                                **kw)
    params, params_np = _jax_init(jcfg)
    model = TModel(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params_np, tcfg))
    tokens = np.random.default_rng(7).integers(0, 96, size=(2, 40))
    want, want_aux = JModel(jcfg).apply({"params": params},
                                        jnp.asarray(tokens))
    got, got_aux = model.forward_aux(torch.as_tensor(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    assert float(want_aux) > 0
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-6)


def test_moe_state_dict_from_jax_maps_and_refuses_unknown_keys():
    jcfg = JConfig(**GPT2_MOE, moe_dispatch="grouped")
    tcfg = TConfig(**GPT2_MOE, moe_dispatch="grouped")
    _, params_np = _jax_init(jcfg)
    sd = state_dict_from_jax(params_np, tcfg)
    assert sd["blocks.1.moe.router.kernel"].shape == (64, 4)
    assert sd["blocks.0.moe.wi"].shape == (4, 64, 96)
    assert sd["blocks.0.moe.wo"].shape == (4, 96, 64)
    np.testing.assert_array_equal(sd["blocks.1.moe.wo"].numpy(),
                                  params_np["blocks"]["moe"]["wo"][1])
    assert not any(".mlp." in k for k in sd)
    bad = jax.tree.map(lambda a: a, params_np)
    bad["blocks"]["moe"]["w_extra"] = params_np["blocks"]["moe"]["wi"]
    with pytest.raises(KeyError, match="w_extra"):
        state_dict_from_jax(bad, tcfg)
    missing = jax.tree.map(lambda a: a, params_np)
    del missing["blocks"]["moe"]["wo"]
    with pytest.raises(KeyError, match="moe.wo"):
        state_dict_from_jax(missing, tcfg)


def test_moe_init_params_match_jax_scales():
    """Expert kernels [E, in, out]: flax's lecun_normal counts E as a
    receptive field, fan-in E * in; the router [d, E] has fan-in d."""
    cfg = TConfig(vocab_size=96, num_layers=1, d_model=256, num_heads=4,
                  max_seq_len=48, num_experts=8, d_ff=384)
    jcfg = JConfig(vocab_size=96, num_layers=1, d_model=256, num_heads=4,
                   max_seq_len=48, num_experts=8, d_ff=384)
    _, jparams = _jax_init(jcfg)
    mine = init_params(cfg, seed=0, device="cpu")
    for name, jleaf in (("wi", jparams["blocks"]["moe"]["wi"]),
                        ("wo", jparams["blocks"]["moe"]["wo"]),
                        ("router.kernel",
                         jparams["blocks"]["moe"]["router"]["kernel"])):
        want_std = float(np.std(jleaf))
        got_std = mine[f"blocks.0.moe.{name}"].float().std().item()
        assert abs(got_std - want_std) < 0.05 * want_std, name
    assert abs(float(np.std(jparams["blocks"]["moe"]["wi"]))
               - (8 * 256) ** -0.5) < 0.05 * (8 * 256) ** -0.5


def test_serve_programs_refuse_moe_configs():
    """What is left of the refusal: an MoE config is refused only
    tensor-parallel (an MoE model on the tensor axis, ROADMAP Queue 1 item
    6's remainder), whatever the fold; at tp <= 1 it serves
    (``test_moe_serves_at_tp1``)."""
    cfg = TConfig(**GPT2_MOE, moe_dispatch="grouped")
    with pytest.raises(NotImplementedError, match="item 6's remainder"):
        ServingEngine(cfg, init_params(cfg, device="cpu"), slots=2,
                      buckets=[16], tp=2, device="cpu")


@pytest.mark.parametrize("dispatch", ["einsum", "grouped"])
def test_moe_serves_at_tp1(dispatch):
    """An MoE config serves through the decode-mode model at tp <= 1:
    every request ends with its token count inside the vocab
    (``tests/test_torch_serving.py`` holds the streams to the JAX
    engine's)."""
    cfg = TConfig(**GPT2_MOE, moe_dispatch=dispatch)
    programs = ServePrograms(cfg, slots=2, buckets=[16], device="cpu")
    assert programs.config.decode and programs.config.num_experts == 4
    engine = ServingEngine(cfg, init_params(cfg, seed=1, device="cpu"),
                           slots=2, buckets=[16], tp=1, device="cpu")
    rng = np.random.default_rng(5)
    requests = [Request(f"r{i}", rng.integers(1, 96, size=3 + 4 * i),
                        SamplingParams(temperature=0.0, max_new_tokens=4))
                for i in range(3)]
    results = engine.run(requests)
    for req in requests:
        tokens = results[req.uid].tokens
        assert len(tokens) == 4
        assert ((tokens >= 0) & (tokens < 96)).all()


# -- a 3-step train run against build_sharded_train ----------------------------------

TRAIN_MOE = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
                 max_seq_len=64, num_experts=4, top_k=2, d_ff=64,
                 moe_dispatch="grouped")
BATCH, SEQ = 8, 32
# Loss, aux loss and grad norm in fp32 on one device each side: 1e-5
# relative.  Parameters after 3 Adafactor steps: 3e-5 absolute, as in the
# dense parity (the update divides by a running gradient RMS, turning
# 1e-7 reassociation differences into relative update differences of the
# same size).  Excluded, as there: the key slice of the fused qkv bias,
# whose exact gradient is zero.
TRAIN_RTOL, PARAM_ATOL = 1e-5, 3e-5


def _train_batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TRAIN_MOE["vocab_size"], size=(BATCH, SEQ + 1),
                          dtype=np.int32)
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


@pytest.mark.parametrize("impl,remat", [("xla", "none"),
                                        ("flash", "flash_only")])
def test_moe_train_steps_match_jax_build_sharded_train(impl, remat):
    from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
    from dlrover_tpu_torch.models import gpt2_config

    jcfg = jgpt2_config("124m", **TRAIN_MOE, dtype=jnp.float32,
                        attention_impl=impl, remat=remat)
    mesh = build_mesh(ParallelConfig(), devices=jax.devices()[:1])
    jtrain = jtl.build_sharded_train(
        JModel(jcfg), jtl.make_optimizer("adafactor", learning_rate=1e-2),
        mesh, jrules.DEFAULT_RULES, global_batch_size=BATCH, seq_len=SEQ)
    jstate = jtrain.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate.params)
    jbatch = jtl.shard_batch(_train_batch(), jtrain)
    want = []
    for _ in range(3):
        jstate, m = jtrain.step(jstate, jbatch)
        want.append((float(m["loss"]), float(m["aux_loss"]),
                     float(m["grad_norm"])))

    tcfg = gpt2_config("124m", **TRAIN_MOE, dtype=torch.float32,
                       attention_impl=impl, remat=remat)
    train = ttl.build_train(
        tcfg, ttl.make_optimizer("adafactor", learning_rate=1e-2),
        global_batch_size=BATCH, seq_len=SEQ, device="cpu")
    state = train.init(params=state_dict_from_jax(init, tcfg))
    got = []
    for _ in range(3):
        state, m = train.step(state, _train_batch())
        got.append((m["loss"].item(), m["aux_loss"].item(),
                    m["grad_norm"].item()))
    assert min(a for _, a, _ in got) > 0
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)

    params = state.params()
    hd = tcfg.resolved_head_dim
    for name, w in state_dict_from_jax(jax.tree.map(np.asarray,
                                                    jstate.params),
                                       tcfg).items():
        g = params[name]
        if name.endswith("attn.qkv.bias"):
            keep = torch.ones(w.shape, dtype=torch.bool)
            keep[..., hd:2 * hd] = False
            g, w = g[keep], w[keep]
        torch.testing.assert_close(g, w, rtol=0, atol=PARAM_ATOL, msg=name)


def test_moe_config_runs_through_the_grouped_op_under_flash_only(
        monkeypatch):
    """Under ``flash_only`` the MoE layer is recomputed in the backward:
    per layer the grouped forward (its plain version on the CPU) runs 2
    times in the forward, 2 in the recompute and 2 for dx, and the dw 2
    times: the counts the card's K8 and K9 launches follow."""
    from dlrover_tpu_torch.models import gpt2_config

    calls = {"fwd": 0, "dw": 0}
    fwd, dw = tgm.grouped_matmul_reference, tgm.grouped_matmul_dw_reference

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_dw(*a, **k):
        calls["dw"] += 1
        return dw(*a, **k)

    monkeypatch.setattr(tgm, "grouped_matmul_reference", count_fwd)
    monkeypatch.setattr(tgm, "grouped_matmul_dw_reference", count_dw)
    cfg = gpt2_config("124m", **TRAIN_MOE, dtype=torch.float32,
                      attention_impl="flash", remat="flash_only")
    train = ttl.build_train(cfg, ttl.make_optimizer("adafactor"),
                            global_batch_size=BATCH, seq_len=SEQ,
                            device="cpu")
    state = train.init(seed=0)
    state, metrics = train.step(state, _train_batch())
    assert np.isfinite(metrics["loss"].item())
    assert calls == {"fwd": 6 * cfg.num_layers, "dw": 2 * cfg.num_layers}

"""Port parity: ``dlrover_tpu_torch.models`` against the JAX ``TransformerLM``.

Parameters come from a JAX init, go through ``state_dict_from_jax`` and
load into the port; the same numpy tokens go through both.  fp32 logits
agree to atol 1e-4 (two layers of fp32 matmuls summed in different
orders).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models.transformer import TransformerConfig as JConfig
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu_torch.models import gpt2_config, llama_config
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import TransformerConfig as TConfig
from dlrover_tpu_torch.models.transformer import TransformerLM as TModel
from dlrover_tpu_torch.models.transformer import init_params, param_shapes

GPT2 = dict(
    vocab_size=96, num_layers=2, d_model=64, num_heads=4, max_seq_len=48,
)
LLAMA = dict(
    vocab_size=96, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, max_seq_len=48, position="rope", norm="rmsnorm",
    activation="swiglu", use_bias=False, tie_embeddings=False,
)
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


# JAX inits memoized per parameter tree: dtype, attention impl and logit
# scale leave the tree unchanged (params stay fp32 in the JAX model).
_INITS = {}


def _jax_params(kw, fused_qkv=True):
    key = (tuple(sorted(kw.items())), fused_qkv)
    if key not in _INITS:
        cfg = JConfig(**kw, fused_qkv=fused_qkv)
        params = nn.meta.unbox(JModel(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)
        )["params"])
        _INITS[key] = (params, jax.tree.map(np.asarray, params))
    return _INITS[key]


def _pair(kw, dtype="fp32", **extra):
    jcfg = JConfig(**kw, dtype=JDT[dtype], **extra)
    tcfg = TConfig(**kw, dtype=TDT[dtype], **extra)
    params, params_np = _jax_params(kw, extra.get("fused_qkv", True))
    model = TModel(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params_np, tcfg))
    return jcfg, params, model, params_np


def _logits(kw, tokens, dtype="fp32", segment_ids=None, **extra):
    jcfg, params, model, _ = _pair(kw, dtype, **extra)
    want = JModel(jcfg).apply(
        {"params": params}, jnp.asarray(tokens),
        segment_ids=None if segment_ids is None else jnp.asarray(
            segment_ids),
    )[0]
    got = model(
        torch.as_tensor(tokens),
        segment_ids=None if segment_ids is None else torch.as_tensor(
            segment_ids),
    )
    return got.detach().float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize(
    "name,kw,impl,logit_scale",
    [
        ("gpt2", GPT2, "xla", 1.0),
        ("gpt2", GPT2, "flash", 1.0),
        ("llama", LLAMA, "xla", 1.0),
        ("llama", LLAMA, "flash", 0.5),   # with the µP logit multiplier
    ],
)
def test_logits_match_jax_fp32(rng, name, kw, impl, logit_scale):
    tokens = rng.integers(0, 96, size=(2, 40))
    got, want = _logits(kw, tokens, attention_impl=impl,
                        logit_scale=logit_scale)
    assert got.dtype == np.float32 and got.shape == (2, 40, 96)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_logits_match_jax_with_segments(rng):
    tokens = rng.integers(0, 96, size=(2, 40))
    seg = (np.arange(40) // 13)[None].repeat(2, 0).astype(np.int32)
    got, want = _logits(GPT2, tokens, segment_ids=seg,
                        attention_impl="flash")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_logits_match_jax_bf16(rng):
    """bf16 compute: the two frameworks round to bf16 at different points
    (XLA fuses elementwise chains in fp32, eager PyTorch rounds after each
    op), so the logits agree to a few bf16 ulps of their magnitude, not to
    fp32 precision: atol 0.1 on logits of scale ~1, plus argmax agreement
    on nearly every position."""
    tokens = rng.integers(0, 96, size=(2, 40))
    got, want = _logits(GPT2, tokens, dtype="bf16", attention_impl="flash")
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.9, agree


def test_unfused_qkv_without_gqa_matches_jax(rng):
    tokens = rng.integers(0, 96, size=(1, 20))
    got, want = _logits(GPT2, tokens, fused_qkv=False)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_from_jax_rejects_unknown_and_missing_keys():
    _, _, _, params_np = _pair(GPT2)
    cfg = TConfig(**GPT2, dtype=torch.float32)
    extra = dict(params_np, surprise={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="surprise"):
        state_dict_from_jax(extra, cfg)
    missing = {k: v for k, v in params_np.items() if k != "ln_final"}
    with pytest.raises(KeyError, match="ln_final"):
        state_dict_from_jax(missing, cfg)
    deeper = dataclasses.replace(cfg, num_layers=3)
    with pytest.raises(ValueError, match="num_layers"):
        state_dict_from_jax(params_np, deeper)


def test_init_params_has_the_from_jax_names_and_shapes():
    for kw in (GPT2, LLAMA):
        cfg = TConfig(**kw, dtype=torch.float32)
        _, _, _, params_np = _pair(kw)
        converted = state_dict_from_jax(params_np, cfg)
        mine = init_params(cfg, seed=0, device="cpu")
        assert {k: tuple(v.shape) for k, v in mine.items()} == {
            k: tuple(v.shape) for k, v in converted.items()
        } == param_shapes(cfg)


def test_init_params_is_seeded_and_scaled():
    cfg = TConfig(**GPT2)
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    assert not torch.equal(a["embed.embedding"], c["embed.embedding"])
    # Every parameter in param_dtype: fp32 by default, as in JAX.
    assert a["blocks.0.attn.qkv.kernel"].dtype == torch.float32
    assert a["blocks.0.ln_attn.scale"].dtype == torch.float32
    bf16 = init_params(dataclasses.replace(cfg, param_dtype=torch.bfloat16),
                       seed=3, device="cpu")
    assert bf16["blocks.0.attn.qkv.kernel"].dtype == torch.bfloat16
    assert bf16["blocks.0.ln_attn.scale"].dtype == torch.bfloat16
    std = a["blocks.0.mlp.wi.kernel"].float().std().item()
    assert abs(std - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert abs(a["embed.embedding"].float().std().item() - 0.02) < 2e-3


def test_learned_positions_reject_overlong_input():
    cfg = TConfig(**GPT2, dtype=torch.float32)
    model = TModel(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        model(torch.zeros((1, 49), dtype=torch.long))


@pytest.mark.parametrize(
    "field,value",
    [("remat", "dots"), ("pipeline_stages", 2),
     ("attention_impl", "ring"), ("remat", "offload")],
)
def test_later_slice_features_raise(field, value):
    with pytest.raises(NotImplementedError, match="later slice"):
        TConfig(**GPT2, **{field: value})


def test_presets_match_the_reference_shapes():
    cfg = gpt2_config("1.5b", attention_impl="flash")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads) == (48, 1600, 25)
    assert cfg.resolved_head_dim == 64 and cfg.vocab_size == 50304
    assert cfg.tie_embeddings and cfg.dtype == torch.bfloat16
    assert cfg.logits_dtype == torch.float32
    llama = llama_config("70b")
    assert (llama.resolved_kv_heads, llama.resolved_head_dim) == (8, 128)
    assert llama_config("tiny").resolved_d_ff == 688
    assert TConfig(d_model=256, activation="swiglu").resolved_d_ff == 768
    with pytest.raises(ValueError):
        gpt2_config("2b")


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig(**GPT2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)

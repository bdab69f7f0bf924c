"""Llama-2 family presets, plus a Mixtral-style MoE variant (port of
``dlrover_tpu/models/llama.py``)."""

from __future__ import annotations

from dlrover_tpu_torch.models.transformer import TransformerConfig

_LLAMA2_SIZES = {
    # name: (num_layers, d_model, num_heads, num_kv_heads, d_ff)
    "tiny": (4, 256, 8, 8, 688),            # test-scale
    "7b": (32, 4096, 32, 32, 11008),
    "13b": (40, 5120, 40, 40, 13824),
    "70b": (80, 8192, 64, 8, 28672),
}


def llama_config(size: str = "7b", **overrides) -> TransformerConfig:
    if size not in _LLAMA2_SIZES:
        raise ValueError(f"unknown llama size {size!r}; one of {list(_LLAMA2_SIZES)}")
    layers, d_model, heads, kv_heads, d_ff = _LLAMA2_SIZES[size]
    defaults = dict(
        vocab_size=32000,
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv_heads,
        d_ff=d_ff,
        max_seq_len=4096,
        position="rope",
        norm="rmsnorm",
        activation="swiglu",
        use_bias=False,
        tie_embeddings=False,
    )
    defaults.update(overrides)
    return TransformerConfig(**defaults)


def moe_llama_config(size: str = "tiny", num_experts: int = 8,
                     **overrides) -> TransformerConfig:
    """Mixtral-style sparse variant of a llama config (swiglu experts)."""
    return llama_config(size, num_experts=num_experts, **overrides)

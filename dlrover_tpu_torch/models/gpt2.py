"""GPT-2 family presets (port of ``dlrover_tpu/models/gpt2.py``).

GPT-2 1.5B ("1.5b": 48 layers, d_model 1600, 25 heads of head_dim 64) is
the model the serving slice runs on the card (``chip_smoke.py``).
"""

from __future__ import annotations

from dlrover_tpu_torch.models.transformer import TransformerConfig

_GPT2_SIZES = {
    # name: (num_layers, d_model, num_heads)
    "124m": (12, 768, 12),
    "355m": (24, 1024, 16),
    "774m": (36, 1280, 20),
    "1.5b": (48, 1600, 25),
}


def gpt2_config(size: str = "124m", **overrides) -> TransformerConfig:
    if size not in _GPT2_SIZES:
        raise ValueError(f"unknown GPT-2 size {size!r}; one of {list(_GPT2_SIZES)}")
    layers, d_model, heads = _GPT2_SIZES[size]
    defaults = dict(
        vocab_size=50304,        # 50257 padded to a multiple of 128
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        max_seq_len=1024,
        position="learned",
        norm="layernorm",
        activation="gelu",
        use_bias=True,
        tie_embeddings=True,
    )
    defaults.update(overrides)
    return TransformerConfig(**defaults)

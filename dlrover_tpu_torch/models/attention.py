"""Multi-head attention (port of ``dlrover_tpu/models/attention.py``).

``attention_impl`` picks the math: ``"xla"`` is the plain einsum softmax
(:func:`xla_attention`), ``"flash"`` flash attention
(``ops/flash_attention.mha``: the CUDA kernels on the card, forward and
backward, with ``flash_block_q/kv`` passed through as the JAX module does).

Decode mode (``caches`` given) keeps K/V in explicit per-layer tensors
``[B, max_seq_len, H_kv, hd]`` that the caller owns; each row's chunk is
written in place at that row's own ``positions[r, 0]``.  A chunk of at
least 16 tokens under ``"flash"`` is a bucketed prompt prefill at position
0, so causal flash over the fresh chunk equals attention over the written
cache prefix; narrower chunks (single-token decode) take
:func:`cached_attention` over the whole cache.

Sequence parallelism (Ulysses) and ring attention are later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dlrover_tpu_torch.models import layers
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.runtime.device import DeviceLike

NEG_INF = -1e15
#: Decode chunks at least this wide take the flash kernel (prefill).
FLASH_PREFILL_MIN = 16

KVCache = Tuple[torch.Tensor, torch.Tensor]


def _softmax_attend(q, k, v, mask) -> torch.Tensor:
    """Grouped-q einsum attention with an fp32 softmax.  ``mask``
    broadcasts against ``[B, H_kv, group, Sq, Sk]``."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    # fp32 scores from the working-dtype inputs: the JAX einsum's
    # preferred_element_type=float32.
    logits = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.float(), k.float()
    ) * d ** -0.5
    if mask is not None:
        logits = torch.where(
            mask, logits, torch.full_like(logits, NEG_INF)
        )
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention on ``[B, S, H, D]``; GQA and packed-sequence
    masks."""
    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = (qpos >= kpos)[None, None, None]
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        seg = seg[:, None, None, :, :]
        mask = seg if mask is None else mask & seg
    return _softmax_attend(q, k, v, mask)


def cached_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
) -> torch.Tensor:
    """Decode attention: queries at absolute ``q_positions`` [B, T] against
    the whole cache [B, L, H_kv, D]; cache slots past a query's position
    are masked."""
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, None, None, None, :] <= (
        q_positions[:, None, None, :, None]
    )
    return _softmax_attend(q, k, v, mask)


def write_cache(cache: torch.Tensor, new: torch.Tensor,
                row_start: torch.Tensor) -> None:
    """In place: ``cache[r, row_start[r] : row_start[r] + t] = new[r]``.
    The start clamps so the chunk fits, as ``dynamic_update_slice``
    does."""
    b, t = new.shape[0], new.shape[1]
    start = row_start.clamp(0, cache.shape[1] - t)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(t, device=cache.device)[None, :]
    cache[rows, cols] = new.to(cache.dtype)


class Attention(nn.Module):
    """Self-attention with fused or separate q/k/v projections, RoPE and
    GQA.  Parameter names follow the JAX module: ``qkv`` (``[d, H, 3*hd]``,
    per head ``[q | k | v]`` on the last axis) when ``fused_qkv`` and no
    GQA, else ``query``/``key``/``value``; ``out`` is ``[H, hd, d]``."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        num_kv_heads: int,
        head_dim: int,
        *,
        use_rope: bool = True,
        rope_theta: float = 10000.0,
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        attention_impl: str = "xla",
        fused_qkv: bool = True,
        flash_block_q: int = 512,
        flash_block_kv: int = 512,
        device: DeviceLike = None,
    ):
        super().__init__()
        if attention_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.flash_blocks = dict(block_q=flash_block_q,
                                 block_kv=flash_block_kv)
        self.fused = fused_qkv and num_kv_heads == num_heads
        dense = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                     device=device)
        if self.fused:
            self.qkv = layers.DenseGeneral(
                d_model, (num_heads, 3 * head_dim), **dense
            )
        else:
            self.query = layers.DenseGeneral(
                d_model, (num_heads, head_dim), **dense
            )
            self.key = layers.DenseGeneral(
                d_model, (num_kv_heads, head_dim), **dense
            )
            self.value = layers.DenseGeneral(
                d_model, (num_kv_heads, head_dim), **dense
            )
        self.out = layers.DenseGeneral(
            (num_heads, head_dim), d_model, **dense
        )

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        segment_ids: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
    ) -> torch.Tensor:
        hd = self.head_dim
        if self.fused:
            qkv = self.qkv(x)
            # Strided views, no copy: the flash kernel reads them as is.
            q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        else:
            q, k, v = self.query(x), self.key(x), self.value(x)
        if self.use_rope:
            q, k = layers.rotary_embedding(q, k, positions, self.rope_theta)

        if cache is not None:
            b, t = x.shape[0], x.shape[1]
            cached_k, cached_v = cache
            q_positions = positions.expand(b, t)
            write_cache(cached_k, k, q_positions[:, 0])
            write_cache(cached_v, v, q_positions[:, 0])
            if self.attention_impl == "flash" and t >= FLASH_PREFILL_MIN:
                out = fa.mha(
                    q, k.to(self.dtype), v.to(self.dtype), causal=True,
                    **self.flash_blocks,
                )
            else:
                out = cached_attention(q, cached_k, cached_v, q_positions)
        elif self.attention_impl == "flash":
            out = fa.mha(q, k, v, causal=True, segment_ids=segment_ids,
                         **self.flash_blocks)
        else:
            out = xla_attention(
                q, k, v, causal=True, segment_ids=segment_ids
            )
        return self.out(out)

"""Multi-head attention (port of ``dlrover_tpu/models/attention.py``).

``attention_impl`` picks the math: ``"xla"`` is the plain einsum softmax
(:func:`xla_attention`), ``"flash"`` flash attention
(``ops/flash_attention.mha``: the CUDA kernels on the card, forward and
backward, with ``flash_block_q/kv`` passed through as the JAX module does),
``"ring"`` ring attention (``parallel/ring_attention.py``: the sequence
stays split over the seq axis and K/V hop around its ring; a ring of one
without a seq axis).

Decode mode (``caches`` given) keeps K/V in explicit per-layer tensors
``[B, max_seq_len, H_kv, hd]`` that the caller owns; each row's chunk is
written in place at that row's own ``positions[r, 0]``.  A chunk of at
least 16 tokens under ``"flash"`` is a bucketed prompt prefill at position
0, so causal flash over the fresh chunk equals attention over the written
cache prefix; narrower chunks (single-token decode) take
:func:`cached_attention` over the whole cache.

Under a tensor axis (``tp``, ``parallel/sharding.TensorGroup``) the
module holds its rank's heads: ``num_heads / size`` query heads and
``num_kv_heads / size`` KV heads (the KV heads must divide by the
degree), the q/k/v projections column-parallel behind ``tp.enter`` and
``out`` row-parallel, summed over the group before its bias.

Under a seq axis (``sp``, ``parallel/sharding.SeqGroup``) the module
sees its rank's slice of the sequence, ``[B, S / sp, H, D]``, and
:func:`ulysses_attention` runs the attention math on the whole sequence
over ``H / sp`` of its heads (``H / (sp * tensor)`` with a tensor axis),
swapping one split for the other with two all-to-alls; under
``attention_impl="ring"`` the module runs
``parallel/ring_attention.ring_attention`` on its slice instead.  Decode
mode takes no ring (the config refuses it, as the reference's does).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from dlrover_tpu_torch.models import layers
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import remat_policy
from dlrover_tpu_torch.parallel import quantized_collectives as qc
from dlrover_tpu_torch.parallel import rules as lr
from dlrover_tpu_torch.parallel.ring_attention import ring_attention
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
    # preferred_element_type=float32.  Both products are remat sites,
    # dots with batch dimensions (ops/remat_policy.einsum).
    logits = remat_policy.einsum(
        "bqhgd,bkhd->bhgqk", qg.float(), k.float()
    ) * d ** -0.5
    if mask is not None:
        logits = torch.where(
            mask, logits, torch.full_like(logits, NEG_INF)
        )
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = remat_policy.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)


def ulysses_attention(
    attn_fn: Callable,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    group,
) -> torch.Tensor:
    """``attn_fn(q, k, v, segment_ids)`` under Ulysses' all-to-alls over
    the seq group ``group`` (``parallel/sharding.SeqGroup``).  The inputs
    arrive sequence-split, ``[B, S / sp, H, D]``; an all-to-all each
    (``quantized_collectives.all_to_all``: split the heads, concatenate
    the sequence) makes them head-split ``[B, S, H / sp, D]`` for the
    attention math, and the inverse exchange brings the output back to
    ``[B, S / sp, H, D]``.  The backward is the inverse exchange of each
    leg.  Segment ids ``[B, S / sp]`` are gathered whole (the reference's
    ``P(batch, None)`` spec).  The heads split contiguously, so with GQA a
    rank's query heads are the groups of its KV heads."""
    def swap(t):
        return qc.all_to_all(t, group.wire, split_axis=2, concat_axis=1)

    seg = None if segment_ids is None else group.gather_tokens(segment_ids)
    out = attn_fn(swap(q), swap(k), swap(v), seg)
    return qc.all_to_all(out, group.wire, split_axis=1, concat_axis=2)


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
    GQA, else ``query``/``key``/``value``; ``out`` is ``[H, hd, d]``.
    The projections' outputs are the remat site ``qkv_proj``, the output
    projection's ``attn_out``."""

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
        tp=None,
        sp=None,
        device: DeviceLike = None,
    ):
        super().__init__()
        if attention_impl not in ("xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        self.tp = tp
        self.sp = sp
        self.fused = fused_qkv and num_kv_heads == num_heads
        if tp is not None:
            if num_heads % tp.size or num_kv_heads % tp.size:
                raise ValueError(
                    f"{num_heads} heads and {num_kv_heads} KV heads must "
                    f"divide by the tensor degree {tp.size}")
            num_heads //= tp.size
            num_kv_heads //= tp.size
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.flash_blocks = dict(block_q=flash_block_q,
                                 block_kv=flash_block_kv)
        dense = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                     device=device)
        qkv_axes = (lr.EMBED, lr.HEADS, lr.KV)
        # The remat sites: the projections "qkv_proj", the output
        # projection "attn_out" (the reference names the block's branch
        # output, which is this product).
        proj = dict(kernel_axes=qkv_axes, save_name="qkv_proj", **dense)
        if self.fused:
            self.qkv = layers.DenseGeneral(
                d_model, (num_heads, 3 * head_dim), **proj)
        else:
            self.query = layers.DenseGeneral(
                d_model, (num_heads, head_dim), **proj)
            self.key = layers.DenseGeneral(
                d_model, (num_kv_heads, head_dim), **proj)
            self.value = layers.DenseGeneral(
                d_model, (num_kv_heads, head_dim), **proj)
        self.out = layers.DenseGeneral(
            (num_heads, head_dim), d_model,
            kernel_axes=(lr.HEADS, lr.KV, lr.EMBED),
            reduce=tp.exit if tp is not None else None,
            save_name="attn_out", **dense
        )

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        segment_ids: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
    ) -> torch.Tensor:
        hd = self.head_dim
        if self.tp is not None:
            x = self.tp.enter(x)
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
        elif self.attention_impl == "ring":
            # The sequence stays split; K/V stream around the seq ring.
            out = ring_attention(q, k, v, causal=True,
                                 segment_ids=segment_ids, group=self.sp)
        elif self.sp is not None:
            out = ulysses_attention(self._attend, q, k, v, segment_ids,
                                    self.sp)
        else:
            out = self._attend(q, k, v, segment_ids)
        return self.out(out)

    def _attend(self, q, k, v, segment_ids):
        if self.attention_impl == "flash":
            return fa.mha(q, k, v, causal=True, segment_ids=segment_ids,
                          **self.flash_blocks)
        return xla_attention(q, k, v, causal=True, segment_ids=segment_ids)

"""Flash-attention forward (port of ``dlrover_tpu/ops/flash_attention.py``).

``mha`` computes causal or full attention on ``[B, S, H, D]`` tensors with
an optional segment mask and GQA, the JAX ``mha``'s function.  On a CUDA
tensor it launches the hand-written Hopper kernel
``ops/csrc/flash_attention.cu`` (bf16, ``D`` in {64, 128}) or raises; on a
CPU tensor it takes :func:`mha_reference`, the plain fp32 version that the
CPU tests use and that ``chip_smoke.py`` holds the kernel against.

Nothing of the Pallas wrapper's TPU tiling carries over: the kernel reads
the strided views directly and masks the ragged sequence edge itself, so
there is no transpose to ``[B, H, S, D]`` and no padding to a block
multiple.  ``block_q``/``block_kv`` are accepted for signature parity and
ignored.

Only the forward is ported (serving); the training slice adds the backward
kernels and autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dlrover_tpu_torch.ops import kernel_lib

NEG_INF = -1e30
HEAD_DIMS = (64, 128)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    seg_q: Optional[torch.Tensor] = None,
    seg_kv: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 attention: ``(o [B, Sq, Hq, D] in q's dtype, lse
    [B, Hq, Sq] fp32)``.  Masked scores are ``-1e30`` as in the kernel; a
    fully masked row gives ``o = 0`` and ``lse = -1e30``."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    q32 = q.float().reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32, k.float()) * scale
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    mask = mask[None, None, None]
    if seg_q is not None:
        seg = seg_q[:, :, None] == seg_kv[:, None, :]
        mask = mask & seg[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    live = m > NEG_INF
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / safe_l, v.float())
    lse = torch.where(
        l == 0.0, torch.full_like(l, NEG_INF), m + torch.log(safe_l)
    )
    return (
        o.reshape(b, sq, hq, d).to(q.dtype),
        lse[..., 0].reshape(b, hq, sq),
    )


def _lib():
    lib = kernel_lib.load("flash_attention")
    fn = lib.flash_fwd_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [p] * 7 + [i] * 6 + [ll] * 11 + [ctypes.c_float, i, p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel takes bf16 {name}, got {x.dtype}")
    if x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(
            f"{name} must be [B, S, H, D] with unit stride on D, got shape "
            f"{tuple(x.shape)} strides {x.stride()}"
        )
    # 16-byte vector loads: base and every row/head/batch stride aligned
    # (a size-1 dimension's stride is never used).
    if x.data_ptr() % 16 or any(
            st % 8 for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1):
        raise ValueError(
            f"{name} must be 16-byte aligned with strides that are "
            f"multiples of 8 elements, got strides {x.stride()}"
        )


def _seg(seg: Optional[torch.Tensor], b: int, s: int,
         device: torch.device) -> Tuple[Optional[torch.Tensor], int]:
    if seg is None:
        return None, 0
    if tuple(seg.shape) != (b, s) or seg.device != device:
        raise ValueError(
            f"segment ids must be [B={b}, S={s}] on {device}, got "
            f"{tuple(seg.shape)} on {seg.device}"
        )
    seg = seg.to(torch.int32).contiguous()
    return seg, seg.stride(0)


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    seg_q: Optional[torch.Tensor] = None,
    seg_kv: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(o, lse)`` of attention over ``[B, S, H, D]`` q/k/v; ``seg_q``
    [B, Sq] and ``seg_kv`` [B, Skv] mask pairs whose ids differ.

    CPU tensors take :func:`mha_reference`; CUDA tensors launch the
    kernel (counted in ``mha.launches``) or raise.
    """
    if (seg_q is None) != (seg_kv is None):
        raise ValueError("seg_q and seg_kv must be given together")
    if q.device.type == "cpu":
        return mha_reference(
            q, k, v, causal=causal, seg_q=seg_q, seg_kv=seg_kv, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash attention has no kernel for {q.device}")
    device = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, device)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(
            k.shape):
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}"
        )
    if hkv < 1 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if sq < 1 or skv < 1:
        raise ValueError("empty sequence")
    seg_q, segq_sb = _seg(seg_q, b, sq, device)
    seg_kv, segkv_sb = _seg(seg_kv, b, skv, device)
    scale = d ** -0.5 if scale is None else float(scale)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=device)
    lse = (
        torch.empty((b, hq, sq), dtype=torch.float32, device=device)
        if return_lse else None
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr() if seg_q is not None else None,
            seg_kv.data_ptr() if seg_kv is not None else None,
            o.data_ptr(), lse.data_ptr() if lse is not None else None,
            b, sq, skv, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            segq_sb, segkv_sb, scale, int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: CUDA error {err}")
    mha.launches += 1
    return o, lse


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_kv: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention on ``[B, S, H, D]`` tensors (the layout of
    ``models/attention``).  ``segment_ids`` [B, S] restricts token i to
    tokens j of the same segment (and j <= i when causal).
    ``block_q``/``block_kv`` are TPU tiling and are ignored."""
    del block_q, block_kv
    o, _ = flash_fwd(
        q, k, v, causal=causal, seg_q=segment_ids, seg_kv=segment_ids,
        scale=scale, return_lse=False,
    )
    return o


#: Kernel launches made through :func:`mha` / :func:`flash_fwd`; a run sets
#: it to 0 and reads it back to show its path went through the kernel.
mha.launches = 0

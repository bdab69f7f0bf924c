"""Flash attention, forward and backward (port of
``dlrover_tpu/ops/flash_attention.py``).

``mha`` computes causal or full attention on ``[B, S, H, D]`` tensors with
an optional segment mask and GQA, the JAX ``mha``'s function, and is
differentiable on every device.  On a CUDA tensor the forward launches the
hand-written Hopper kernel ``ops/csrc/flash_attention.cu`` and the backward
launches the kernels of ``ops/csrc/flash_attention_bwd.cu`` (bf16, ``D`` in
{64, 128}), or they raise; on a CPU tensor they take :func:`mha_reference`
and :func:`mha_backward_reference`, the plain fp32 versions that the CPU
tests use and that ``chip_smoke.py`` holds the kernels against.

Autograd: the forward is the custom op ``dlrover_tpu_torch::flash_fwd``
returning ``(o, lse)``; its registered backward saves ``(q, k, v, o,
lse)`` and computes ``(dq, dk, dv)`` from them, as the JAX
``custom_vjp`` does.  Being an op, the forward is visible to selective
activation checkpointing, so the ``flash_only`` remat policy
(``ops/remat_policy.py``) can save its outputs instead of re-running it.

Which backward runs follows the JAX dispatch (``_flash_core_bwd``): the
fused one-pass kernel when the clamped ``block_kv`` covers the whole kv
extent, the split dq / dkv pair otherwise.  Nothing else of the Pallas
wrapper's TPU tiling carries over: the kernels read the strided views
directly and mask the ragged sequence edge themselves, so there is no
transpose to ``[B, H, S, D]`` and no padding to a block multiple.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dlrover_tpu_torch.ops import kernel_lib

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
#: Rows of one warpgroup's q or kv tile in the kernels: the (q, kv) blocks
#: inside which they apply the causal mask are ``MASK_TILE`` square, so a
#: kernel that mishandled its diagonal would lose whole such blocks (what
#: ``chip_smoke.diagonal_tiles`` plants).
MASK_TILE = 64

#: Kernel launches of the forward (K1, :func:`flash_fwd`) and of each
#: backward wrapper (K3, K2a, K2b); a run sets them to 0 and reads them back
#: to show its path went through the kernels.  A dict, not attributes of
#: the wrappers, so a check that swaps a wrapper out still counts the
#: kernel it calls (``ops/grouped_matmul.LAUNCHES`` likewise).
LAUNCHES = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}


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
    hkv = k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    q32 = q.float().reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32, k.float()) * scale
    mask = _mask(q, k, causal, seg_q, seg_kv)
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


def _mask(q, k, causal, seg_q, seg_kv) -> torch.Tensor:
    """Live (q, kv) pairs, broadcastable to ``[B, Hkv, group, Sq, Skv]``."""
    sq, skv = q.shape[1], k.shape[1]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    mask = mask[None, None, None]
    if seg_q is not None:
        seg = seg_q[:, :, None] == seg_kv[:, None, :]
        mask = mask & seg[:, None, None]
    return mask


def delta_reference(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's pre-pass: ``delta = rowsum(o * do)`` in fp32,
    ``[B, Hq, Sq]`` from ``[B, Sq, Hq, D]`` inputs."""
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1)


def _backward_p_ds(q, k, v, o, lse, do, causal, seg_q, seg_kv, scale):
    """``p`` and ``ds`` ``[B, Hkv, group, Sq, Skv]`` in fp32, and the fp32
    operands of the products that follow (q and do split by kv group)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    q32 = q.float().reshape(b, sq, hkv, group, d)
    do32 = do.float().reshape(b, sq, hkv, group, d)
    k32, v32 = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32, k32) * scale
    lse5 = lse.float().reshape(b, hkv, group, sq)[..., None]
    mask = _mask(q, k, causal, seg_q, seg_kv)
    p = torch.where(mask, torch.exp(s - lse5), torch.zeros_like(s))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do32, v32)
    delta = delta_reference(o, do).reshape(b, hkv, group, sq)[..., None]
    ds = p * (dp - delta) * scale
    return p, ds, q32, k32, do32


def mha_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    seg_q: Optional[torch.Tensor] = None,
    seg_kv: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain fp32 backward from the forward's ``o`` and ``lse``:
    ``(dq, dk, dv)`` in the dtypes of ``q``, ``k``, ``v``.

    The JAX kernels' block math (``_recompute_p_ds``) over the whole
    sequence: ``p = mask ? exp(s - lse) : 0`` with ``s = q k^T * scale``,
    ``delta = rowsum(o * do)``, ``ds = p * (do v^T - delta) * scale``;
    then ``dq = ds k``, ``dk = ds^T q``, ``dv = p^T do``, dk/dv summed over
    each kv head's group of q heads.  The mask gates ``p``, never the value
    of ``s``: a fully masked row (``lse = -1e30``) gives exactly zero.
    """
    p, ds, q32, k32, do32 = _backward_p_ds(q, k, v, o, lse, do, causal,
                                           seg_q, seg_kv, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k32).reshape(q.shape)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q32)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_backward_dq_reference(q, k, v, o, lse, do, *, causal=True,
                              seg_q=None, seg_kv=None, scale=None):
    """The dq of :func:`mha_backward_reference` alone (the plain version
    of :func:`flash_bwd_dq`)."""
    _, ds, _, k32, _ = _backward_p_ds(q, k, v, o, lse, do, causal, seg_q,
                                      seg_kv, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k32)
    return dq.reshape(q.shape).to(q.dtype)


def mha_backward_dkv_reference(q, k, v, o, lse, do, *, causal=True,
                               seg_q=None, seg_kv=None, scale=None):
    """The ``(dk, dv)`` of :func:`mha_backward_reference` alone (the plain
    version of :func:`flash_bwd_dkv`)."""
    p, ds, q32, _, do32 = _backward_p_ds(q, k, v, o, lse, do, causal, seg_q,
                                         seg_kv, scale)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q32)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do32)
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels -----------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q k v seg_q seg_kv o lse | B Sq Skv Hq Hkv D | strides | scale causal
# block_m stream
_FWD_ARGTYPES = (
    [_P] * 7 + [_I] * 6 + [_LL] * 11 + [ctypes.c_float, _I, _I, _P]
)
# kind | q k v o do lse seg_q seg_kv dq dk dv | B Sq Skv Hq Hkv D | batch,
# row and head strides of q k v o do, seg strides | scale causal | ws
# sq_pad block_kv stages | stream
_BWD_ARGTYPES = (
    [_I] + [_P] * 11 + [_I] * 6 + [_LL] * 17 + [ctypes.c_float, _I]
    + [_P, _I, _I, _I, _P]
)
_BWD_KINDS = {"flash_bwd_dq": 0, "flash_bwd_dkv": 1, "flash_bwd_fused": 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_launch_plan(b: int, sq: int, hq: int, d: int,
                    num_sms: int = kernel_lib.H100_SMS) -> dict:
    """How K1 is launched for q ``[b, sq, hq, d]``: ``block_m`` q rows per
    block (128, two warpgroups, where B * H * ceil(S / 128) blocks fill the
    card's ``num_sms`` SMs; 64, one warpgroup, where they would leave SMs
    idle), the grid ``(b * hq, q tiles)`` (under causal masking the kernel
    takes the q tiles last first) and the TMA boxes ``(columns, heads,
    rows, batches)``: 64 columns each, ``d // 64`` boxes per row."""
    block_m = 2 * MASK_TILE
    if b * hq * _cdiv(sq, block_m) < num_sms:
        block_m = MASK_TILE
    return dict(
        block_m=block_m, grid=(b * hq, _cdiv(sq, block_m)),
        q_box=(64, 1, block_m, 1), kv_box=(64, 1, MASK_TILE, 1),
        boxes_per_row=d // 64,
    )


#: Stages of the (q, do) ring of the kv-tile kernels: K2b's takes the
#: room that K3 gives its dS^T tiles.
BWD_STAGES = {"fused": 3, "dkv": 4}


def bwd_launch_plan(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                    kind: str = "fused") -> dict:
    """How the backward's kv-tile kernels are launched: K3 (``kind``
    ``"fused"``) or K2b (``"dkv"``), the same kernel without dq.
    ``block_kv`` kv rows per block: K3's 128, two warpgroups, at D 64 and
    64 at D 128, where one warpgroup's dk and dv accumulators already take
    128 registers a thread; K2b's 64, one warpgroup, ``blocks_per_sm`` of
    them an SM at D 64 (the registers its build allows).  The grid
    ``(b * hkv, kv tiles)``, the TMA boxes of the streamed (q, do) tiles
    and of the resident (k, v) tiles, the ``stages`` of the (q, do) ring
    (:data:`BWD_STAGES`), ``sq_pad`` (the lse / delta rows' length, sq
    rounded up to a tile), the pre-pass grid (``d // 8`` threads a row,
    256 a block) and the ``workspace`` the wrapper allocates, fp32 shapes
    by name: the pre-pass's lse and delta rows, and K3's dq
    accumulator."""
    if kind not in ("fused", "dkv"):
        raise ValueError(f"no kv-tile backward kernel of kind {kind!r}")
    wide = kind == "fused" and d == 64
    block_kv = 2 * MASK_TILE if wide else MASK_TILE
    sq_pad = _cdiv(sq, MASK_TILE) * MASK_TILE
    rows_per_block = 256 // (d // 8)
    workspace = {"rows": (2, b, hq, sq_pad)}
    if kind == "fused":
        workspace["dq_acc"] = (b, sq, hq, d)
    return dict(
        kind=kind, block_kv=block_kv, grid=(b * hkv, _cdiv(skv, block_kv)),
        q_box=(64, 1, MASK_TILE, 1),
        kv_box=(64, 1, block_kv, 1), boxes_per_row=d // 64,
        stages=BWD_STAGES[kind],
        blocks_per_sm=2 if kind == "dkv" and d == 64 else 1, sq_pad=sq_pad,
        prep_grid=_cdiv(b * sq_pad * hq, rows_per_block),
        workspace=workspace,
    )


def _lib_fn(lib_name: str, fn_name: str, argtypes):
    fn = getattr(kernel_lib.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _aligned(x: torch.Tensor) -> bool:
    """Unit stride on D, 16-byte aligned base, and every used batch, row
    and head stride a multiple of 8 elements (16-byte vector loads; a
    size-1 dimension's stride is never used)."""
    return (
        x.dim() == 4 and x.stride(-1) == 1 and x.data_ptr() % 16 == 0
        and all(st % 8 == 0 for st, n in zip(x.stride()[:3], x.shape[:3])
                if n > 1)
    )


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
    if not _aligned(x):
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


def _check_qkv(q, k, v) -> torch.device:
    """Device, dtype, layout and shape checks shared by the forward and
    backward kernels; returns the device."""
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
    return device


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
    [B, Sq] and ``seg_kv`` [B, Skv] mask pairs whose ids differ.  Not
    differentiable: :func:`mha` is.

    CPU tensors take :func:`mha_reference`; CUDA tensors launch the
    kernel (counted in ``LAUNCHES["flash_fwd"]``) or raise.
    """
    if (seg_q is None) != (seg_kv is None):
        raise ValueError("seg_q and seg_kv must be given together")
    if q.device.type == "cpu":
        return mha_reference(
            q, k, v, causal=causal, seg_q=seg_q, seg_kv=seg_kv, scale=scale
        )
    device = _check_qkv(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    seg_q, segq_sb = _seg(seg_q, b, sq, device)
    seg_kv, segkv_sb = _seg(seg_kv, b, skv, device)
    scale = d ** -0.5 if scale is None else float(scale)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=device)
    lse = (
        torch.empty((b, hq, sq), dtype=torch.float32, device=device)
        if return_lse else None
    )
    plan = fwd_launch_plan(b, sq, hq, d, kernel_lib.num_sms(device.index))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib_fn("flash_attention", "flash_fwd_bf16", _FWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr() if seg_q is not None else None,
            seg_kv.data_ptr() if seg_kv is not None else None,
            o.data_ptr(), lse.data_ptr() if lse is not None else None,
            b, sq, skv, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            segq_sb, segkv_sb, scale, int(causal), plan["block_m"], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: CUDA error {err}")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_launch(name, q, k, v, o, lse, do, seg_q, seg_kv, dq, dk, dv,
                causal, scale, ws=None, plan=None) -> None:
    device = _check_qkv(q, k, v)
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    for arg, x in (("o", o), ("do", do)):
        _check(arg, x, device)
        if tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{arg} shape {tuple(x.shape)} != q "
                             f"{tuple(q.shape)}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
            or not lse.is_contiguous()):
        raise ValueError("lse must be a contiguous fp32 [B, Hq, Sq] tensor")
    seg_q, segq_sb = _seg(seg_q, b, sq, device)
    seg_kv, segkv_sb = _seg(seg_kv, b, skv, device)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib_fn("flash_attention_bwd", "flash_bwd_bf16",
                      _BWD_ARGTYPES)(
            _BWD_KINDS[name], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), ptr(seg_q),
            ptr(seg_kv),
            ptr(dq), ptr(dk), ptr(dv),
            b, sq, skv, hq, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3],
            segq_sb, segkv_sb, scale, int(causal), ptr(ws),
            *((plan["sq_pad"], plan["block_kv"], plan["stages"]) if plan
              else (0, 0, 0)),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _workspace(plan: dict, device) -> dict:
    return {name: torch.empty(shape, dtype=torch.float32, device=device)
            for name, shape in plan["workspace"].items()}


def flash_bwd_fused(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                    seg_kv=None, scale=None):
    """K3 counterpart, two launches counted as one: a pre-pass computes
    ``delta = rowsum(o * do)`` once per row (and ``lse * log2(e)``) into
    row buffers and zeroes an fp32 ``[B, Sq, Hq, D]`` dq accumulator; then
    one block per (b, kv head, kv tile of ``bwd_launch_plan``'s
    ``block_kv`` rows) computes s, p and ds once for dq, dk and dv.  dk/dv
    accumulate in registers over the group's q heads and q tiles; dq is
    summed across kv-tile blocks by 16-byte vector reductions into the
    accumulator, then cast to bf16 here (the order of those adds varies
    from run to run, so dq is reproducible to rounding only; dk and dv are
    bitwise).  Launch counted in ``LAUNCHES["flash_bwd_fused"]``."""
    b, sq, hq, d = q.shape
    scale = d ** -0.5 if scale is None else float(scale)
    plan = bwd_launch_plan(b, sq, k.shape[1], hq, k.shape[2], d)
    ws = _workspace(plan, q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_bwd_fused", q, k, v, o, lse, do, seg_q, seg_kv,
                ws["dq_acc"], dk, dv, causal, scale, ws=ws["rows"],
                plan=plan)
    LAUNCHES["flash_bwd_fused"] += 1
    return ws["dq_acc"].to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                 seg_kv=None, scale=None):
    """K2a counterpart: one block per (b, q head, 64-row q tile) loops over
    the kv tiles it can see and accumulates ``dq += ds k`` in fp32
    registers; ``delta`` is computed once per block from ``o`` and ``do``.
    Launch counted in ``LAUNCHES["flash_bwd_dq"]``; its plain version is
    :func:`mha_backward_dq_reference`."""
    d = q.shape[3]
    scale = d ** -0.5 if scale is None else float(scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, o, lse, do, seg_q, seg_kv,
                dq, None, None, causal, scale)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                  seg_kv=None, scale=None):
    """K2b counterpart: K3's kernel without dq (``bwd_launch_plan`` kind
    ``"dkv"``: 64-row kv tiles, a 4-stage ring), two launches counted as
    one.  The pre-pass computes ``delta`` and ``lse * log2(e)`` into row
    buffers (no dq accumulator); one block per (b, kv head, kv tile) loops
    over its group's q heads and the q tiles that can see the tile (under
    causal, from the diagonal on), accumulating ``dv += p^T do`` and
    ``dk += ds^T q`` in fp32 registers in K3's order, so dk and dv equal
    K3's bit for bit.  Launch counted in ``LAUNCHES["flash_bwd_dkv"]``;
    its plain version is :func:`mha_backward_dkv_reference`."""
    b, sq, hq, d = q.shape
    scale = d ** -0.5 if scale is None else float(scale)
    plan = bwd_launch_plan(b, sq, k.shape[1], hq, k.shape[2], d, kind="dkv")
    ws = _workspace(plan, q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_bwd_dkv", q, k, v, o, lse, do, seg_q, seg_kv,
                None, dk, dv, causal, scale, ws=ws["rows"], plan=plan)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    seg_q: Optional[torch.Tensor] = None,
    seg_kv: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    fused: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``o``/``lse`` and the output
    gradient ``do``.  CPU tensors take :func:`mha_backward_reference`; CUDA
    tensors launch :func:`flash_bwd_fused` (``fused``) or the
    :func:`flash_bwd_dq` + :func:`flash_bwd_dkv` pair, or raise.  ``do``
    is read through its strides when it is laid out as the kernels need
    (:func:`_aligned`) and made contiguous first otherwise (autograd can
    hand over an expanded or transposed gradient)."""
    if q.device.type == "cpu":
        return mha_backward_reference(
            q, k, v, o, lse, do, causal=causal, seg_q=seg_q, seg_kv=seg_kv,
            scale=scale,
        )
    if not _aligned(do):
        do = do.contiguous()
    kw = dict(causal=causal, seg_q=seg_q, seg_kv=seg_kv, scale=scale)
    if fused:
        return flash_bwd_fused(q, k, v, o, lse, do, **kw)
    dq = flash_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, **kw)
    return dq, dk, dv


# -- autograd -------------------------------------------------------------------


@torch.library.custom_op("dlrover_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: Optional[torch.Tensor],
    seg_kv: Optional[torch.Tensor],
    causal: bool,
    scale: float,
    fused_bwd: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` through :func:`flash_fwd`, as one op that autograd and
    selective checkpointing can see.  ``fused_bwd`` picks the backward
    kernel (:func:`uses_fused_backward`); the forward ignores it."""
    del fused_bwd
    o, lse = flash_fwd(q, k, v, causal=causal, seg_q=seg_q, seg_kv=seg_kv,
                       scale=scale)
    return o, lse


@flash_fwd_op.register_fake
def _(q, k, v, seg_q, seg_kv, causal, scale, fused_bwd):
    b, sq, hq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, hq, sq), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, seg_q, seg_kv, causal, scale, fused_bwd = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
    ctx.flags = (causal, scale, fused_bwd)


def _backward(ctx, do, dlse):
    del dlse  # lse is a residual of the backward, not a differentiated output
    q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
    causal, scale, fused_bwd = ctx.flags
    if do is None:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v), None, None, None, None, None)
    dq, dk, dv = flash_bwd(
        q, k, v, o, lse, do, causal=causal, seg_q=seg_q, seg_kv=seg_kv,
        scale=scale, fused=fused_bwd,
    )
    return dq, dk, dv, None, None, None, None, None


flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def _clamp_block(block: int, s: int) -> int:
    """The JAX wrapper's clamp of a block to the pow2-padded sequence, with
    a floor of 16 (``mha``, ``ops/flash_attention.py:620-621``)."""
    return min(block, max(16, 1 << (s - 1).bit_length()))


def uses_fused_backward(skv: int, block_kv: int) -> bool:
    """JAX's choice of backward (``_flash_core_bwd``): fused when the whole
    padded kv extent is one clamped ``block_kv`` block, split otherwise."""
    return skv <= _clamp_block(block_kv, skv)


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
    ``models/attention``), differentiable.  ``segment_ids`` [B, S]
    restricts token i to tokens j of the same segment (and j <= i when
    causal).  ``block_kv`` chooses the backward as JAX does (fused when the
    kv sequence fits in one clamped block, split dq/dkv kernels otherwise);
    the kernels' own tiles are fixed, so ``block_q`` changes nothing."""
    del block_q
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention has no kernel for {q.device}")
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        # Nothing to differentiate (serving): the kernel alone.  The op's
        # dispatch costs 25-50 us of host time per call more on an H100
        # host, 1-2.6 ms per 48-layer prefill on a host-bound path, and its
        # first call imports part of PyTorch's compiler stack (about 4 s).
        o, _ = flash_fwd(q, k, v, causal=causal, seg_q=segment_ids,
                         seg_kv=segment_ids, scale=scale, return_lse=False)
        return o
    o, _ = flash_fwd_op(
        q, k, v, segment_ids, segment_ids, causal, scale,
        uses_fused_backward(k.shape[1], block_kv),
    )
    return o

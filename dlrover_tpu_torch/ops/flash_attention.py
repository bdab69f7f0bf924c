"""Flash attention, forward and backward (port of
``dlrover_tpu/ops/flash_attention.py``).

``mha`` computes causal or full attention on ``[B, S, H, D]`` tensors with
an optional segment mask and GQA, the JAX ``mha``'s function, and is
differentiable on every device.  On a CUDA tensor the forward launches the
hand-written Hopper kernel ``ops/csrc/flash_attention.cu`` and the backward
launches the kernels of ``ops/csrc/flash_attention_bwd.cu`` (bf16, ``D`` in
{64, 128}), or they raise; on a CUDA tensor ``mha`` zero-pads a smaller
head dim to the next of those (:func:`mha_padded`) and slices the output
back, which is exact: zero columns of q and k add nothing to ``q k^T``,
those of v give output columns that are dropped, and the scale is the true
head dim's.  On a CPU tensor the kernels' wrappers take :func:`mha_reference`
and :func:`mha_backward_reference`, the plain fp32 versions that the CPU
tests use and that ``chip_smoke.py`` holds the kernels against.

Autograd: the forward is the custom op ``dlrover_tpu_torch::flash_fwd``
returning ``(o, lse)``; its registered backward saves ``(q, k, v, o,
lse)`` and computes ``(dq, dk, dv)`` from them, as the JAX
``custom_vjp`` does.  The op's outputs are the remat sites
``flash_out`` and ``flash_lse`` (``ops/remat_policy.py``): under a
policy that keeps both (``flash_only``, ``flash_res``, or an offload
list naming both) the checkpointed block's first run keeps them and its
recompute hands them back through ``_Replay``, which launches nothing and
saves what the op saves, in its order, so the op's backward finds its
tensors and the forward kernel runs once.

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
import torch.nn.functional as F

from dlrover_tpu_torch.ops import kernel_lib, remat_policy

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
#: Zero-padding copies ``mha`` makes for a head dim that is not one of
#: ``HEAD_DIMS``: three a forward (q, k and v padded) and four a backward
#: (the output gradient padded, the three input gradients sliced back).
#: Not kernel launches: a cost of those shapes, which ``chip_smoke.py``
#: records beside the kernels' counts and times.
PAD_COPIES = {"flash_pad": 0}


def padded_head_dim(d: int) -> int:
    """The kernels' head dim for ``d``: the smallest of ``HEAD_DIMS`` that
    is at least ``d``.  Above the largest there is no kernel (ROADMAP
    Queue 3 item 7)."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(
        f"head_dim {d} > {HEAD_DIMS[-1]}: the flash kernels have no build "
        f"for it (ROADMAP Queue 3 item 7)")


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
# sq_pad block_rows stages smem_bytes prep | stream
_BWD_ARGTYPES = (
    [_I] + [_P] * 11 + [_I] * 6 + [_LL] * 17 + [ctypes.c_float, _I]
    + [_P] + [_I] * 5 + [_P]
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
#: K2a's builds in ``csrc/flash_attention_bwd.cu`` (its ``DQ_BUILD``
#: table): (head dim, warpgroups a block) -> (stages of the (k, v) ring,
#: blocks an SM the registers allow).
DQ_BUILDS = {(64, 2): (4, 1), (64, 1): (4, 2), (128, 2): (4, 1),
             (128, 1): (4, 1)}
#: Head dim -> waves of 128-row blocks on the card from which K2a's plan
#: takes blocks of two warpgroups: the crossovers of the two builds timed
#: on an H100 (``chip_smoke.py --ab``, PERF.md), between 12 and 24 waves
#: at D 64 and between a quarter and one wave at D 128.
DQ_TWO_WARPGROUP_WAVES = {64: 16, 128: 0.5}


def _stat_rows(b: int, sq: int, hq: int, d: int) -> dict:
    """The backward pre-pass's rows: ``sq_pad`` (sq rounded up to a tile),
    its grid (``d // 8`` threads a row, 256 a block) and the fp32 lse2 /
    delta buffer ``[2, b, hq, sq_pad]`` every backward kernel reads."""
    sq_pad = _cdiv(sq, MASK_TILE) * MASK_TILE
    rows_per_block = 256 // (d // 8)
    return dict(sq_pad=sq_pad,
                prep_grid=_cdiv(b * sq_pad * hq, rows_per_block),
                workspace={"rows": (2, b, hq, sq_pad)})


def dq_smem_bytes(d: int, warpgroups: int, stages: int) -> int:
    """K2a's dynamic shared memory (``DqSmem`` in the source): Q and dO
    resident, the (k, v) ring, the lse2 / delta rows, the barriers and
    1024 bytes of alignment slack."""
    block_m = MASK_TILE * warpgroups
    return (2 * block_m * d * 2 + 2 * stages * MASK_TILE * d * 2
            + 2 * block_m * 4 + 8 * (1 + 2 * stages) + 1024)


def kv_tile_smem_bytes(d: int, kv_warpgroups: int, stages: int,
                       with_dq: bool) -> int:
    """K3's (``with_dq``) or K2b's dynamic shared memory (``FusedSmem``):
    K and V resident, the (q, do) ring with its lse2 / delta rows, K3's
    dS^T tiles, the barriers and 1024 bytes of slack."""
    block_kv = MASK_TILE * kv_warpgroups
    return (2 * block_kv * d * 2 + 2 * stages * MASK_TILE * d * 2
            + (kv_warpgroups * 2 * MASK_TILE * MASK_TILE * 2 if with_dq
               else 0)
            + 2 * stages * MASK_TILE * 4 + 8 * (1 + 2 * stages) + 1024)


def dq_launch_plan(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                   num_sms: int = kernel_lib.H100_SMS) -> dict:
    """How K2a is launched for q ``[b, sq, hq, d]`` against ``skv`` kv
    rows: ``block_m`` q rows a block (128, two warpgroups sharing the
    streamed k and v tiles, where ``b * hq * ceil(sq / 128)`` blocks make
    at least :data:`DQ_TWO_WARPGROUP_WAVES` waves of the card's
    ``num_sms`` SMs; else 64, one warpgroup, two blocks an SM at D 64,
    whose finer tiles balance a shorter grid better), the grid ``(b * hq,
    q tiles)`` (under causal masking the kernel takes the q tiles last
    first), the TMA boxes of the resident
    (q, do) tiles and of the streamed (k, v) tiles, the ``stages`` of the
    (k, v) ring and ``blocks_per_sm`` (:data:`DQ_BUILDS`), the
    ``smem_bytes`` of a block, and the pre-pass's rows
    (:func:`_stat_rows`), the split path's one ``workspace``."""
    del skv, hkv  # every q tile streams the kv tiles it can see
    waves = b * hq * _cdiv(sq, 2 * MASK_TILE) / num_sms
    warpgroups = 2 if waves >= DQ_TWO_WARPGROUP_WAVES[d] else 1
    stages, blocks_per_sm = DQ_BUILDS[(d, warpgroups)]
    block_m = MASK_TILE * warpgroups
    return dict(
        kind="dq", block_m=block_m, grid=(b * hq, _cdiv(sq, block_m)),
        q_box=(64, 1, block_m, 1), kv_box=(64, 1, MASK_TILE, 1),
        boxes_per_row=d // 64, stages=stages, blocks_per_sm=blocks_per_sm,
        smem_bytes=dq_smem_bytes(d, warpgroups, stages),
        **_stat_rows(b, sq, hq, d),
    )


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
    (:data:`BWD_STAGES`), the ``smem_bytes`` of a block, the pre-pass's
    rows (:func:`_stat_rows`) and the ``workspace`` the wrapper
    allocates, fp32 shapes by name: the pre-pass's lse2 and delta rows,
    and K3's dq accumulator."""
    if kind not in ("fused", "dkv"):
        raise ValueError(f"no kv-tile backward kernel of kind {kind!r}")
    wide = kind == "fused" and d == 64
    block_kv = 2 * MASK_TILE if wide else MASK_TILE
    stats = _stat_rows(b, sq, hq, d)
    if kind == "fused":
        stats["workspace"]["dq_acc"] = (b, sq, hq, d)
    return dict(
        kind=kind, block_kv=block_kv, grid=(b * hkv, _cdiv(skv, block_kv)),
        q_box=(64, 1, MASK_TILE, 1),
        kv_box=(64, 1, block_kv, 1), boxes_per_row=d // 64,
        stages=BWD_STAGES[kind],
        blocks_per_sm=2 if kind == "dkv" and d == 64 else 1,
        smem_bytes=kv_tile_smem_bytes(d, block_kv // MASK_TILE,
                                      BWD_STAGES[kind], kind == "fused"),
        **stats,
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
                causal, scale, ws, plan, prep=True) -> None:
    """One call of ``flash_bwd_bf16``: kernel ``name`` with its pre-pass
    (``prep``; without it, ``ws`` already holds this backward's lse2 and
    delta rows)."""
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

    block_rows = plan["block_m"] if plan["kind"] == "dq" else plan["block_kv"]
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
            segq_sb, segkv_sb, scale, int(causal), ws.data_ptr(),
            plan["sq_pad"], block_rows, plan["stages"], plan["smem_bytes"],
            int(prep), stream,
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
                ws["dq_acc"], dk, dv, causal, scale, ws["rows"], plan)
    LAUNCHES["flash_bwd_fused"] += 1
    return ws["dq_acc"].to(q.dtype), dk, dv


def _dq_launch(q, k, v, o, lse, do, rows, *, causal, seg_q, seg_kv, scale,
               prep):
    """K2a into a new bf16 dq, reading (``prep`` false) or first filling
    the pre-pass's ``rows``."""
    b, sq, hq, d = q.shape
    plan = dq_launch_plan(b, sq, k.shape[1], hq, k.shape[2], d,
                          kernel_lib.num_sms(_check_qkv(q, k, v).index))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, o, lse, do, seg_q, seg_kv, dq,
                None, None, causal, scale, rows, plan, prep=prep)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _dkv_launch(q, k, v, o, lse, do, rows, *, causal, seg_q, seg_kv, scale,
                prep):
    """K2b into new bf16 dk and dv, reading (``prep`` false) or first
    filling the pre-pass's ``rows``."""
    b, sq, hq, d = q.shape
    plan = bwd_launch_plan(b, sq, k.shape[1], hq, k.shape[2], d, kind="dkv")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_bwd_dkv", q, k, v, o, lse, do, seg_q, seg_kv, None,
                dk, dv, causal, scale, rows, plan, prep=prep)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _rows(q) -> torch.Tensor:
    """The pre-pass's lse2 / delta rows for q (``_stat_rows``)."""
    b, sq, hq, d = q.shape
    return torch.empty(_stat_rows(b, sq, hq, d)["workspace"]["rows"],
                       dtype=torch.float32, device=q.device)


def flash_bwd_dq(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                 seg_kv=None, scale=None):
    """K2a counterpart, two launches counted as one: the pre-pass fills
    the lse2 and delta rows, then one block per (b, q head, q tile of
    ``dq_launch_plan``'s ``block_m`` rows) holds its Q and dO tiles in
    shared memory, streams the kv tiles it can see through a TMA ring, and
    builds S, dP, P and dS in registers: dS (bf16) is the register operand
    of ``dq += ds k``, which accumulates in fp32 registers over the whole
    kv loop and is written once, so dq is the same bit for bit from run to
    run.  Its bytes and its three products over the live pairs bound it
    about equally; a warpgroup still waits for S and dP before it builds
    dS, and the pre-pass reads o and do once more.  Launch counted in
    ``LAUNCHES["flash_bwd_dq"]``; its plain version is
    :func:`mha_backward_dq_reference`."""
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    return _dq_launch(q, k, v, o, lse, do, _rows(q), causal=causal,
                      seg_q=seg_q, seg_kv=seg_kv, scale=scale, prep=True)


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
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    return _dkv_launch(q, k, v, o, lse, do, _rows(q), causal=causal,
                       seg_q=seg_q, seg_kv=seg_kv, scale=scale, prep=True)


def flash_bwd_split(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                    seg_kv=None, scale=None):
    """The split backward: K2a then K2b, one of each counted, sharing one
    pre-pass: K2a's launch fills the lse2 and delta rows and K2b's reads
    them."""
    kw = dict(causal=causal, seg_q=seg_q, seg_kv=seg_kv,
              scale=q.shape[3] ** -0.5 if scale is None else float(scale))
    rows = _rows(q)
    dq = _dq_launch(q, k, v, o, lse, do, rows, prep=True, **kw)
    dk, dv = _dkv_launch(q, k, v, o, lse, do, rows, prep=False, **kw)
    return dq, dk, dv


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
    tensors launch :func:`flash_bwd_fused` (``fused``) or
    :func:`flash_bwd_split` (K2a and K2b on one pre-pass), or raise.  ``do``
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
    return flash_bwd_split(q, k, v, o, lse, do, **kw)


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
    """``(o, lse)`` through :func:`flash_fwd`, as one op with its own
    backward.  ``fused_bwd`` picks the backward
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


class _Replay(torch.autograd.Function):
    """The flash forward's outputs handed back in a recompute: no kernel,
    and the tensors ``flash_fwd_op`` saves, in its order, so a checkpoint
    that recomputes its block refills that op's saved tensors (its
    backward is the op's)."""

    @staticmethod
    def forward(ctx, q, k, v, o, lse, seg_q, seg_kv, causal, scale,
                fused_bwd):
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
        ctx.flags = (causal, scale, fused_bwd)
        return o.view_as(o), lse.view_as(lse)

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx, do, dlse) + (None, None)


_FLASH_SITE = ("flash_out", "flash_lse")


def _kept_attend(store, q, k, v, seg, causal, scale, fused_bwd):
    """The flash op as the remat sites ``flash_out`` and ``flash_lse`` of
    the block call in progress (``store``): the first run keeps what the
    policy keeps of ``(o, lse)``; a recompute replays them when it kept
    both, and runs the op again otherwise."""
    modes = tuple(store.mode((name,)) for name in _FLASH_SITE)
    if not any(modes):
        o, _ = flash_fwd_op(q, k, v, seg, seg, causal, scale, fused_bwd)
        return o
    if store.first:
        o, lse = flash_fwd_op(q, k, v, seg, seg, causal, scale, fused_bwd)
        store.keep((o, lse), _FLASH_SITE, modes)
        return o
    o, lse = store.replay()
    if o is None or lse is None:
        o, _ = flash_fwd_op(q, k, v, seg, seg, causal, scale, fused_bwd)
        return o
    o, _ = _Replay.apply(q, k, v, o, lse, seg, seg, causal, scale,
                         fused_bwd)
    return o


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
    the kernels' own tiles are fixed, so ``block_q`` changes nothing.  On
    a CUDA tensor a head dim that is not one of ``HEAD_DIMS`` runs through
    :func:`mha_padded`."""
    del block_q
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention has no kernel for {q.device}")
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cuda" and d not in HEAD_DIMS:
        return mha_padded(q, k, v, causal=causal, segment_ids=segment_ids,
                          block_kv=block_kv, scale=scale)
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        # Nothing to differentiate (serving): the kernel alone.  The op's
        # dispatch costs 25-50 us of host time per call more on an H100
        # host, 1-2.6 ms per 48-layer prefill on a host-bound path, and its
        # first call imports part of PyTorch's compiler stack (about 4 s).
        o, _ = flash_fwd(q, k, v, causal=causal, seg_q=segment_ids,
                         seg_kv=segment_ids, scale=scale, return_lse=False)
        return o
    fused = uses_fused_backward(k.shape[1], block_kv)
    store = remat_policy.active()
    if store is not None:
        return _kept_attend(store, q, k, v, segment_ids, causal, scale,
                            fused)
    o, _ = flash_fwd_op(q, k, v, segment_ids, segment_ids, causal, scale,
                        fused)
    return o


def mha_padded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    block_kv: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`mha` with q, k and v zero-padded along D to
    :func:`padded_head_dim` and the output sliced back, at the scale of
    the true head dim; autograd pads the output gradient and slices the
    input gradients back.  Each of these copies is counted in
    ``PAD_COPIES`` (the backward's by gradient hooks, as autograd makes
    them).  What ``mha`` runs on the card for a head dim the kernels have
    no build for; on CPU tensors it runs the same padding through the
    plain versions (the tests' check that it is exact)."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    width = padded_head_dim(d)
    q, k, v = (F.pad(x, (0, width - d)) for x in (q, k, v))
    PAD_COPIES["flash_pad"] += 3
    o = mha(q, k, v, causal=causal, segment_ids=segment_ids,
            block_kv=block_kv, scale=scale)
    for t in (o, q, k, v):
        if t.requires_grad:
            t.register_hook(_count_backward_pad)
    return o[..., :d]


def _count_backward_pad(grad: torch.Tensor) -> None:
    """A padded tensor's gradient: the output's is the sliced output's
    gradient padded back, an input's is sliced to the true head dim next;
    either is one copy."""
    PAD_COPIES["flash_pad"] += 1

"""LayerNorm and RMSNorm whose backward is one fused pass (port of
``dlrover_tpu/ops/fused_norm.py``).

The forward is plain PyTorch with fp32 statistics and saves ``x`` and the
row statistics ``mean`` and ``rstd`` (fp32), as the JAX forward does.  The
backward computes dx and the dscale and dbias partial sums in a single
pass over ``(x, dy)``:

    xhat = (x - mean) * rstd             (RMSNorm: x * rstd)
    g    = dy * scale
    dx   = rstd * (g - xhat * mean(g * xhat) - mean(g))   (RMSNorm: no mean(g))
    dscale = sum_rows(dy * xhat);  dbias = sum_rows(dy)

On a CUDA tensor :func:`layernorm_backward` launches the hand-written
Hopper kernel of ``ops/csrc/fused_norm.cu`` (K4; ``center`` is a template
flag of one kernel body, as in the JAX kernel factory) or raises; on a CPU
tensor it takes :func:`layernorm_backward_reference`, which the CPU tests
use and ``chip_smoke.py`` holds the kernel against.  The kernel writes one
fp32 partial row of dscale and dbias per block of rows, as JAX's kernel
writes one per grid step, and a second kernel of the same launch sums
them in a fixed order: no atomics, so the parameter gradients are the same
bit for bit from run to run.

:func:`fused_layernorm` and :func:`fused_rmsnorm` go through the custom op
``dlrover_tpu_torch::norm_fwd`` with a registered backward, so autograd
reaches the kernel and selective checkpointing sees one op, which the
``flash_only`` remat policy recomputes in the backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dlrover_tpu_torch.ops import kernel_lib

MAX_FEATURES = 8192  # the kernel's widest row
#: Kernel launches of K4; a run sets the count to 0 and reads it back to
#: show its path went through the kernel.
LAUNCHES = {"norm_bwd": 0}


def norm_forward(x: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], eps: float, center: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y in x's dtype, mean, rstd)`` with fp32 statistics over the last
    axis; ``mean`` and ``rstd`` have ``x``'s leading shape (``mean`` is
    empty without ``center``: RMSNorm has none)."""
    x32 = x.float()
    if center:
        mean = x32.mean(dim=-1, keepdim=True)
        xc = x32 - mean
        var = xc.square().mean(dim=-1, keepdim=True)
    else:
        mean = None
        xc = x32
        var = x32.square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * scale.float()
    if bias is not None:
        y = y + bias.float()
    mean = (mean[..., 0] if center
            else torch.empty((0,), dtype=torch.float32, device=x.device))
    return y.to(x.dtype), mean, rstd[..., 0]


def layernorm_backward_reference(
        x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
        mean: torch.Tensor, rstd: torch.Tensor, center: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4 in fp32 -> ``(dx like x, dscale [D] fp32, dbias
    [D] fp32)``.  ``mean`` is ignored without ``center``."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    dy32 = dy.reshape(-1, d).float()
    r = rstd.reshape(-1, 1).float()
    xhat = (x32 - mean.reshape(-1, 1).float()) * r if center else x32 * r
    g = dy32 * scale.float()
    dx = g - xhat * ((g * xhat).sum(dim=-1, keepdim=True) / d)
    if center:
        dx = dx - g.sum(dim=-1, keepdim=True) / d
    return ((r * dx).to(x.dtype).reshape(x.shape),
            (dy32 * xhat).sum(dim=0), dy32.sum(dim=0))


_P, _I = ctypes.c_void_p, ctypes.c_int
# x dy scale mean rstd dx parts sums | n D center is_bf16 | plan stream
_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P, _P]

# The kernel's constants (``csrc/fused_norm.cu``).
THREADS = 256              # threads a block: 8 warps
CHUNK = 8                  # consecutive columns a lane loads at once
NCH = 4                    # most chunks a lane holds
MIN_BLOCKS = 2             # blocks an SM its registers allow
RED_COLS = 32              # columns a block of the partial-row reduction
STAGES = 3                 # (x, dy) row pairs of a group's ring
SMEM_PER_SM = 233472       # an H100 SM's shared memory
SMEM_PER_BLOCK = 232448    # the most one block may take
SMEM_RESERVED = 1024       # what the card reserves per block


class NormPlan(ctypes.Structure):
    """The C struct ``NormPlan`` of ``csrc/fused_norm.cu``, field for
    field."""

    _fields_ = [("blocks", _I), ("warps_per_row", _I),
                ("rows_per_group", _I), ("smem_bytes", _I),
                ("reduce_blocks", _I)]

    @classmethod
    def of(cls, plan: dict) -> "NormPlan":
        return cls(*(plan[name] for name, _ in cls._fields_))


def _lib_fn():
    fn = kernel_lib.load("fused_norm").norm_bwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def norm_smem_bytes(d: int, itemsize: int, warps_per_row: int,
                    stages: int) -> int:
    """A block's shared memory (``NormSmem`` in the source): the groups'
    rings of ``stages`` (x, dy) rows (at least room for the groups'
    partial rows, which take it over at the end), scale in fp32, the
    groups' row-sum slots and their ring barriers."""
    groups = THREADS // 32 // warps_per_row
    row_bytes = _cdiv(d * itemsize, 16) * 16
    ring = max(groups * stages * 2 * row_bytes,
               _cdiv(groups * 2 * d * 4, 16) * 16)
    return (ring + _cdiv(d * 4, 16) * 16 + 16 * groups * warps_per_row
            + 16 * groups * stages)


def norm_launch_plan(n: int, d: int, num_sms: int = kernel_lib.H100_SMS,
                     itemsize: int = 2, ring: bool = True) -> dict:
    """How K4 is launched for ``n`` rows of ``d`` features of
    ``itemsize`` bytes: ``warps_per_row`` (the fewest of 1, 2, 4, 8 that
    leave a lane at most ``NCH`` chunks of 8 columns), ``groups`` of them
    in a block of 256 threads, ``rows_per_group`` consecutive rows each
    (``rows_per_block`` = groups x that, from row 0 on), the ``stages``
    of a group's (x, dy) ring (``ring``: rows go through shared memory by
    bulk copies, which needs ``d`` a multiple of 8 and aligned tensors;
    else 0), ``blocks_per_sm`` (two, as the registers allow, where the
    ring's ``smem_bytes`` lets them, else one), the grid ``blocks`` (one
    partial row each), the partial rows' reduction grid ``reduce_blocks``
    and the fp32 ``workspace``."""
    if n < 1 or not 1 <= d <= 8192:
        raise ValueError(f"no norm kernel plan for n={n}, d={d}")
    chunks = _cdiv(d, CHUNK)
    warps = next(w for w in (1, 2, 4, 8) if _cdiv(chunks, 32 * w) <= NCH)
    groups = THREADS // 32 // warps
    stages = STAGES if ring else 0
    smem = norm_smem_bytes(d, itemsize, warps, stages)
    per_sm = (MIN_BLOCKS if MIN_BLOCKS * (smem + SMEM_RESERVED) <= SMEM_PER_SM
              else 1)
    blocks = min(num_sms * per_sm, _cdiv(n, groups))
    rows_per_group = _cdiv(n, blocks * groups)
    blocks = _cdiv(n, rows_per_group * groups)
    return dict(
        warps_per_row=warps, groups=groups, rows_per_group=rows_per_group,
        rows_per_block=groups * rows_per_group, stages=stages,
        blocks_per_sm=per_sm, blocks=blocks, smem_bytes=smem,
        reduce_blocks=_cdiv(2 * d, RED_COLS),
        workspace={"parts": (blocks, 2, d), "sums": (2, d)},
    )


def layernorm_backward(
        x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
        mean: torch.Tensor, rstd: torch.Tensor, center: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx like x, dscale [D] fp32, dbias [D] fp32)`` from the forward's
    input and saved statistics and the output gradient ``dy``.  CPU tensors
    take :func:`layernorm_backward_reference`; CUDA tensors launch K4
    (counted in ``LAUNCHES["norm_bwd"]``) or raise.

    K4 (``norm_launch_plan``): a row belongs to one warp, or to a pair of
    warps at D 1600 (up to 8 at D 8192), so its sums are warp shuffles and
    the row loop has no block barrier; each group of warps takes a run of
    consecutive rows through a shared-memory ring of three rows, refilled
    at the top of each row, so the next row's bulk copies are in flight
    while it reduces and writes this one.  dscale and dbias partials stay
    in registers, are summed across the block's groups once at the end,
    and a second kernel of the same launch sums the blocks' partial rows
    in a fixed order: both are the same bit for bit from run to run, and
    no reduction is left to the wrapper.  Bytes bound it (x and dy read
    once, dx written once); a row's two reductions still stand between
    its loads and its stores."""
    if x.device.type == "cpu":
        return layernorm_backward_reference(x, dy, scale, mean, rstd, center)
    if x.device.type != "cuda":
        raise ValueError(f"the fused norm backward has no kernel for "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fused norm backward kernel takes fp32 or bf16 "
                        f"x, got {x.dtype}")
    d = x.shape[-1]
    if x.numel() == 0 or d > MAX_FEATURES:
        raise ValueError(f"the fused norm backward kernel takes non-empty x "
                         f"of at most {MAX_FEATURES} features, got "
                         f"{tuple(x.shape)}")
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    n = x.numel() // d
    x2 = x.reshape(n, d).contiguous()
    dy2 = dy.to(x.dtype).reshape(n, d).contiguous()
    scale32 = scale.float().contiguous()
    rstd32 = rstd.float().reshape(-1).contiguous()
    mean32 = mean.float().reshape(-1).contiguous() if center else rstd32
    if (tuple(scale32.shape) != (d,) or rstd32.numel() != n
            or mean32.numel() != n):
        raise ValueError(
            f"scale {tuple(scale.shape)}, mean {tuple(mean.shape)} and rstd "
            f"{tuple(rstd.shape)} do not fit x {tuple(x.shape)}")
    dx = torch.empty_like(x2)
    ring = d % CHUNK == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x2, dy2, dx))
    plan = norm_launch_plan(n, d, kernel_lib.num_sms(x2.device.index),
                            x2.element_size(), ring)
    parts, sums = (torch.empty(plan["workspace"][name], dtype=torch.float32,
                               device=x2.device)
                   for name in ("parts", "sums"))
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = _lib_fn()(
            x2.data_ptr(), dy2.data_ptr(), scale32.data_ptr(),
            mean32.data_ptr(), rstd32.data_ptr(), dx.data_ptr(),
            parts.data_ptr(), sums.data_ptr(), n, d, int(center),
            int(x2.dtype == torch.bfloat16), ctypes.byref(NormPlan.of(plan)),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"norm_bwd launch failed: CUDA error {err}")
    LAUNCHES["norm_bwd"] += 1
    return dx.reshape(x.shape), sums[0], sums[1]


# -- autograd -------------------------------------------------------------------


@torch.library.custom_op("dlrover_tpu_torch::norm_fwd", mutates_args=())
def norm_fwd_op(x: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor], eps: float, center: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`norm_forward` as one op that autograd and selective
    checkpointing can see."""
    return norm_forward(x, scale, bias, eps, center)


@norm_fwd_op.register_fake
def _(x, scale, bias, eps, center):
    stats = x.new_empty(x.shape[:-1], dtype=torch.float32)
    mean = stats if center else x.new_empty((0,), dtype=torch.float32)
    return x.new_empty(x.shape), mean, x.new_empty(x.shape[:-1],
                                                   dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    x, scale, bias, _, center = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, scale, mean, rstd)
    ctx.center = center
    ctx.bias_dtype = None if bias is None else bias.dtype


def _backward(ctx, dy, dmean, drstd):
    del dmean, drstd  # residuals of the backward, not differentiated outputs
    x, scale, mean, rstd = ctx.saved_tensors
    dx, dscale, dbias = layernorm_backward(x, dy, scale, mean, rstd,
                                           ctx.center)
    dbias = None if ctx.bias_dtype is None else dbias.to(ctx.bias_dtype)
    return dx, dscale.to(scale.dtype), dbias, None, None


norm_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def _check(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused norm has no kernel for {x.device}")


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis whose backward is the one-pass kernel.
    ``x``: ``[..., D]``; ``scale``/``bias``: ``[D]`` (``bias`` may be
    None).  Returns ``x``'s dtype."""
    _check(x)
    return norm_fwd_op(x, scale, bias, eps, True)[0]


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (Llama-style) with the one-pass backward."""
    _check(x)
    return norm_fwd_op(x, scale, None, eps, False)[0]

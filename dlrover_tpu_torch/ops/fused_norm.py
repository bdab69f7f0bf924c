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
fp32 partial row of dscale and dbias per block of rows and the partials
are summed outside it, as JAX sums its per-grid-step partials: no atomics,
so the parameter gradients are deterministic.

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
# x dy scale mean rstd dx dscale_parts dbias_parts | n D rows_per_block
# center is_bf16 | stream
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_P]


def _lib_fn():
    fn = kernel_lib.load("fused_norm").norm_bwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _rows_per_block(n: int, device: torch.device) -> int:
    """Rows a kernel block takes: about four blocks per multiprocessor, so
    the partial rows stay a small share of the traffic."""
    blocks = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, -(-n // blocks))


def layernorm_backward(
        x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
        mean: torch.Tensor, rstd: torch.Tensor, center: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx like x, dscale [D] fp32, dbias [D] fp32)`` from the forward's
    input and saved statistics and the output gradient ``dy``.  CPU tensors
    take :func:`layernorm_backward_reference`; CUDA tensors launch K4
    (counted in ``LAUNCHES["norm_bwd"]``) or raise."""
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
    rows = _rows_per_block(n, x.device)
    blocks = -(-n // rows)
    dx = torch.empty_like(x2)
    parts = torch.empty((2, blocks, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib_fn()(
            x2.data_ptr(), dy2.data_ptr(), scale32.data_ptr(),
            mean32.data_ptr(), rstd32.data_ptr(), dx.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), n, d, rows,
            int(center), int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"norm_bwd launch failed: CUDA error {err}")
    LAUNCHES["norm_bwd"] += 1
    sums = parts.sum(dim=1)
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

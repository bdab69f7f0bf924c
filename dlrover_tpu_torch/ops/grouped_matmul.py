"""Grouped (ragged) matmul: the per-expert GEMMs of dropless MoE (port of
``dlrover_tpu/ops/grouped_matmul.py``).

``x`` rows are sorted by expert; ``group_sizes[e]`` consecutive rows belong
to expert ``e`` and multiply ``w[e]``.  Rows past ``sum(group_sizes)`` (the
caller's static padding budget) belong to the last expert, as the JAX
kernel's clamped block->expert map has it; the MoE layer leaves them zero.
Group sizes are multiples of ``block_rows``.

:func:`grouped_matmul` is differentiable on every device, as the JAX
``custom_vjp`` is: the forward and the backward's dx are :func:`gmm_fwd`
(dx against ``w`` transposed, read through a flag rather than a
``swapaxes`` copy) and the backward's dw is :func:`gmm_dw`, where an
expert that owns no rows gets exactly 0.  On a CUDA tensor those launch
the hand-written Hopper kernels of ``ops/csrc/grouped_matmul.cu`` (K8 and
K9; bf16, widths that are multiples of 8, ``block_rows`` a multiple of
128) or raise; on a CPU tensor they take the plain fp32 versions
:func:`grouped_matmul_reference` and :func:`grouped_matmul_dw_reference`,
which the CPU tests use and ``chip_smoke.py`` holds the kernels against.

The forward is the custom op ``dlrover_tpu_torch::gmm`` with a registered
backward (a bare ctypes launch into ``torch.empty`` would leave the output
without a ``grad_fn``).  Selective checkpointing sees it as one op, so
under the ``flash_only`` remat policy it is recomputed in the backward.
Nothing on the kernel path reads a value back to the host: the group
offsets stay on the device and each kernel block finds its expert itself.
How a kernel is launched (its tiles, ring depth, shared memory and the
persistent grid) is :func:`gmm_launch_plan`, a pure function of the shapes
that the CPU tests check: the kernels read its tile counts and grid, and
refuse a plan whose tile, ring or shared memory they are not built for.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from dlrover_tpu_torch.ops import kernel_lib

KERNEL_ROWS = 128  # the kernels' row tile: block_rows must be a multiple
BLOCK_N = 256      # the kernels' column tile (half wide where 128 are left)
BLOCK_K = 64       # the kernels' reduction step (K tile): one swizzle row
STAGES = 4         # the kernels' TMA ring depth
MAX_EXPERTS = 64   # the kernels keep the experts' row ranges in shared memory

#: Kernel launches of K8 (forward and dx, ``gmm_fwd``) and K9 (dw,
#: ``gmm_dw``); a run sets them to 0 and reads them back to show its path
#: went through the kernels (``ops/flash_attention.LAUNCHES`` likewise).
LAUNCHES = {"gmm_fwd": 0, "gmm_dw": 0}


def expert_of_block(group_sizes: torch.Tensor, num_blocks: int,
                    block_rows: int) -> torch.Tensor:
    """``[num_blocks]`` int32: the expert of each ``block_rows``-row block,
    blocks past the groups clamped to the last expert (the JAX
    ``_expert_of_block``).  On the device, no host sync."""
    offsets = torch.cumsum(group_sizes, 0)
    starts = torch.arange(num_blocks, device=group_sizes.device,
                          dtype=offsets.dtype) * block_rows
    eob = torch.searchsorted(offsets, starts, right=True)
    return eob.clamp_max(group_sizes.shape[0] - 1).to(torch.int32)


def _ranges_of(sizes: List[int], n: int) -> List[Tuple[int, int]]:
    ranges, start = [], 0
    for e, size in enumerate(sizes):
        end = n if e == len(sizes) - 1 else min(start + size, n)
        ranges.append((min(start, n), end))
        start += size
    return ranges


def _row_ranges(group_sizes: torch.Tensor, n: int) -> List[Tuple[int, int]]:
    """Each expert's ``[start, end)`` rows, the last expert's reaching
    ``n`` (the padding rows).  Reads the sizes back to the host: for the
    plain versions only."""
    return _ranges_of([int(s) for s in group_sizes.tolist()], n)


def grouped_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                             group_sizes: torch.Tensor,
                             transpose_w: bool = False) -> torch.Tensor:
    """Plain version of K8: ``out[r] = x[r] @ w[expert(r)]`` (``w[e].T``
    with ``transpose_w``) in fp32, returned in ``x``'s dtype.  Loops over
    the experts' row ranges instead of gathering ``w`` per row (a
    ``[N, K, M]`` gather at the MoE shapes)."""
    n = x.shape[0]
    cols = w.shape[1] if transpose_w else w.shape[2]
    out = torch.zeros((n, cols), dtype=torch.float32, device=x.device)
    for e, (start, end) in enumerate(_row_ranges(group_sizes, n)):
        if end > start:
            we = w[e].float()
            out[start:end] = x[start:end].float() @ (we.t() if transpose_w
                                                     else we)
    return out.to(x.dtype)


def grouped_matmul_dw_reference(x: torch.Tensor, dy: torch.Tensor,
                                group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: ``dw[e] = x[rows of e]^T dy[rows of e]`` in
    fp32, returned in ``x``'s dtype; an expert with no rows gets 0 (the
    last expert's rows include the padding rows)."""
    n, k = x.shape
    e_count = group_sizes.shape[0]
    dw = torch.zeros((e_count, k, dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    sizes = group_sizes.tolist()
    for e, (start, end) in enumerate(_row_ranges(group_sizes, n)):
        if sizes[e] > 0 and end > start:
            dw[e] = x[start:end].float().t() @ dy[start:end].float()
    return dw.to(x.dtype)


# -- launch plan ----------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gmm_launch_plan(kind: str, n: int, k: int, m: int, experts: int,
                    num_sms: int = kernel_lib.H100_SMS) -> Dict:
    """How K8 (``kind`` ``"fwd"`` or ``"dx"``: ``x [n, k]`` times an
    expert's ``[k, m]``, the output ``[n, m]``) or K9 (``"dw"``: ``x [n,
    k]``, ``dy [n, m]``, the output ``[experts, k, m]``) is launched:
    ``KERNEL_ROWS`` x ``BLOCK_N`` output tiles (two consumer warpgroups of
    64 rows; the kernels make a tile half wide where at most 128 columns
    are left), a reduction step of ``BLOCK_K``, a ring of ``STAGES`` and the
    block's shared memory (``SMEM_BYTES`` in ``csrc/grouped_matmul.cu``),
    the tiles (K9: per expert, ``experts`` times over) and the persistent
    grid, one block per SM at most."""
    if kind not in ("fwd", "dx", "dw"):
        raise ValueError(f"unknown grouped matmul kind {kind!r}")
    stage_bytes = (KERNEL_ROWS + BLOCK_N) * BLOCK_K * 2
    rows = k if kind == "dw" else n
    row_tiles, col_tiles = _cdiv(rows, KERNEL_ROWS), _cdiv(m, BLOCK_N)
    tiles = row_tiles * col_tiles * (experts if kind == "dw" else 1)
    return dict(
        kind=kind, block_m=KERNEL_ROWS, block_n=BLOCK_N, block_k=BLOCK_K,
        stages=STAGES,
        # The ring, a full and an empty mbarrier a stage, three int tables
        # of MAX_EXPERTS, 1024 bytes of alignment slack.
        smem_bytes=STAGES * (stage_bytes + 16) + 12 * MAX_EXPERTS + 1024,
        row_tiles=row_tiles, col_tiles=col_tiles, tiles=tiles,
        grid=min(tiles, num_sms),
    )


# -- the CUDA kernels -----------------------------------------------------------


class GmmPlan(ctypes.Structure):
    """The kernels' ``GmmPlan``: the fields of :func:`gmm_launch_plan` that
    they check or read, in the C struct's order."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "block_m", "block_n", "block_k", "stages", "smem_bytes",
        "row_tiles", "col_tiles", "tiles", "grid")]

    @classmethod
    def of(cls, plan: Dict) -> "GmmPlan":
        return cls(*(plan[name] for name, _ in cls._fields_))


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLAN = ctypes.POINTER(GmmPlan)
# a w group_sizes out | N n_red n_cols E trans_w | lda ldb w_se | plan
# stream
_GMM_ARGTYPES = [_P] * 4 + [_I] * 5 + [_LL] * 3 + [_PLAN, _P]
# x dy group_sizes dw | N K M E | plan stream
_DW_ARGTYPES = [_P] * 4 + [_I] * 4 + [_PLAN, _P]


def _lib_fn(fn_name: str, argtypes):
    fn = getattr(kernel_lib.load("grouped_matmul"), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, device: torch.device,
           dim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"grouped matmul kernel takes bf16 {name}, got "
                        f"{t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D tensor, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.shape[1:]):
        raise ValueError(
            f"{name} must be 16-byte aligned with trailing dims that are "
            f"multiples of 8, got shape {tuple(t.shape)}")


def _check_groups(x: torch.Tensor, group_sizes: torch.Tensor, e: int,
                  block_rows: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"grouped matmul has no kernel for {x.device}")
    if block_rows % KERNEL_ROWS:
        raise ValueError(
            f"the kernels take block_rows that are multiples of "
            f"{KERNEL_ROWS}, got {block_rows}")
    if x.shape[0] % block_rows:
        raise ValueError(
            f"N={x.shape[0]} not a multiple of block_rows {block_rows}")
    if tuple(group_sizes.shape) != (e,) or group_sizes.device != x.device:
        raise ValueError(
            f"group_sizes must be [{e}] on {x.device}, got "
            f"{tuple(group_sizes.shape)} on {group_sizes.device}")
    if e > MAX_EXPERTS:
        raise ValueError(f"the kernels take at most {MAX_EXPERTS} experts, "
                         f"got {e}")
    return group_sizes.to(torch.int32).contiguous()


def gmm_fwd(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            block_rows: int = 128, transpose_w: bool = False
            ) -> torch.Tensor:
    """``[N, M]``: ``x [N, K]`` grouped times ``w [E, K, M]``, or with
    ``transpose_w`` times ``w [E, M, K]`` transposed per expert (the dx of
    the backward).  Not differentiable: :func:`grouped_matmul` is.

    CPU tensors take :func:`grouped_matmul_reference`; CUDA tensors launch
    K8 (counted in ``LAUNCHES["gmm_fwd"]``) or raise."""
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, group_sizes, transpose_w)
    gs = _check_groups(x, group_sizes, w.shape[0], block_rows)
    _check("x", x, x.device, 2)
    _check("w", w, x.device, 3)
    n, k = x.shape
    e = w.shape[0]
    cols, red = (w.shape[1], w.shape[2]) if transpose_w else (w.shape[2],
                                                              w.shape[1])
    if red != k:
        raise ValueError(f"x [N, {k}] does not contract with w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w})")
    out = torch.empty((n, cols), dtype=x.dtype, device=x.device)
    plan = gmm_launch_plan("dx" if transpose_w else "fwd", n, k, cols, e,
                           kernel_lib.num_sms(x.device.index))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib_fn("gmm_bf16", _GMM_ARGTYPES)(
            x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(),
            n, k, cols, e, int(transpose_w), x.stride(0), w.stride(1),
            w.stride(0), ctypes.byref(GmmPlan.of(plan)), stream,
        )
    if err != 0:
        raise RuntimeError(f"gmm_bf16 launch failed: CUDA error {err}")
    LAUNCHES["gmm_fwd"] += 1
    return out


def gmm_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
           block_rows: int = 128) -> torch.Tensor:
    """``[E, K, M]``: each expert's ``x^T dy`` over its rows, 0 for an
    expert with no rows.  CPU tensors take
    :func:`grouped_matmul_dw_reference`; CUDA tensors launch K9 (counted
    in ``LAUNCHES["gmm_dw"]``) or raise."""
    if x.device.type == "cpu":
        return grouped_matmul_dw_reference(x, dy, group_sizes)
    e = group_sizes.shape[0]
    gs = _check_groups(x, group_sizes, e, block_rows)
    _check("x", x, x.device, 2)
    _check("dy", dy, x.device, 2)
    if dy.shape[0] != x.shape[0]:
        raise ValueError(f"dy rows {dy.shape[0]} != x rows {x.shape[0]}")
    n, k = x.shape
    m = dy.shape[1]
    dw = torch.empty((e, k, m), dtype=x.dtype, device=x.device)
    plan = gmm_launch_plan("dw", n, k, m, e,
                           kernel_lib.num_sms(x.device.index))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib_fn("gmm_dw_bf16", _DW_ARGTYPES)(
            x.data_ptr(), dy.data_ptr(), gs.data_ptr(), dw.data_ptr(),
            n, k, m, e, ctypes.byref(GmmPlan.of(plan)), stream,
        )
    if err != 0:
        raise RuntimeError(f"gmm_dw_bf16 launch failed: CUDA error {err}")
    LAUNCHES["gmm_dw"] += 1
    return dw


# -- autograd -------------------------------------------------------------------


@torch.library.custom_op("dlrover_tpu_torch::gmm", mutates_args=())
def gmm_op(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
           block_rows: int) -> torch.Tensor:
    """:func:`gmm_fwd` as one op that autograd and selective
    checkpointing can see."""
    return gmm_fwd(x, w, group_sizes, block_rows)


@gmm_op.register_fake
def _(x, w, group_sizes, block_rows):
    return x.new_empty((x.shape[0], w.shape[2]))


def _setup_context(ctx, inputs, output):
    x, w, group_sizes, block_rows = inputs
    ctx.save_for_backward(x, w, group_sizes)
    ctx.block_rows = block_rows


def _backward(ctx, dy):
    x, w, group_sizes = ctx.saved_tensors
    if not dy.is_contiguous():
        dy = dy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = gmm_fwd(dy, w, group_sizes, ctx.block_rows,
                     transpose_w=True).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = gmm_dw(x, dy, group_sizes, ctx.block_rows).to(w.dtype)
    return dx, dw, None, None


gmm_op.register_autograd(_backward, setup_context=_setup_context)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor,
                   block_rows: int = 128) -> torch.Tensor:
    """``[N, M]`` with ``out[r] = x[r] @ w[expert_of_row(r)]``: ``x [N, K]``
    rows sorted by expert, ``w [E, K, M]``, ``group_sizes [E]`` int
    multiples of ``block_rows`` summing to at most N.  Differentiable in
    ``x`` and ``w``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped matmul has no kernel for {x.device}")
    if x.shape[0] % block_rows:
        raise ValueError(
            f"N={x.shape[0]} not a multiple of block_rows {block_rows}")
    return gmm_op(x, w, group_sizes, block_rows)

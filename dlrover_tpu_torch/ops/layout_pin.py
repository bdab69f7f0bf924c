"""Identity op that returns its input in the dense row-major layout (port
of ``dlrover_tpu/ops/layout_pin.py``).

In the JAX package the Pallas identity call is a layout firewall: it keeps
XLA's layout assignment from carrying the flash kernel's operand layout
back into the residual stream.  PyTorch assigns no layouts, so on the card
there is nothing to fight; the port keeps the function.  :func:`pin_layout`
takes any view (transposed, sliced, expanded) and returns a new contiguous
tensor with the same values, and its backward pins the cotangent the same
way, as the JAX ``custom_vjp`` does.  What it costs is one read and one
write of the tensor per call (``PERF.md`` has the time).

On a CUDA tensor the copy is the hand-written kernel of
``ops/csrc/layout_pin.cu`` (K11), launched by :func:`pin_copy`, or an
error; on a CPU tensor it is :func:`pin_layout_reference` (JAX skips the
call off the TPU; here the CPU path still returns a contiguous copy, so
both devices give the same kind of result).  The custom op
``dlrover_tpu_torch::pin_layout`` carries the registered backward and is
one op to selective checkpointing, which recomputes it.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from dlrover_tpu_torch.ops import kernel_lib

MAX_DIMS = 4  # the kernel's index arithmetic, after merging
#: Kernel launches of K11; a run sets the count to 0 and reads it back to
#: show its path went through the kernel.
LAUNCHES = {"pin_copy": 0}


def pin_layout_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: a new dense row-major tensor equal to ``x``."""
    return x.clone(memory_format=torch.contiguous_format)


def merged_dims(x: torch.Tensor) -> Tuple[List[int], List[int]]:
    """``x``'s sizes and strides with size-1 dims dropped and every pair
    of neighbours that one stride can walk merged: the fewest dims the
    kernel must index."""
    sizes: List[int] = []
    strides: List[int] = []
    for size, stride in zip(x.shape, x.stride()):
        if size == 1:
            continue
        if sizes and strides[-1] == stride * size:
            sizes[-1] *= size
            strides[-1] = stride
        else:
            sizes.append(size)
            strides.append(stride)
    return sizes, strides


#: Threads a block of both routes.  The vector route's blocks sweep the
#: tensor together, ``BLOCKS_PER_SM`` an SM at most, a thread ``UNROLL``
#: 16-byte loads deep (``UNROLL`` in ``csrc/layout_pin.cu``); the strided
#: route is a grid-stride loop over at most ``STRIDED_BLOCKS_PER_SM``.
THREADS = 256
BLOCKS_PER_SM = 8
UNROLL = 8
STRIDED_BLOCKS_PER_SM = 16
ROUTES = {"strided": 0, "vectors": 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pin_launch_plan(numel: int, elem_bytes: int, dense: bool,
                    num_sms: int = kernel_lib.H100_SMS) -> dict:
    """How K11 copies ``numel`` elements of ``elem_bytes``.  A ``dense``
    input (row-major, 16-byte aligned) whose bytes are a multiple of 16
    takes the ``vectors`` route: its ``n_vec`` 16-byte vectors in steps of
    ``threads * unroll``, block b taking steps b, b + blocks, ...  Anything
    else takes the ``strided`` route, element by element, element i by
    thread i, i + blocks * threads, ..."""
    nbytes = numel * elem_bytes
    if dense and nbytes % 16 == 0:
        n_vec = nbytes // 16
        blocks = min(num_sms * BLOCKS_PER_SM, _cdiv(n_vec, THREADS * UNROLL))
        return dict(route="vectors", n_vec=n_vec, blocks=blocks,
                    unroll=UNROLL, threads=THREADS)
    return dict(route="strided", n_vec=0,
                blocks=max(1, min(_cdiv(numel, THREADS),
                                  num_sms * STRIDED_BLOCKS_PER_SM)),
                unroll=1, threads=THREADS)


class PinPlan(ctypes.Structure):
    """The kernel's ``PinPlan``: the fields of :func:`pin_launch_plan` it
    reads, in the C struct's order (the route by its code)."""
    _fields_ = [(name, ctypes.c_longlong) for name in (
        "route", "blocks", "unroll")]

    @classmethod
    def of(cls, plan: dict) -> "PinPlan":
        return cls(ROUTES[plan["route"]], plan["blocks"], plan["unroll"])


_P, _I = ctypes.c_void_p, ctypes.c_int
_DIMS = ctypes.c_longlong * MAX_DIMS
# src dst sizes strides | elem_bytes | plan | stream
_ARGTYPES = [_P, _P, ctypes.POINTER(ctypes.c_longlong),
             ctypes.POINTER(ctypes.c_longlong), _I, ctypes.POINTER(PinPlan),
             _P]


def _lib_fn():
    fn = kernel_lib.load("layout_pin").pin_copy
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def pin_copy(x: torch.Tensor) -> torch.Tensor:
    """A new contiguous tensor equal to ``x``, bit for bit.  Not
    differentiable: :func:`pin_layout` is.  CPU tensors take
    :func:`pin_layout_reference`; CUDA tensors launch K11 (counted in
    ``LAUNCHES["pin_copy"]``) or raise."""
    if x.device.type == "cpu":
        return pin_layout_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"pin_layout has no kernel for {x.device}")
    if x.element_size() not in (1, 2, 4, 8) or x.is_complex():
        raise TypeError(f"pin_layout kernel does not take {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    sizes, strides = merged_dims(x)
    if len(sizes) > MAX_DIMS:
        raise ValueError(
            f"pin_layout kernel indexes at most {MAX_DIMS} dims after "
            f"merging, got sizes {sizes} strides {strides}")
    pad = MAX_DIMS - len(sizes)
    dense = x.is_contiguous() and x.data_ptr() % 16 == 0
    plan = pin_launch_plan(x.numel(), x.element_size(), dense,
                           kernel_lib.num_sms(x.device.index))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib_fn()(
            x.data_ptr(), out.data_ptr(), _DIMS(*([1] * pad + sizes)),
            _DIMS(*([0] * pad + strides)), x.element_size(),
            ctypes.byref(PinPlan.of(plan)), stream,
        )
    if err != 0:
        raise RuntimeError(f"pin_copy launch failed: CUDA error {err}")
    LAUNCHES["pin_copy"] += 1
    return out


# -- autograd -------------------------------------------------------------------


@torch.library.custom_op("dlrover_tpu_torch::pin_layout", mutates_args=())
def pin_layout_op(x: torch.Tensor) -> torch.Tensor:
    """:func:`pin_copy` as one op that autograd and selective
    checkpointing can see."""
    return pin_copy(x)


@pin_layout_op.register_fake
def _(x):
    return x.new_empty(x.shape)


def _backward(ctx, g):
    return pin_layout_op(g)


pin_layout_op.register_autograd(_backward)


def pin_layout(x: torch.Tensor) -> torch.Tensor:
    """Identity; returns ``x`` as a new dense row-major tensor, and pins
    the gradient that flows back through it the same way."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pin_layout has no kernel for {x.device}")
    return pin_layout_op(x)

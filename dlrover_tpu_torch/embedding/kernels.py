"""Row gather and row scatter for the hot-row cache (port of
``dlrover_tpu/embedding/kernels.py``).

The device cache (``embedding/device_cache.py``) keeps hot embedding rows
resident in a fixed ``[capacity, dim]`` fp32 tensor; every step gathers the
batch's slot set out of it and scatters fetched or updated rows back in.

- :func:`gather_rows` (K10a) returns ``cache[slots]`` as a NEW tensor,
  never a view: a later in-place scatter must not change rows a step still
  uses.
- :func:`scatter_rows` (K10b) writes ``rows`` into ``cache[slots]`` in
  place and returns the cache (the JAX version donates the buffer and the
  caller rebinds it).  Duplicate slots are only ever the scratch slot 0
  with identical zero padding rows, so write order among them does not
  matter.

Slots arrive as host arrays: each is checked to lie in ``[0, capacity)``
in numpy before the upload (a slot out of range raises; nothing is
clamped), then uploaded as int32.  On a CUDA tensor each call is one
launch of the hand-written kernels of ``ops/csrc/embedding_rows.cu``,
counted in :data:`LAUNCHES`, or an error; on a CPU tensor it is the plain
version beside it.  Shapes are fixed by the cache (slot arrays padded to
``max_unique``), so one call is one launch whatever the number of unique
keys: that replaces the JAX package's no-retrace counters.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dlrover_tpu_torch.ops import kernel_lib

#: Kernel launches of K10a and K10b; a run sets the counts to 0 and reads
#: them back to show its path went through the kernels.
LAUNCHES = {"embed_gather": 0, "embed_scatter": 0}


def gather_rows_reference(cache: torch.Tensor,
                          slots: torch.Tensor) -> torch.Tensor:
    """Plain version of K10a: ``cache[slots]`` as a new tensor."""
    return cache.index_select(0, slots.long())


def scatter_rows_reference_(cache: torch.Tensor, slots: torch.Tensor,
                            rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K10b: ``cache[slots] = rows`` in place."""
    return cache.index_copy_(0, slots.long(), rows)


def _host_slots(slots, capacity: int) -> np.ndarray:
    """``slots`` as a contiguous int32 host array, every slot checked to
    lie in ``[0, capacity)``."""
    s = np.asarray(slots)
    if s.ndim != 1 or not np.issubdtype(s.dtype, np.integer):
        raise ValueError(
            f"slots must be a 1-D integer array, got {s.dtype} {s.shape}")
    if s.size and (int(s.min()) < 0 or int(s.max()) >= capacity):
        raise IndexError(
            f"slot out of range [0, {capacity}): min {int(s.min())}, "
            f"max {int(s.max())}")
    return np.ascontiguousarray(s, np.int32)


def _check_cache(cache: torch.Tensor) -> None:
    if cache.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding rows have no kernel for {cache.device}")
    if cache.dtype != torch.float32 or cache.dim() != 2:
        raise TypeError(
            f"cache must be a 2-D float32 tensor, got {cache.dtype} "
            f"{tuple(cache.shape)}")
    if cache.device.type == "cuda" and not cache.is_contiguous():
        raise ValueError("the cache must be contiguous for the kernels")


_P = ctypes.c_void_p
# cache/src | slots | out/rows | n | dim | stream
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]


def _lib_fn(name: str):
    fn = getattr(kernel_lib.load("embedding_rows"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(cache: torch.Tensor, slots: torch.Tensor,
                  rows: torch.Tensor | None = None) -> None:
    """What the kernels read through raw pointers: a contiguous fp32 CUDA
    cache, contiguous 1-D int32 slots and (for the scatter) contiguous
    fp32 ``[len(slots), dim]`` rows, all on one device.  No device sync."""
    _check_cache(cache)
    if (slots.dtype != torch.int32 or slots.dim() != 1
            or not slots.is_contiguous() or slots.device != cache.device):
        raise ValueError(
            f"slots must be contiguous 1-D int32 on {cache.device}, got "
            f"{slots.dtype} {tuple(slots.shape)} on {slots.device}")
    if rows is not None and (
            rows.dtype != torch.float32
            or tuple(rows.shape) != (slots.numel(), cache.shape[1])
            or not rows.is_contiguous() or rows.device != cache.device):
        raise ValueError(
            f"rows must be contiguous float32 ({slots.numel()}, "
            f"{cache.shape[1]}) on {cache.device}, got {rows.dtype} "
            f"{tuple(rows.shape)} on {rows.device}")
    if cache.device.type != "cuda":
        raise ValueError(f"the kernels need a CUDA cache, got {cache.device}")


def gather_kernel(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """K10a on CUDA tensors: ``slots`` int32 on the cache's device, already
    range-checked.  Returns a new ``[len(slots), dim]`` tensor."""
    _check_launch(cache, slots)
    out = torch.empty((slots.numel(), cache.shape[1]), dtype=cache.dtype,
                      device=cache.device)
    with torch.cuda.device(cache.device):
        err = _lib_fn("embed_gather")(
            cache.data_ptr(), slots.data_ptr(), out.data_ptr(),
            slots.numel(), cache.shape[1], _stream(cache))
    if err != 0:
        raise RuntimeError(f"embed_gather launch failed: CUDA error {err}")
    LAUNCHES["embed_gather"] += 1
    return out


def scatter_kernel(cache: torch.Tensor, slots: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """K10b on CUDA tensors: ``slots`` int32 and ``rows`` contiguous fp32
    ``[len(slots), dim]`` on the cache's device, slots already
    range-checked.  Writes into ``cache`` and returns it."""
    _check_launch(cache, slots, rows)
    with torch.cuda.device(cache.device):
        err = _lib_fn("embed_scatter")(
            cache.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            slots.numel(), cache.shape[1], _stream(cache))
    if err != 0:
        raise RuntimeError(f"embed_scatter launch failed: CUDA error {err}")
    LAUNCHES["embed_scatter"] += 1
    return cache


def gather_rows(cache: torch.Tensor, slots) -> torch.Tensor:
    """``cache[slots]`` as a new ``[len(slots), dim]`` tensor.

    ``slots`` is a host int array (the cache's padded slot width); padded
    tail entries point at the scratch slot 0, whose rows the caller's
    inverse mapping never references.
    """
    _check_cache(cache)
    s = torch.from_numpy(_host_slots(slots, cache.shape[0]))
    if cache.device.type == "cpu":
        return gather_rows_reference(cache, s)
    return gather_kernel(cache, s.to(cache.device))


def scatter_rows(cache: torch.Tensor, slots, rows) -> torch.Tensor:
    """``cache[slots] = rows`` in place; returns ``cache``.

    ``rows`` (a host array or a tensor) is cast to float32 and must be
    ``[len(slots), dim]``.  Duplicate slot indices are only ever the
    scratch slot 0 with identical rows (padding).
    """
    _check_cache(cache)
    s = torch.from_numpy(_host_slots(slots, cache.shape[0]))
    r = torch.as_tensor(rows).to(device=cache.device, dtype=torch.float32)
    if tuple(r.shape) != (s.numel(), cache.shape[1]):
        raise ValueError(
            f"rows {tuple(r.shape)} != ({s.numel()}, {cache.shape[1]})")
    if cache.device.type == "cpu":
        return scatter_rows_reference_(cache, s, r)
    return scatter_kernel(cache, s.to(cache.device), r.contiguous())

"""Block quantization and the low-bit Adam optimizers (port of
``dlrover_tpu/ops/quantization.py``).

Scheme, as in the JAX module: symmetric absmax over blocks of ``BLOCK`` =
256 consecutive values of the flattened array.  :func:`quantize` gives
int8 codes ``[R, 256]`` and one fp32 scale per block ``[R]`` (``R =
ceil(n / 256)``; the last block is padded with zeros); :func:`dequantize`
inverts it.  :func:`q8_adam` and :func:`q4_adam` are AdamW with the first
and second moments of every leaf of at least ``min_quant_size`` values
held as such codes (smaller leaves keep fp32 moments and the exact Adam):

* q8: m linear in [-127, 127] with scale ``absmax / 127``; v in [0, 127]
  on a 4th-root map with scale ``max(v)``, decoded ``(code / 127)^4 *
  scale``.  2 + 8/256 bytes of state per parameter.
* q4: two codes per byte ``[R, 128]``: m signed in [-7, 7] on a sqrt map
  with scale ``absmax``, decoded ``sign(n) n^2 scale`` with ``n = code /
  7``; v in [0, 15] on the 4th-root map.  Byte j holds element 2j in its
  low nibble and 2j + 1 in its high.  1 + 8/256 bytes per parameter.

The JAX arrays carry TPU layout padding (rows padded to 8 or 512, scales
broadcast to 128 or 8 lanes); the port drops it, ``models/from_jax.
low_bit_state_from_jax`` carries a JAX state across.

On a CUDA tensor each of :func:`quantize` (K5a), :func:`dequantize`
(K5b), :func:`q8_adam_update` (K6) and :func:`q4_adam_update` (K7)
launches its hand-written Hopper kernel of ``ops/csrc/quantization.cu``
or raises; on a CPU tensor it takes the plain version beside it
(``*_reference``), which the CPU tests use and ``chip_smoke.py`` holds
the kernels against.  The kernels read the gradient and the parameter in
their own dtype (fp32 or bf16), write the update in the parameter's, and
update the moments in place (the JAX step donates its state); the plain
versions return new tensors.  Hyperparameters reach the kernels as fp32
arguments computed on the host (the step count is a host integer), so a
step reads nothing back from the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.ops import kernel_lib
from dlrover_tpu_torch.optimizers import optax_ports as ox

BLOCK = 256  # values per quantization block

#: Kernel launches of K5a, K5b, K6 and K7; a run sets them to 0 and reads
#: them back to show its path went through the kernels.
LAUNCHES = {"quantize": 0, "dequantize": 0, "q8_adam": 0, "q4_adam": 0}


class QMoment(NamedTuple):
    """A block-quantized moment: codes int8 ``[R, 256]`` (q4: ``[R,
    128]``) and scales fp32 ``[R]``."""

    q: torch.Tensor
    scales: torch.Tensor


class Q8AdamState(NamedTuple):
    count: int
    m: Dict[str, Any]  # name -> QMoment (large leaves) or fp32 tensor
    v: Dict[str, Any]


class Q4AdamState(NamedTuple):
    count: int
    m: Dict[str, Any]
    v: Dict[str, Any]


class AdamHyper(NamedTuple):
    """One step's scalars, each rounded to fp32 as the JAX kernels read
    them from their ``hyper`` array."""

    lr: float
    b1: float
    b2: float
    eps: float
    wd: float
    bias_scale: float


def num_blocks(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK


def adam_hyper(count: int, learning_rate: ox.ScalarOrSchedule, b1: float,
               b2: float, eps: float, weight_decay: float) -> AdamHyper:
    """The scalars of step ``count`` (1-based): the bias correction
    ``sqrt(1 - b2^t) / (1 - b1^t)`` in fp32 on the host, the schedule
    called with the step count as the JAX optimizer calls it."""
    t = np.float32(count)
    one = np.float32(1.0)
    bias_scale = (np.sqrt(one - np.float32(b2) ** t)
                  / (one - np.float32(b1) ** t))
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    return AdamHyper(*(ox._f32(x) for x in (lr, b1, b2, eps, weight_decay,
                                            bias_scale)))


# -- plain versions -------------------------------------------------------------


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """Any shape -> fp32 ``[R, 256]``, the tail zero-padded."""
    flat = x.reshape(-1).float()
    pad = num_blocks(flat.numel()) * BLOCK - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def _from_blocks(x2: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x2.reshape(-1)[: like.numel()].reshape(like.shape).to(like.dtype)


def _absmax_int8(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = x2.abs().amax(dim=1, keepdim=True)
    # Divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, an ulp off the quotient in some blocks.
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, 127.0))
    q = torch.clamp(torch.round(x2 / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def quantize_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5a: any-shape float -> ``(q int8 [R, 256], scales
    fp32 [R])``."""
    return _absmax_int8(_to_blocks(x))


def dequantize_reference(q: torch.Tensor, scales: torch.Tensor,
                         shape: Tuple[int, ...]) -> torch.Tensor:
    """Plain version of K5b: codes times their block's scale, fp32, the
    padding dropped."""
    n = int(np.prod(shape)) if len(shape) else 1
    out = q.float() * scales[:, None]
    return out.reshape(-1)[:n].reshape(shape)


def pack_nibbles(x_int: torch.Tensor) -> torch.Tensor:
    """``[R, 256]`` integers (signed in [-7, 7] or unsigned in [0, 15]) ->
    ``[R, 128]`` int8, ``lo & 0xF | (hi & 0xF) << 4`` per pair."""
    pairs = x_int.to(torch.int32).reshape(x_int.shape[0], BLOCK // 2, 2)
    byte = (pairs[..., 0] & 0xF) | ((pairs[..., 1] & 0xF) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def _nibbles(packed: torch.Tensor) -> torch.Tensor:
    byte = packed.view(torch.uint8).to(torch.int32)
    return torch.stack([byte & 0xF, byte >> 4], dim=-1).reshape(
        packed.shape[0], BLOCK)


def unpack_nibbles_unsigned(packed: torch.Tensor) -> torch.Tensor:
    """``[R, 128]`` int8 -> ``[R, 256]`` fp32 in [0, 15]."""
    return _nibbles(packed).float()


def unpack_nibbles_signed(packed: torch.Tensor) -> torch.Tensor:
    """``[R, 128]`` int8 -> ``[R, 256]`` fp32, nibbles sign-extended."""
    nib = _nibbles(packed)
    return torch.where(nib >= 8, nib - 16, nib).float()


def _adam(h: AdamHyper, g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor):
    """The kernels' Adam step in fp32, one rounding per operation and in
    their order (``1 - b`` taken in fp32)."""
    omb1 = float(np.float32(1.0) - np.float32(h.b1))
    omb2 = float(np.float32(1.0) - np.float32(h.b2))
    m = h.b1 * m + omb1 * g
    v = h.b2 * v + omb2 * g * g
    upd = -h.lr * (m * h.bias_scale / (torch.sqrt(v) + h.eps) + h.wd * p)
    return upd, m, v


def _sqrt_level(q: torch.Tensor, levels: float) -> torch.Tensor:
    """``round(levels * sqrt(q))`` clamped to [0, levels]: q4's m level
    of a quotient ``|m| / absmax`` in [0, 1]."""
    return torch.clamp(torch.round(levels * torch.sqrt(q)), 0, levels)


def _root4_level(q: torch.Tensor, levels: float) -> torch.Tensor:
    """``round(levels * q^(1/4))`` clamped to [0, levels]: v's code of a
    quotient ``v / max(v)`` in [0, 1]."""
    return torch.clamp(torch.round(levels * torch.sqrt(torch.sqrt(q))), 0,
                       levels)


def _root4_codes(v: torch.Tensor, levels: float):
    """v >= 0 spans many decades inside one block, and a linear map would
    flush the small values to 0: the code is linear in the 4th root."""
    v_max = v.amax(dim=1, keepdim=True)
    scale = torch.where(v_max == 0.0, torch.ones_like(v_max), v_max)
    return _root4_level(v / scale, levels), scale[:, 0]


def q8_adam_update_reference(g, p, m: QMoment, v: QMoment, h: AdamHyper):
    """Plain version of K6 -> ``(update in p's dtype, new m, new v)``."""
    m32 = m.q.float() * m.scales[:, None]
    v_norm = v.q.float() * float(np.float32(1.0 / 127.0))
    v32 = v_norm.square().square() * v.scales[:, None]
    upd, m32, v32 = _adam(h, _to_blocks(g), _to_blocks(p), m32, v32)
    v_codes, v_scale = _root4_codes(v32, 127.0)
    return (_from_blocks(upd, p), QMoment(*_absmax_int8(m32)),
            QMoment(v_codes.to(torch.int8), v_scale))


def _q4_m_decode(m: QMoment) -> torch.Tensor:
    """q4's first moment in fp32 ``[R, 256]``: ``sign(n) n^2 scale``, ``n
    = code / 7``."""
    m_n = unpack_nibbles_signed(m.q) * float(np.float32(1.0 / 7.0))
    return torch.sign(m_n) * m_n.square() * m.scales[:, None]


def _q4_v_decode(v: QMoment) -> torch.Tensor:
    """q4's second moment in fp32 ``[R, 256]``: ``(code / 15)^4 scale``."""
    v_norm = unpack_nibbles_unsigned(v.q) * float(np.float32(1.0 / 15.0))
    return v_norm.square().square() * v.scales[:, None]


def q4_adam_update_reference(g, p, m: QMoment, v: QMoment, h: AdamHyper):
    """Plain version of K7 -> ``(update in p's dtype, new m, new v)``."""
    m32, v32 = _q4_m_decode(m), _q4_v_decode(v)
    upd, m32, v32 = _adam(h, _to_blocks(g), _to_blocks(p), m32, v32)
    # sign(m) * round(7 sqrt(|m| / absmax)): the sqrt map puts the 15
    # levels near zero, where the momentum's mass lies.
    m_absmax = m32.abs().amax(dim=1, keepdim=True)
    m_scale = torch.where(m_absmax == 0.0, torch.ones_like(m_absmax),
                          m_absmax)
    m_level = _sqrt_level(m32.abs() / m_scale, 7.0)
    m_codes = (torch.sign(m32) * m_level).to(torch.int32)
    v_codes, v_scale = _root4_codes(v32, 15.0)
    return (_from_blocks(upd, p),
            QMoment(pack_nibbles(m_codes), m_scale[:, 0]),
            QMoment(pack_nibbles(v_codes.to(torch.int32)), v_scale))


# -- K7's maps -----------------------------------------------------------------


class Q4Maps(NamedTuple):
    """What K7 computes a q4 code's decode and a code from, instead of the
    plain version's roots (``ops/csrc/quantization.cu``, ``Q4Maps``).

    ``m_table[j]`` / ``v_table[j]``: the plain decode of nibble ``j`` at
    scale 1 (m's nibbles 8..15 are the codes -8..-1), so a value decodes
    to ``RN(table[nibble] * scale)``, bit for bit the plain version's.
    ``m_thresholds[k - 1]`` / ``v_thresholds[k - 1]``: the least float32
    quotient ``q`` in [0, 1] whose m level (``round(7 sqrt(q))``) or v
    code (``round(15 q^(1/4))``) is ``k`` or more; both maps are monotone
    in ``q``, so a code is the number of its thresholds ``<= q``."""

    m_table: Tuple[float, ...]       # 16
    v_table: Tuple[float, ...]       # 16
    m_thresholds: Tuple[float, ...]  # 7
    v_thresholds: Tuple[float, ...]  # 15


def _f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)


def _thresholds(level: Callable[[torch.Tensor, float], torch.Tensor],
                levels: int) -> Tuple[float, ...]:
    """The least float32 ``q`` in [0, 1] with ``level(q, levels) >= k``,
    for k = 1..levels, by bisection over the bit patterns of [0, 1]
    (ordered as the values are), through the plain version's own fp32
    chain on the CPU: ties fall as they fall there."""
    want = torch.arange(1, levels + 1, dtype=torch.float32)
    lo = torch.zeros(levels, dtype=torch.int64)            # level < k
    hi = torch.full((levels,), 0x3F800000, dtype=torch.int64)  # 1.0: >= k
    while bool((hi - lo > 1).any()):
        mid = (lo + hi) // 2
        up = level(_f32(mid), float(levels)) >= want
        hi, lo = torch.where(up, mid, hi), torch.where(up, lo, mid)
    return tuple(_f32(hi).tolist())


@functools.lru_cache(maxsize=None)
def q4_maps() -> Q4Maps:
    """K7's tables and thresholds, computed once from the plain chain."""
    nibbles = torch.arange(BLOCK, dtype=torch.int32) % 16
    signed = torch.where(nibbles >= 8, nibbles - 16, nibbles)
    one = torch.ones(1, dtype=torch.float32)
    m_table = _q4_m_decode(QMoment(pack_nibbles(signed[None]), one))
    v_table = _q4_v_decode(QMoment(pack_nibbles(nibbles[None]), one))
    return Q4Maps(tuple(m_table[0, :16].tolist()),
                  tuple(v_table[0, :16].tolist()),
                  _thresholds(_sqrt_level, 7),
                  _thresholds(_root4_level, 15))


# How K7 counts the thresholds <= q: by q's bin, its float32 bits >>
# BIN_SHIFT (exponent and two mantissa bits).  Bin 0 holds every q below
# 2^-24, bins 1 .. BINS - 2 the keys BIN_LOW .. BIN_HIGH (2^-24 to 1.0),
# the last bin every larger key (in K7 only NaN and -0.0 reach it).  The
# constants are the C source's (``quantization.cu``).
BIN_SHIFT = 21
BIN_LOW = 0x33800000 >> BIN_SHIFT    # 2^-24
BIN_HIGH = 0x3F800000 >> BIN_SHIFT   # 1.0
BINS = BIN_HIGH - BIN_LOW + 3


def q4_bins(thresholds: Tuple[float, ...]) -> Tuple[Tuple[float, int], ...]:
    """``(t, base)`` for each of the ``BINS`` bins: ``base`` thresholds lie
    at or below the bin's least float, and ``t`` is the one above that
    inside the bin (+inf if none), so a ``q`` of the bin has the code
    ``base + (q >= t)``.  Raises if a bin holds two thresholds or one lies
    below 2^-24."""
    bits = np.asarray(thresholds, dtype=np.float32).view(np.uint32)
    if (np.diff(bits.astype(np.int64)) <= 0).any() or bits.min() < (
            BIN_LOW << BIN_SHIFT):
        raise ValueError(f"thresholds {thresholds} are not increasing "
                         "floats from 2^-24")
    inf = float("inf")
    bins = [(inf, 0)]
    for key in range(BIN_LOW, BIN_HIGH + 1):
        least = key << BIN_SHIFT
        inside = bits[((bits >> BIN_SHIFT) == key) & (bits > least)]
        if len(inside) > 1:
            raise ValueError(f"bin {key:#x} holds thresholds {inside}")
        t = float(inside.view(np.float32)[0]) if len(inside) else inf
        bins.append((t, int((bits <= least).sum())))
    bins.append((inf, 0))
    return tuple(bins)


def q4_maps_words(maps: Q4Maps) -> np.ndarray:
    """The C struct ``Q4Maps`` as 32-bit words, in its order: the two
    tables, then m's and v's bins, each ``(t, base)``."""
    def bins(thresholds):
        t, base = zip(*q4_bins(thresholds))
        return np.stack([np.asarray(t, np.float32).view(np.uint32),
                         np.asarray(base, np.uint32)], axis=1).reshape(-1)

    tables = np.asarray(maps.m_table + maps.v_table, np.float32)
    return np.concatenate([tables.view(np.uint32), bins(maps.m_thresholds),
                           bins(maps.v_thresholds)])


def _maps_arg(maps: Q4Maps) -> ctypes.Array:
    words = q4_maps_words(maps)
    return (ctypes.c_uint32 * len(words))(*words.tolist())


@functools.lru_cache(maxsize=None)
def _q4_maps_arg() -> ctypes.Array:
    return _maps_arg(q4_maps())


# -- the CUDA kernels -----------------------------------------------------------

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_ARGTYPES = {
    # x q scales | n rows is_bf16 | stream
    "quantize_blocks": [_P] * 3 + [_LL] * 2 + [_I, _P],
    # q scales out | n rows | stream
    "dequantize_blocks": [_P] * 3 + [_LL] * 2 + [_P],
    # g p mq ms vq vs upd | n rows | bits is_bf16 | 6 scalars | q4 maps
    # | stream
    "low_bit_adam": [_P] * 7 + [_LL] * 2 + [_I] * 2 + [_F] * 6 + [_P, _P],
    # q4 maps scales | n_scales | counts | stream
    "q4_code_check": [_P] * 2 + [_I] + [_P] * 2,
}
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _lib_fn(fn_name: str):
    fn = getattr(kernel_lib.load("quantization"), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
    return fn


def _launch(fn_name: str, counter: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib_fn(fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def _check_values(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the quantization kernels take fp32 or bf16 "
                        f"{name}, got {t.dtype}")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty")
    if not t.is_contiguous():
        t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def _check_moment(name: str, mom: QMoment, rows: int, cols: int,
                  device: torch.device) -> None:
    q, scales = mom
    if (q.dtype != torch.int8 or tuple(q.shape) != (rows, cols)
            or scales.dtype != torch.float32
            or tuple(scales.shape) != (rows,)
            or not q.is_contiguous() or not scales.is_contiguous()
            or q.device != device or scales.device != device):
        raise ValueError(
            f"{name} must be contiguous (int8 [{rows}, {cols}], fp32 "
            f"[{rows}]) on {device}, got {q.dtype} {tuple(q.shape)} on "
            f"{q.device}, {scales.dtype} {tuple(scales.shape)} on "
            f"{scales.device}")


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape float -> ``(q int8 [R, 256], scales fp32 [R])``.  CPU
    tensors take :func:`quantize_reference`; CUDA tensors launch K5a
    (counted in ``LAUNCHES["quantize"]``) or raise."""
    if x.device.type == "cpu":
        return quantize_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize has no kernel for {x.device}")
    x = _check_values("x", x)
    n, rows = x.numel(), num_blocks(x.numel())
    q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _launch("quantize_blocks", "quantize", x.device, x.data_ptr(),
            q.data_ptr(), scales.data_ptr(), n, rows,
            int(x.dtype == torch.bfloat16))
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               shape: Tuple[int, ...]) -> torch.Tensor:
    """fp32 tensor of ``shape`` from :func:`quantize`'s codes and scales.
    CPU tensors take :func:`dequantize_reference`; CUDA tensors launch K5b
    (counted in ``LAUNCHES["dequantize"]``) or raise."""
    shape = tuple(int(s) for s in shape)
    if q.device.type == "cpu":
        return dequantize_reference(q, scales, shape)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize has no kernel for {q.device}")
    n = int(np.prod(shape)) if shape else 1
    if n <= 0:
        raise ValueError(f"shape {shape} is empty")
    rows = num_blocks(n)
    _check_moment("(q, scales)", QMoment(q, scales), rows, BLOCK, q.device)
    out = torch.empty(shape, dtype=torch.float32, device=q.device)
    _launch("dequantize_blocks", "dequantize", q.device, q.data_ptr(),
            scales.data_ptr(), out.data_ptr(), n, rows)
    return out


def _low_bit_update(bits: int, g, p, m: QMoment, v: QMoment, h: AdamHyper):
    if p.device.type == "cpu":
        reference = (q8_adam_update_reference if bits == 8
                     else q4_adam_update_reference)
        return reference(g, p, m, v, h)
    if p.device.type != "cuda":
        raise ValueError(f"q{bits}_adam has no kernel for {p.device}")
    if g.dtype != p.dtype or g.shape != p.shape or g.device != p.device:
        raise ValueError(
            f"the q{bits}_adam kernel takes a gradient of the parameter's "
            f"dtype, shape and device, got {g.dtype} {tuple(g.shape)} on "
            f"{g.device} for {p.dtype} {tuple(p.shape)} on {p.device}")
    g, p = _check_values("the gradient", g), _check_values("the param", p)
    n, rows = p.numel(), num_blocks(p.numel())
    cols = BLOCK * bits // 8
    _check_moment("m", m, rows, cols, p.device)
    _check_moment("v", v, rows, cols, p.device)
    upd = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    _launch("low_bit_adam", f"q{bits}_adam", p.device, g.data_ptr(),
            p.data_ptr(), m.q.data_ptr(), m.scales.data_ptr(),
            v.q.data_ptr(), v.scales.data_ptr(), upd.data_ptr(), n, rows,
            bits, int(p.dtype == torch.bfloat16), *h,
            _q4_maps_arg() if bits == 4 else None)
    return upd, m, v


def q8_adam_update(g: torch.Tensor, p: torch.Tensor, m: QMoment, v: QMoment,
                   h: AdamHyper) -> Tuple[torch.Tensor, QMoment, QMoment]:
    """One fused dequantize -> Adam -> requantize step of a leaf ->
    ``(update in p's dtype, m, v)``.  CPU tensors take
    :func:`q8_adam_update_reference` (new moments); CUDA tensors launch K6
    (counted in ``LAUNCHES["q8_adam"]``), which updates ``m`` and ``v`` in
    place, or raise."""
    return _low_bit_update(8, g, p, m, v, h)


def q4_adam_update(g: torch.Tensor, p: torch.Tensor, m: QMoment, v: QMoment,
                   h: AdamHyper) -> Tuple[torch.Tensor, QMoment, QMoment]:
    """:func:`q8_adam_update` with 4-bit moments: K7, counted in
    ``LAUNCHES["q4_adam"]``; plain version
    :func:`q4_adam_update_reference`."""
    return _low_bit_update(4, g, p, m, v, h)


def q4_code_check(scales: torch.Tensor, maps: Q4Maps = None) -> torch.Tensor:
    """K7's codes checked against the IEEE chain on the card: for each
    scale ``s`` (fp32, on a CUDA device), every float32 ``x`` in [0, s]
    through K7's path (one reciprocal, a corrected product, the bins of
    ``maps``' thresholds; :func:`q4_maps` by default) and through
    correctly rounded divisions and roots.  Returns int64 ``[len(scales),
    3]``: mismatching m levels, mismatching v codes, values checked."""
    if scales.device.type != "cuda" or scales.dtype != torch.float32:
        raise ValueError(f"q4_code_check takes fp32 scales on a CUDA "
                         f"device, got {scales.dtype} on {scales.device}")
    scales = scales.contiguous()
    counts = torch.zeros((scales.numel(), 3), dtype=torch.int64,
                         device=scales.device)
    with torch.cuda.device(scales.device):
        err = _lib_fn("q4_code_check")(
            _maps_arg(maps if maps is not None else q4_maps()),
            scales.data_ptr(), scales.numel(), counts.data_ptr(),
            torch.cuda.current_stream(scales.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"q4_code_check launch failed: CUDA error {err}")
    return counts


# -- the optimizers ---------------------------------------------------------------


def _low_bit_adam(bits: int, learning_rate, b1, b2, eps, weight_decay,
                  min_quant_size) -> ox.GradientTransformation:
    state_cls = Q8AdamState if bits == 8 else Q4AdamState

    def init_moment(name: str, p: torch.Tensor):
        # Decided on the leaf the optimizer sees: a block parameter's
        # layer-stacked leaf, as JAX decides on its scan-stacked one (the
        # whole leaf, when ``p`` is its ZeRO-1 shard).
        if int(np.prod(ox.full_shape(name, p))) < min_quant_size:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        rows = num_blocks(p.numel())
        return QMoment(
            torch.zeros((rows, BLOCK * bits // 8), dtype=torch.int8,
                        device=p.device),
            torch.ones((rows,), dtype=torch.float32, device=p.device))

    def init(params: ox.Tree):
        return state_cls(
            count=0,
            m={k: init_moment(k, p) for k, p in params.items()},
            v={k: init_moment(k, p) for k, p in params.items()})

    def update(grads: ox.Tree, state, params=None):
        if params is None:
            raise ValueError(f"q{bits}_adam requires params")
        count = state.count + 1
        h = adam_hyper(count, learning_rate, b1, b2, eps, weight_decay)
        updates, new_m, new_v = {}, {}, {}
        for name, g in grads.items():
            p, m, v = params[name], state.m[name], state.v[name]
            if isinstance(m, QMoment):
                out = _low_bit_update(bits, g, p, m, v, h)
            else:
                # The exact Adam in fp32, optax-style scalars: here 1 - b
                # is rounded to fp32 after the subtraction, as JAX's weak
                # Python scalars are.
                g32, p32 = g.float(), p.float()
                m = b1 * m + (1 - b1) * g32
                v = b2 * v + (1 - b2) * g32 * g32
                upd = -h.lr * (m * h.bias_scale / (torch.sqrt(v) + eps)
                               + weight_decay * p32)
                out = upd.to(p.dtype), m, v
            updates[name], new_m[name], new_v[name] = out
        return updates, state_cls(count, new_m, new_v)

    # A shard of a quantized leaf must be whole blocks of the leaf.
    return ox.GradientTransformation(init, update, BLOCK, min_quant_size)


def q8_adam(learning_rate: ox.ScalarOrSchedule = 1e-3, b1: float = 0.9,
            b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
            min_quant_size: int = 4096) -> ox.GradientTransformation:
    """AdamW with int8 block-quantized moments.  Leaves smaller than
    ``min_quant_size`` keep fp32 moments.  Chains like any transformation
    (``optax_ports.chain`` behind a clip); ``update`` needs ``params``."""
    return _low_bit_adam(8, learning_rate, b1, b2, eps, weight_decay,
                         min_quant_size)


def q4_adam(learning_rate: ox.ScalarOrSchedule = 1e-3, b1: float = 0.9,
            b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
            min_quant_size: int = 4096) -> ox.GradientTransformation:
    """AdamW with int4 block-quantized moments, two per byte; the same
    contract as :func:`q8_adam` at half the state."""
    return _low_bit_adam(4, learning_rate, b1, b2, eps, weight_decay,
                         min_quant_size)

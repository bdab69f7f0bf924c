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
from typing import Any, Dict, NamedTuple, Tuple

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


def _root4_codes(v: torch.Tensor, levels: float):
    """v >= 0 spans many decades inside one block, and a linear map would
    flush the small values to 0: the code is linear in the 4th root."""
    v_max = v.amax(dim=1, keepdim=True)
    scale = torch.where(v_max == 0.0, torch.ones_like(v_max), v_max)
    v_norm = torch.sqrt(torch.sqrt(v / scale))
    return torch.clamp(torch.round(levels * v_norm), 0, levels), scale[:, 0]


def q8_adam_update_reference(g, p, m: QMoment, v: QMoment, h: AdamHyper):
    """Plain version of K6 -> ``(update in p's dtype, new m, new v)``."""
    m32 = m.q.float() * m.scales[:, None]
    v_norm = v.q.float() * float(np.float32(1.0 / 127.0))
    v32 = v_norm.square().square() * v.scales[:, None]
    upd, m32, v32 = _adam(h, _to_blocks(g), _to_blocks(p), m32, v32)
    v_codes, v_scale = _root4_codes(v32, 127.0)
    return (_from_blocks(upd, p), QMoment(*_absmax_int8(m32)),
            QMoment(v_codes.to(torch.int8), v_scale))


def q4_adam_update_reference(g, p, m: QMoment, v: QMoment, h: AdamHyper):
    """Plain version of K7 -> ``(update in p's dtype, new m, new v)``."""
    m_n = unpack_nibbles_signed(m.q) * float(np.float32(1.0 / 7.0))
    m32 = torch.sign(m_n) * m_n.square() * m.scales[:, None]
    v_norm = unpack_nibbles_unsigned(v.q) * float(np.float32(1.0 / 15.0))
    v32 = v_norm.square().square() * v.scales[:, None]
    upd, m32, v32 = _adam(h, _to_blocks(g), _to_blocks(p), m32, v32)
    # sign(m) * round(7 sqrt(|m| / absmax)): the sqrt map puts the 15
    # levels near zero, where the momentum's mass lies.
    m_absmax = m32.abs().amax(dim=1, keepdim=True)
    m_scale = torch.where(m_absmax == 0.0, torch.ones_like(m_absmax),
                          m_absmax)
    m_level = torch.clamp(
        torch.round(7.0 * torch.sqrt(m32.abs() / m_scale)), 0, 7)
    m_codes = (torch.sign(m32) * m_level).to(torch.int32)
    v_codes, v_scale = _root4_codes(v32, 15.0)
    return (_from_blocks(upd, p),
            QMoment(pack_nibbles(m_codes), m_scale[:, 0]),
            QMoment(pack_nibbles(v_codes.to(torch.int32)), v_scale))


# -- the CUDA kernels -----------------------------------------------------------

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_ARGTYPES = {
    # x q scales | n rows is_bf16 | stream
    "quantize_blocks": [_P] * 3 + [_LL] * 2 + [_I, _P],
    # q scales out | n rows | stream
    "dequantize_blocks": [_P] * 3 + [_LL] * 2 + [_P],
    # g p mq ms vq vs upd | n rows | bits is_bf16 | 6 scalars | stream
    "low_bit_adam": [_P] * 7 + [_LL] * 2 + [_I] * 2 + [_F] * 6 + [_P],
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
            bits, int(p.dtype == torch.bfloat16), *h)
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


# -- the optimizers ---------------------------------------------------------------


def _low_bit_adam(bits: int, learning_rate, b1, b2, eps, weight_decay,
                  min_quant_size) -> ox.GradientTransformation:
    state_cls = Q8AdamState if bits == 8 else Q4AdamState

    def init_moment(p: torch.Tensor):
        # Decided on the leaf the optimizer sees: a block parameter's
        # layer-stacked leaf, as JAX decides on its scan-stacked one.
        if p.numel() < min_quant_size:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        rows = num_blocks(p.numel())
        return QMoment(
            torch.zeros((rows, BLOCK * bits // 8), dtype=torch.int8,
                        device=p.device),
            torch.ones((rows,), dtype=torch.float32, device=p.device))

    def init(params: ox.Tree):
        return state_cls(
            count=0,
            m={k: init_moment(p) for k, p in params.items()},
            v={k: init_moment(p) for k, p in params.items()})

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

    return ox.GradientTransformation(init, update)


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

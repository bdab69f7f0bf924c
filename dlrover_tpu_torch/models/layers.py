"""Shared NN building blocks (port of ``dlrover_tpu/models/layers.py``).

Parameter names and kernel layouts follow the JAX modules, so a JAX
parameter tree maps onto these modules by renaming alone
(``models/from_jax.py``): a ``DenseGeneral`` kernel is stored
``(in..., features...)`` and contracts the trailing input axes.

Weight dtypes follow the JAX modules: every parameter is held in
``param_dtype`` (fp32 by default) and cast to the compute ``dtype`` at
use (``layers.py:84, 104, 153``); norms take their statistics in fp32
(``layers.py:184, 230-232``).  The cast is a no-op when the two dtypes are
equal, which is how serving holds bf16 weights (``param_dtype=bfloat16``)
without an fp32 copy or a per-step cast.  Parameters are trainable.

Every parameter carries the reference's logical axis names
(``kernel_axes`` on :class:`DenseGeneral`, ``("vocab", "embed")`` on
:class:`Embed`, ``("norm",)`` on the norms; :func:`logical_axes` collects
them), which ``parallel/rules.py``'s table maps onto mesh axes.  Under a
tensor axis (``parallel/sharding.TensorGroup``) a layer is built with its
local features: a column-parallel ``DenseGeneral`` holds its columns, a
row-parallel one (``reduce=group.exit``) its rows and sums its partial
product over the group before the bias, and :class:`Embed` holds its
vocabulary rows (the lookup masks the others and sums over the group).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from dlrover_tpu_torch.ops import fused_norm, remat_policy
from dlrover_tpu_torch.parallel import rules as lr
from dlrover_tpu_torch.runtime.device import DeviceLike

Features = Union[int, Sequence[int]]


def _tuple(x: Features) -> Tuple[int, ...]:
    return (int(x),) if isinstance(x, int) else tuple(int(v) for v in x)


class DenseGeneral(nn.Module):
    """Linear map over the trailing ``len(in_shape)`` axes of ``x``.

    ``kernel`` is ``[*in_shape, *features]`` and ``bias`` ``[*features]``,
    as in the JAX module, both in ``param_dtype``; the product is one 2-D
    matmul in ``dtype`` over the flattened contraction and feature axes.
    ``transpose_kernel`` stores the kernel ``[*features, *in_shape]``
    instead (the same product, the other operand orientation; a
    checkpoint-format change, as in the reference).  ``kernel_axes``
    names every kernel dimension in the stored order (the bias takes the
    feature dimensions' names); ``reduce``, when given, is applied to the
    product before the bias (a row-parallel layer's sum over the tensor
    group).

    The product is a remat site (``ops/remat_policy.product``), a dot
    without batch dimensions, named ``save_name`` (a name or a tuple of
    names; the reference's ``checkpoint_name`` on the output after the
    bias).  With ``reduce`` the site is the product before the sum, which
    re-runs with the bias in a recompute.
    """

    def __init__(
        self,
        in_shape: Features,
        features: Features,
        *,
        kernel_axes: Tuple[Optional[str], ...] = (),
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        reduce=None,
        transpose_kernel: bool = False,
        save_name: Union[None, str, Tuple[str, ...]] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.in_shape = _tuple(in_shape)
        self.features = _tuple(features)
        self.transpose_kernel = transpose_kernel
        stored = (self.features + self.in_shape if transpose_kernel
                  else self.in_shape + self.features)
        if kernel_axes and len(kernel_axes) != len(stored):
            raise ValueError(f"kernel_axes {kernel_axes} must name every "
                             f"dim of {stored}")
        self.kernel_axes = tuple(kernel_axes)
        self.reduce = reduce
        self.dtype = dtype
        self.save_names: Tuple[str, ...] = (
            () if save_name is None else (save_name,)
            if isinstance(save_name, str) else tuple(save_name))
        self.kernel = nn.Parameter(
            torch.empty(stored, dtype=param_dtype, device=device)
        )
        self.bias = (
            nn.Parameter(
                torch.empty(self.features, dtype=param_dtype, device=device)
            )
            if use_bias else None
        )

    @property
    def fan_in(self) -> int:
        return math.prod(self.in_shape)

    @property
    def bias_axes(self) -> Tuple[Optional[str], ...]:
        """The feature dimensions' axis names (either stored order)."""
        n_f = len(self.features)
        return (self.kernel_axes[:n_f] if self.transpose_kernel
                else self.kernel_axes[len(self.in_shape):])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        batch = x.shape[: x.dim() - n_in]
        x2 = x.to(self.dtype).reshape(-1, self.fan_in)
        kernel = self.kernel.to(self.dtype)
        if self.transpose_kernel:
            k2 = kernel.reshape(-1, self.fan_in).t()
        else:
            k2 = kernel.reshape(self.fan_in, -1)
        shape = (*batch, *self.features)
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        if self.reduce is not None:
            out = remat_policy.product(x2, k2, shape=shape,
                                       names=self.save_names)
            out = self.reduce(out)
            return out + bias if bias is not None else out
        return remat_policy.product(x2, k2, bias=bias, shape=shape,
                                    names=self.save_names)


class Embed(nn.Module):
    """Token embedding ``[V, d]``; ``attend`` projects onto the (tied)
    table to give logits.  Under a tensor group (``tp``) the table holds
    this rank's ``V / size`` rows and ``attend`` gives their logits."""

    kernel_axes = (lr.VOCAB, lr.EMBED)

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        tp=None,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.tp = tp
        if tp is not None:
            num_embeddings //= tp.size
        self.embedding = nn.Parameter(
            torch.empty((num_embeddings, features), dtype=param_dtype,
                        device=device)
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.lookup(self.embedding, ids, self.dtype)
        # Gather, then cast: the rows of the cast table, without casting it.
        return self.embedding[ids].to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.embedding.to(self.dtype).t()


class RMSNorm(nn.Module):
    """Root-mean-square norm: fp32 statistics, result in the input dtype.
    ``fused_backward``: the one-pass backward kernel
    (``ops/fused_norm.fused_rmsnorm``), as on :class:`LayerNorm`."""

    kernel_axes = (lr.NORM,)

    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 param_dtype: torch.dtype = torch.float32,
                 fused_backward: bool = False,
                 device: DeviceLike = None):
        super().__init__()
        self.epsilon = epsilon
        self.fused_backward = fused_backward
        self.scale = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_backward:
            return fused_norm.fused_rmsnorm(x, self.scale, self.epsilon)
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.epsilon)
        # fp32 y times a param_dtype scale promotes to fp32 in one kernel.
        return (y * self.scale).to(x.dtype)


class LayerNorm(nn.Module):
    """GPT-2 layernorm: fp32 statistics, result in the input dtype.
    ``fused_backward`` routes through ``ops/fused_norm.fused_layernorm``,
    whose backward is one kernel pass over ``(x, dy)`` where autograd runs
    a chain of elementwise and reduction kernels; off by default, as in
    the JAX module."""

    kernel_axes = (lr.NORM,)

    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 use_bias: bool = True,
                 param_dtype: torch.dtype = torch.float32,
                 fused_backward: bool = False,
                 device: DeviceLike = None):
        super().__init__()
        self.epsilon = epsilon
        self.fused_backward = fused_backward
        self.scale = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device)
        )
        self.bias = (
            nn.Parameter(
                torch.zeros(features, dtype=param_dtype, device=device)
            )
            if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_backward:
            return fused_norm.fused_layernorm(x, self.scale, self.bias,
                                              self.epsilon)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale  # promotes to fp32 in the kernel, no cast launch
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def make_norm(kind: str, features: int, device: DeviceLike = None,
              param_dtype: torch.dtype = torch.float32,
              fused_backward: bool = False) -> nn.Module:
    if kind == "rmsnorm":
        return RMSNorm(features, param_dtype=param_dtype,
                       fused_backward=fused_backward, device=device)
    if kind == "layernorm":
        return LayerNorm(features, param_dtype=param_dtype,
                         fused_backward=fused_backward, device=device)
    raise ValueError(f"unknown norm kind {kind!r}")


def logical_axes(module: nn.Module) -> dict:
    """``{parameter name: logical axes}`` of ``module``'s own parameters
    (not its children's), as the reference names them."""
    out = {}
    if isinstance(module, DenseGeneral):
        out["kernel"] = module.kernel_axes
        if module.bias is not None:
            out["bias"] = module.bias_axes
    elif isinstance(module, (Embed, RMSNorm, LayerNorm)):
        for name, _ in module.named_parameters(recurse=False):
            out[name] = module.kernel_axes
    return out


def rotary_embedding(
    q: torch.Tensor,
    k: torch.Tensor,
    positions: torch.Tensor,
    rope_theta: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split rotary embedding on ``[B, S, H, D]`` q/k; ``positions``
    is ``[B or 1, S]``."""
    half = q.shape[-1] // 2
    freqs = 1.0 / (
        rope_theta ** (
            torch.arange(0, half, dtype=torch.float32, device=q.device)
            / half
        )
    )
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rotate(x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x1, x2 = x32[..., :half], x32[..., half:]
        return torch.cat(
            (x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1
        ).to(x.dtype)

    return rotate(q), rotate(k)


def normal_(param: torch.Tensor, std: float,
            generator: Optional[torch.Generator]) -> None:
    """Fill ``param`` in place from N(0, std^2) drawn in fp32."""
    with torch.no_grad():
        draw = torch.randn(
            param.shape, generator=generator, dtype=torch.float32,
            device=param.device,
        )
        param.copy_(draw.mul_(std))

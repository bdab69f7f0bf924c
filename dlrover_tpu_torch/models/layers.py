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
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from dlrover_tpu_torch.runtime.device import DeviceLike

Features = Union[int, Sequence[int]]


def _tuple(x: Features) -> Tuple[int, ...]:
    return (int(x),) if isinstance(x, int) else tuple(int(v) for v in x)


class DenseGeneral(nn.Module):
    """Linear map over the trailing ``len(in_shape)`` axes of ``x``.

    ``kernel`` is ``[*in_shape, *features]`` and ``bias`` ``[*features]``,
    as in the JAX module, both in ``param_dtype``; the product is one 2-D
    matmul in ``dtype`` over the flattened contraction and feature axes.
    """

    def __init__(
        self,
        in_shape: Features,
        features: Features,
        *,
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.in_shape = _tuple(in_shape)
        self.features = _tuple(features)
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(self.in_shape + self.features, dtype=param_dtype,
                        device=device)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        batch = x.shape[: x.dim() - n_in]
        x2 = x.to(self.dtype).reshape(-1, self.fan_in)
        out = x2 @ self.kernel.to(self.dtype).reshape(self.fan_in, -1)
        out = out.reshape(*batch, *self.features)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


class Embed(nn.Module):
    """Token embedding ``[V, d]``; ``attend`` projects onto the (tied)
    table to give logits."""

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty((num_embeddings, features), dtype=param_dtype,
                        device=device)
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # Gather, then cast: the rows of the cast table, without casting it.
        return self.embedding[ids].to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.embedding.to(self.dtype).t()


class RMSNorm(nn.Module):
    """Root-mean-square norm: fp32 statistics, result in the input dtype."""

    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.epsilon)
        # fp32 y times a param_dtype scale promotes to fp32 in one kernel.
        return (y * self.scale).to(x.dtype)


class LayerNorm(nn.Module):
    """GPT-2 layernorm: fp32 statistics, result in the input dtype."""

    def __init__(self, features: int, *, epsilon: float = 1e-5,
                 use_bias: bool = True,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        self.epsilon = epsilon
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
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale  # promotes to fp32 in the kernel, no cast launch
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def make_norm(kind: str, features: int, device: DeviceLike = None,
              param_dtype: torch.dtype = torch.float32) -> nn.Module:
    if kind == "rmsnorm":
        return RMSNorm(features, param_dtype=param_dtype, device=device)
    if kind == "layernorm":
        return LayerNorm(features, param_dtype=param_dtype, device=device)
    raise ValueError(f"unknown norm kind {kind!r}")


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

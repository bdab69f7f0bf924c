"""Mixture-of-experts MLP (port of ``dlrover_tpu/models/moe.py``).

Top-k routing over ``num_experts`` expert MLPs with a load-balancing aux
loss.  Two dispatches, as in the JAX layer with a unit expert axis:

* ``"einsum"``: the capacity dispatch; static ``[B, S, E, C]`` dispatch and
  combine tensors, tokens beyond an expert's capacity dropped.  ``"a2a"``
  and ``"a2a_int8"`` run it too, as the JAX layer does when the expert
  axis is 1 (the port has no mesh yet, so it always is).
* ``"grouped"``: the dropless dispatch.  Token choices are sorted by
  expert, each expert's group padded to ``gmm_block_rows`` rows, and each
  expert product is one :func:`~dlrover_tpu_torch.ops.grouped_matmul.
  grouped_matmul` (the CUDA kernels K8 and K9 on the card).  Every step is
  a device op: nothing is read back to the host, so the dispatch never
  stalls the stream.

Parameters follow the JAX tree: ``router.kernel [d, E]`` (fp32 compute,
no bias), ``wi [E, d, f]``, ``wo [E, f, d]`` and, for swiglu, ``wg [E, d,
f]``, all in ``param_dtype`` and cast to ``dtype`` at use.  The router
statistics the JAX layer ``sow``s are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.models import layers
from dlrover_tpu_torch.ops.grouped_matmul import grouped_matmul
from dlrover_tpu_torch.runtime.device import DeviceLike

DISPATCHES = ("einsum", "a2a", "a2a_int8", "grouped")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot by comparison (``F.one_hot`` checks its range on the
    host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def gate(logits: torch.Tensor, k: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shared top-k gate (JAX ``_gate``): ``(gate_vals [B, S, k]``
    renormalised to sum 1, ``gate_idx [B, S, k]``, ``aux_loss)`` with the
    load-balancing loss ``sum(top-1 density * mean prob) * E^2 / k``."""
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    density = _one_hot(gate_idx[..., 0], e).mean(dim=(0, 1))
    density_proxy = probs.mean(dim=(0, 1))
    aux_loss = (density * density_proxy).sum() * (e ** 2) / k
    return gate_vals, gate_idx, aux_loss


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k gating with per-expert capacity: ``(dispatch, combine,
    aux_loss)``, dispatch and combine ``[B, S, E, C]`` fp32.  Slots are
    assigned expert by expert in token order, earlier choice ranks first;
    a choice past its expert's capacity is dropped."""
    b, s, e = logits.shape
    gate_vals, gate_idx, aux_loss = gate(logits, k)
    dispatch = logits.new_zeros((b, s, e, capacity), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    prior = logits.new_zeros((b, 1, e), dtype=torch.float32)
    for choice in range(k):
        onehot = _one_hot(gate_idx[..., choice], e)           # [B, S, E]
        pos = torch.cumsum(onehot, dim=1) - onehot + prior   # queue position
        onehot = onehot * (pos < capacity)
        prior = prior + onehot.sum(dim=1, keepdim=True)
        slot = _one_hot((pos * onehot).sum(-1).long(), capacity)  # [B, S, C]
        d = onehot[..., None] * slot[..., None, :]            # [B, S, E, C]
        dispatch = dispatch + d
        combine = combine + d * gate_vals[..., choice][..., None, None]
    return dispatch, combine, aux_loss


class Routing(NamedTuple):
    """The dropless dispatch of :meth:`MoEMlp.route`: ``rows [n_pad, d]``
    holds each expert's token choices as one group padded to whole
    blocks (the padding rows zero), ``group_sizes [E]`` int32 the padded
    groups; choice ``i`` of the expert-sorted order sits in row
    ``dest[i]``, comes from token ``src_token[i]`` and is weighted by
    ``gates[i]`` in the combine."""

    rows: torch.Tensor
    group_sizes: torch.Tensor
    dest: torch.Tensor
    src_token: torch.Tensor
    gates: torch.Tensor
    aux_loss: torch.Tensor


class MoEMlp(nn.Module):
    """Top-k routed expert MLP: ``forward(x [B, S, d]) -> (out [B, S, d]
    in dtype, aux_loss fp32)``."""

    def __init__(
        self,
        d_model: int,
        num_experts: int,
        d_ff: int,
        *,
        top_k: int = 2,
        capacity_factor: float = 1.25,
        activation: str = "swiglu",
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        dispatch: str = "einsum",
        gmm_block_rows: int = 128,
        device: DeviceLike = None,
    ):
        super().__init__()
        if activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown activation {activation!r}")
        if dispatch not in DISPATCHES:
            raise ValueError(
                f"unknown MoE dispatch {dispatch!r}; expected one of "
                f"{list(DISPATCHES)}")
        if not 0 < top_k <= num_experts:
            raise ValueError(
                f"top_k {top_k} must be in [1, num_experts={num_experts}]")
        self.num_experts, self.d_ff = num_experts, d_ff
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.activation, self.dtype = activation, dtype
        self.dispatch, self.gmm_block_rows = dispatch, gmm_block_rows
        self.router = layers.DenseGeneral(
            d_model, num_experts, dtype=torch.float32,
            param_dtype=param_dtype, device=device)

        def expert(*shape):
            return nn.Parameter(torch.empty((num_experts, *shape),
                                            dtype=param_dtype, device=device))

        self.wi = expert(d_model, d_ff)
        self.wo = expert(d_ff, d_model)
        self.wg = expert(d_model, d_ff) if activation == "swiglu" else None

    def expert_params(self):
        """``(wi, wo[, wg])``: the ``[E, fan_in, fan_out]`` expert
        kernels."""
        return tuple(p for p in (self.wi, self.wo, self.wg) if p is not None)

    def _act(self, h: torch.Tensor, g: Optional[torch.Tensor]
             ) -> torch.Tensor:
        if g is not None:
            return F.silu(g) * h
        return F.gelu(h, approximate="tanh")  # flax nn.gelu's default

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        router_logits = self.router(x.float())
        wi = self.wi.to(self.dtype)
        wo = self.wo.to(self.dtype)
        wg = self.wg.to(self.dtype) if self.wg is not None else None
        if self.dispatch == "grouped":
            return self._grouped_forward(x, router_logits, wi, wg, wo)
        return self._einsum_forward(x, router_logits, wi, wg, wo)

    def _einsum_forward(self, x, router_logits, wi, wg, wo):
        b, s, _ = x.shape
        e = self.num_experts
        capacity = max(1, int(self.capacity_factor * s * self.top_k / e))
        dispatch, combine, aux_loss = top_k_gating(router_logits, self.top_k,
                                                   capacity)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(self.dtype),
                                 x.to(self.dtype))
        h = torch.einsum("ebcd,edf->ebcf", expert_in, wi)
        g = (torch.einsum("ebcd,edf->ebcf", expert_in, wg)
             if wg is not None else None)
        expert_out = torch.einsum("ebcf,efd->ebcd", self._act(h, g), wo)
        out = torch.einsum("bsec,ebcd->bsd", combine.to(self.dtype),
                           expert_out)
        return out, aux_loss.float()

    def route(self, x_flat: torch.Tensor, router_logits: torch.Tensor
              ) -> Routing:
        """Sort the token choices of ``x_flat [T, d]`` (router logits
        ``[T, E]``) by expert into padded groups: the JAX
        ``_grouped_forward`` up to the first grouped matmul, on the
        device."""
        t, d = x_flat.shape
        e, k = self.num_experts, self.top_k
        block = self.gmm_block_rows
        n = t * k
        # Static row budget: every token choice plus at most one partial
        # block of padding per expert, in whole kernel blocks.
        n_pad = ((n + block - 1) // block + e) * block
        gate_vals, gate_idx, aux_loss = gate(router_logits.reshape(1, t, e),
                                             k)
        experts_flat = gate_idx.reshape(n)
        gates_flat = gate_vals.reshape(n).to(self.dtype)

        # Stable sort by expert: each expert's choices become one
        # consecutive group.
        order = torch.argsort(experts_flat, stable=True)
        expert_sorted = experts_flat.index_select(0, order)
        src_token = torch.div(order, k, rounding_mode="floor")
        counts = torch.zeros(e, dtype=torch.long, device=x_flat.device)
        counts.scatter_add_(0, experts_flat, torch.ones_like(experts_flat))
        padded = (counts + block - 1) // block * block      # group sizes
        group_starts = torch.cumsum(padded, 0) - padded
        count_starts = torch.cumsum(counts, 0) - counts
        rank = (torch.arange(n, device=x_flat.device)
                - count_starts.index_select(0, expert_sorted))
        dest = group_starts.index_select(0, expert_sorted) + rank  # row slots
        rows = x_flat.new_zeros((n_pad, d)).index_copy(
            0, dest, x_flat.index_select(0, src_token))
        return Routing(rows, padded.to(torch.int32), dest, src_token,
                       gates_flat.index_select(0, order), aux_loss)

    def _grouped_forward(self, x, router_logits, wi, wg, wo):
        b, s, d = x.shape
        block = self.gmm_block_rows
        x_flat = x.reshape(b * s, d).to(self.dtype)
        r = self.route(x_flat, router_logits.reshape(b * s, -1))
        h = grouped_matmul(r.rows, wi, r.group_sizes, block)
        g = (grouped_matmul(r.rows, wg, r.group_sizes, block)
             if wg is not None else None)
        out_rows = grouped_matmul(self._act(h, g), wo, r.group_sizes, block)
        weighted = out_rows.index_select(0, r.dest) * r.gates[:, None]
        out = x_flat.new_zeros((b * s, d)).index_add(0, r.src_token,
                                                     weighted)
        return out.reshape(b, s, d), r.aux_loss.float()

"""Mixture-of-experts MLP (port of ``dlrover_tpu/models/moe.py``).

Top-k routing over ``num_experts`` expert MLPs with a load-balancing aux
loss.  The dispatches:

* ``"einsum"``: the capacity dispatch; static ``[B, S, E, C]`` dispatch and
  combine tensors, tokens beyond an expert's capacity dropped.
* ``"a2a"`` / ``"a2a_int8"``: the same math with an explicit all-to-all on
  the expert axis (the JAX ``_a2a_forward``).  Each rank gates its own
  batch chunk and builds its chunk's ``[E, b, C, D]`` expert inputs; the
  dispatch leg sends expert group ``r``'s rows to expert rank ``r``
  (``[E / ep, b * ep, C, D]``), the rank's experts run on every chunk,
  and the combine leg sends the results home.  ``"a2a_int8"`` puts both
  legs on the int8 wire (``parallel/quantized_collectives.
  quantized_all_to_all``: K5a and K5b on the card), forward and backward.
  With an expert axis of 1 all three are the einsum dispatch (no wire);
  ``"einsum"`` on an expert axis above 1 runs the plain exchange, the one
  GSPMD inserts for the reference.
* ``"grouped"``: the dropless dispatch.  Token choices are sorted by
  expert, each expert's group padded to ``gmm_block_rows`` rows, and each
  expert product is one :func:`~dlrover_tpu_torch.ops.grouped_matmul.
  grouped_matmul` (the CUDA kernels K8 and K9 on the card).  Every step is
  a device op: nothing is read back to the host, so the dispatch never
  stalls the stream.  It sees the rank's own rows only, so an expert axis
  above 1 raises, as in the reference.

The batch group (``parallel/sharding.ExpertGroup``: the ranks that split
the batch, ``data x expert``): the reference gates the global batch, so
its aux loss is ``sum(D * P) * E^2 / k`` with the top-1 density ``D`` and
the mean probability ``P`` over every rank's tokens.  Here each rank
averages its own tokens and the group averages the ranks' means (equal
chunks, so the means compose exactly) before the product.  Every rank's
loss then holds the same aux, so the group mean's backward leaves each
rank its own share (``1 / n`` of the cotangent, no second sum): the
gradients summed over the group are the reference's.

Router statistics (the JAX layer ``sow``s ``[entropy, drop_fraction,
load_0..load_{E-1}]`` in every forward): here they are computed only
inside :func:`collect_router_stats`, which ``trainer/train_lib.
build_moe_stats_fn`` opens around a forward of its own, never in the
step.  Entropy is averaged over the batch group and the routed counts
summed over it, so every rank holds the global vector.

Parameters follow the JAX tree: ``router.kernel [d, E]`` (fp32 compute,
no bias), ``wi [E, d, f]``, ``wo [E, f, d]`` and, for swiglu, ``wg [E, d,
f]``, all in ``param_dtype`` and cast to ``dtype`` at use; on an expert
axis of ``ep`` a rank holds ``E / ep`` experts, its block of dim 0.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.models import layers
from dlrover_tpu_torch.ops import remat_policy
from dlrover_tpu_torch.ops.grouped_matmul import grouped_matmul
from dlrover_tpu_torch.parallel import quantized_collectives as qc
from dlrover_tpu_torch.parallel import rules as lr
from dlrover_tpu_torch.runtime.device import DeviceLike

DISPATCHES = ("einsum", "a2a", "a2a_int8", "grouped")

#: The logical axes of an MoE layer's expert kernels (the router's are on
#: its ``DenseGeneral``).
KERNEL_AXES = {"wi": (lr.EXPERT, lr.EMBED, lr.MLP),
               "wg": (lr.EXPERT, lr.EMBED, lr.MLP),
               "wo": (lr.EXPERT, lr.MLP, lr.EMBED)}

#: The statistics vectors of the forward in progress, or None (not
#: collecting).
_STATS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def collect_router_stats() -> Iterator[List[torch.Tensor]]:
    """Within the block every MoE layer's forward appends its ``[2 + E]``
    fp32 statistics vector (``[entropy, drop_fraction, load...]``, over
    the batch group) to the yielded list, in layer order."""
    global _STATS
    prev, _STATS = _STATS, []
    try:
        yield _STATS
    finally:
        _STATS = prev


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot by comparison (``F.one_hot`` checks its range on the
    host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _group_means(density: torch.Tensor, proxy: torch.Tensor, group
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-1 density and the mean probability averaged over the
    batch group, in one collective (the density carries no gradient)."""
    if group is None:
        return density, proxy
    both = group.mean(torch.cat([density, proxy]))
    return both[:density.numel()], both[density.numel():]


def gate(logits: torch.Tensor, k: int, group=None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shared top-k gate (JAX ``_gate``): ``(gate_vals [B, S, k]``
    renormalised to sum 1, ``gate_idx [B, S, k]``, ``aux_loss)`` with the
    load-balancing loss ``sum(top-1 density * mean prob) * E^2 / k``, the
    two means over the batch group (``group``, this rank's tokens when
    None)."""
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    density, density_proxy = _group_means(
        _one_hot(gate_idx[..., 0], e).mean(dim=(0, 1)),
        probs.mean(dim=(0, 1)), group)
    aux_loss = (density * density_proxy).sum() * (e ** 2) / k
    return gate_vals, gate_idx, aux_loss


def top_k_gating(logits: torch.Tensor, k: int, capacity: int, group=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k gating with per-expert capacity: ``(dispatch, combine,
    aux_loss)``, dispatch and combine ``[B, S, E, C]`` fp32.  Slots are
    assigned expert by expert in token order within each batch row,
    earlier choice ranks first; a choice past its expert's capacity is
    dropped.  ``group`` as for :func:`gate`."""
    b, s, e = logits.shape
    gate_vals, gate_idx, aux_loss = gate(logits, k, group)
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


def router_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean per-token entropy of the router distribution (nats)."""
    probs = torch.softmax(logits.float(), dim=-1)
    return (-(probs * torch.log(probs + 1e-9)).sum(-1)).mean()


def _exchange(x: torch.Tensor, wire, split_axis: int, concat_axis: int,
              int8: bool) -> torch.Tensor:
    """One leg of the expert exchange on the expert axis's wire."""
    if int8:
        return qc.quantized_all_to_all(x, wire, split_axis=split_axis,
                                       concat_axis=concat_axis)
    return qc.all_to_all(x, wire, split_axis=split_axis,
                         concat_axis=concat_axis)


class Routing(NamedTuple):
    """The dropless dispatch of :meth:`MoEMlp.route`: ``rows [n_pad, d]``
    holds each expert's token choices as one group padded to whole
    blocks (the padding rows zero), ``group_sizes [E]`` int32 the padded
    groups; choice ``i`` of the expert-sorted order sits in row
    ``dest[i]``, comes from token ``src_token[i]`` and is weighted by
    ``gates[i]`` in the combine; ``counts [E]`` the choices each expert
    got."""

    rows: torch.Tensor
    group_sizes: torch.Tensor
    dest: torch.Tensor
    src_token: torch.Tensor
    gates: torch.Tensor
    aux_loss: torch.Tensor
    counts: Optional[torch.Tensor] = None


class MoEMlp(nn.Module):
    """Top-k routed expert MLP: ``forward(x [B, S, d]) -> (out [B, S, d]
    in dtype, aux_loss fp32)``.  ``group`` (``parallel/sharding.
    ExpertGroup``) is the mesh as the layer sees it: the expert axis (this
    rank holds ``num_experts / ep`` experts) and the batch group its
    router means are taken over; None at one rank."""

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
        group=None,
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
        self.ep = group.ep if group is not None else 1
        if dispatch == "grouped" and self.ep > 1:
            raise ValueError(
                "dispatch='grouped' runs the per-device grouped-GEMM kernels "
                f"and cannot shard over the {self.ep}-way 'expert' mesh "
                "axis: they only see local rows, so tokens of other ranks "
                "would multiply against the wrong experts.  Use dispatch="
                "'einsum', 'a2a' or 'a2a_int8' under expert parallelism")
        if num_experts % self.ep:
            raise ValueError(f"num_experts {num_experts} must divide by the "
                             f"{self.ep}-way expert axis")
        self.num_experts, self.d_ff = num_experts, d_ff
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.activation, self.dtype = activation, dtype
        self.dispatch, self.gmm_block_rows = dispatch, gmm_block_rows
        self.group = group
        self.router = layers.DenseGeneral(
            d_model, num_experts, kernel_axes=(lr.EMBED, None),
            dtype=torch.float32, param_dtype=param_dtype, device=device)
        local = num_experts // self.ep

        def expert(*shape):
            return nn.Parameter(torch.empty((local, *shape),
                                            dtype=param_dtype, device=device))

        self.wi = expert(d_model, d_ff)
        self.wo = expert(d_ff, d_model)
        self.wg = expert(d_model, d_ff) if activation == "swiglu" else None

    def expert_params(self):
        """``(wi, wo[, wg])``: the ``[E, fan_in, fan_out]`` expert
        kernels (this rank's ``E / ep`` experts)."""
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

    def _stats(self, router_logits, routed, total) -> None:
        """Book ``[entropy, drop_fraction, load...]`` over the batch group
        when collecting (the JAX ``_sow_router_stats``)."""
        if _STATS is None:
            return
        with torch.no_grad():
            entropy = router_entropy(router_logits)
            routed = routed.float()
            if self.group is not None:
                entropy = self.group.mean(entropy)
                routed = self.group.total(routed)
            kept = routed.sum()
            drop = 1.0 - kept / max(1, total)
            load = routed / torch.clamp(kept, min=1.0)
            _STATS.append(torch.cat([torch.stack([entropy, drop]), load]))

    def _batch_ranks(self) -> int:
        return self.group.batch_ranks if self.group is not None else 1

    def _einsum_forward(self, x, router_logits, wi, wg, wo):
        """The capacity dispatch; on an expert axis above 1 with its two
        exchange legs (the JAX ``_einsum_forward`` and ``_a2a_forward``)."""
        b, s, _ = x.shape
        e = self.num_experts
        capacity = max(1, int(self.capacity_factor * s * self.top_k / e))
        dispatch, combine, aux_loss = top_k_gating(
            router_logits, self.top_k, capacity, self.group)
        self._stats(router_logits, dispatch.sum(dim=(0, 1, 3)),
                    b * self._batch_ranks() * s * self.top_k)
        # Every einsum is a remat site, a dot with batch dimensions
        # (ops/remat_policy.einsum); the combine is the block's mlp_out.
        expert_in = remat_policy.einsum(
            "bsec,bsd->ebcd", dispatch.to(self.dtype), x.to(self.dtype))
        if self.ep > 1:
            # Dispatch leg: expert-split, batch-concat; each rank keeps its
            # experts' rows of every batch chunk: [E / ep, b * ep, C, D].
            expert_in = _exchange(expert_in, self.group.wire, 0, 1,
                                  self.dispatch == "a2a_int8")
        h = remat_policy.einsum("ebcd,edf->ebcf", expert_in, wi)
        g = (remat_policy.einsum("ebcd,edf->ebcf", expert_in, wg)
             if wg is not None else None)
        expert_out = remat_policy.einsum("ebcf,efd->ebcd", self._act(h, g),
                                         wo)
        if self.ep > 1:
            # Combine leg home, the exact inverse exchange: [E, b, C, D].
            expert_out = _exchange(expert_out, self.group.wire, 1, 0,
                                   self.dispatch == "a2a_int8")
        out = remat_policy.einsum("bsec,ebcd->bsd", combine.to(self.dtype),
                                  expert_out, names=("mlp_out",))
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
        gate_vals, gate_idx, aux_loss = gate(
            router_logits.reshape(1, t, e), k, self.group)
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
                       gates_flat.index_select(0, order), aux_loss, counts)

    def _grouped_forward(self, x, router_logits, wi, wg, wo):
        b, s, d = x.shape
        block = self.gmm_block_rows
        x_flat = x.reshape(b * s, d).to(self.dtype)
        r = self.route(x_flat, router_logits.reshape(b * s, -1))
        # Dropless: every choice is routed, so the drop fraction is 0.
        self._stats(router_logits, r.counts,
                    b * self._batch_ranks() * s * self.top_k)
        h = grouped_matmul(r.rows, wi, r.group_sizes, block)
        g = (grouped_matmul(r.rows, wg, r.group_sizes, block)
             if wg is not None else None)
        out_rows = grouped_matmul(self._act(h, g), wo, r.group_sizes, block)
        weighted = out_rows.index_select(0, r.dest) * r.gates[:, None]
        # The combine is the block's remat site mlp_out.
        out = remat_policy.index_add_rows(b * s, r.src_token, weighted,
                                          names=("mlp_out",))
        return out.reshape(b, s, d), r.aux_loss.float()

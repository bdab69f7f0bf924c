"""Serve-side tensor parallelism: one logical model folded across ranks
(port of ``dlrover_tpu/serving/tp.py``).

The *logical* TP width is fixed when the engine is built and names the
program family (the program memo's key carries ``(logical_tp,
physical_tp)``); a resize changes only the *physical* fold, how many
ranks the logical shards currently land on.  A physical width divides
the logical one, so every head shard stays whole on one rank: rank ``r``
of a fold of ``physical_tp`` holds logical shards ``[r * fold, (r + 1) *
fold)``, which is the tensor split of degree ``physical_tp``.

The reference lays the model out with GSPMD under a rule table.  The
port has no partitioner: a rank of the fold is one process of the
default ``torch.distributed`` group (ranks ``0 .. physical_tp - 1``), its
model is built on the tensor axis of the training model
(``parallel/sharding.TensorGroup`` over the fold's
:class:`~dlrover_tpu_torch.parallel.wire.Wire`) under
:data:`SERVE_TP_RULES`, the reference's table, and each rank holds its
slice of every leaf (:meth:`ServeTPMesh.split_params`, through
``models/from_jax.shard_state_dict``):

* attention q/k/v and the MLP's wi/wg column-split (``heads``/``mlp``
  over ``tensor``), attention out and the MLP's wo row-split and summed
  over the fold (two sums a layer);
* the embedding and the head vocab-split: the lookup masks and sums, and
  the head gives each rank ``[rows, V / tp]`` logits, which the decode
  operations gather whole before sampling, so every rank draws the same
  token in the same row from identically seeded generators;
* activations between blocks whole (replicated);
* the paged KV pool split on its heads axis: ``[layers, slots,
  max_seq_len, H_kv / tp, head_dim]`` a rank, so per-rank pool bytes
  fall as 1/tp (:meth:`ServeTPMesh.pool_device_bytes`, the largest per
  rank).

Ranks at or past the physical width are out of the fold: they hold no
model and no pool until a fold takes them in again
(``ServingEngine.fold_tp``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel import rules as lr
from dlrover_tpu_torch.runtime import mesh as mesh_lib
from dlrover_tpu_torch.runtime.mesh import MESH_AXES, TENSOR_AXIS

#: The serving TP rule table (the reference's): params split
#: Megatron-style over the ``tensor`` axis, activations replicated at
#: block boundaries, heads sharded inside attention.
SERVE_TP_RULES: List[Tuple[str, Any]] = [
    (lr.BATCH, None),
    (lr.ACT_SEQ, None),
    (lr.ACT_EMBED, None),
    (lr.ACT_HEADS, TENSOR_AXIS),
    (lr.EMBED, None),
    (lr.KV, None),
    (lr.NORM, None),
    (lr.GATHERED, None),
    (lr.MLP, TENSOR_AXIS),
    (lr.HEADS, TENSOR_AXIS),
    (lr.VOCAB, TENSOR_AXIS),
    (lr.EXPERT, None),
    (lr.STAGES, None),
    (lr.LAYERS, None),
]


def fold_width(logical_tp: int, available: int) -> int:
    """Largest divisor of ``logical_tp`` that fits in ``available`` ranks:
    the fold rule for the serve TP axis (divisibility keeps every head
    shard whole on one rank)."""
    if logical_tp < 1 or available < 1:
        raise ValueError(
            f"logical_tp and available must be >= 1, got "
            f"{logical_tp}/{available}"
        )
    for width in range(min(logical_tp, available), 0, -1):
        if logical_tp % width == 0:
            return width
    return 1


def validate_tp_config(config, logical_tp: int) -> None:
    """TP width must divide the head counts (Q heads for the projections,
    KV heads for the pool's shard axis), the vocab (embedding split) and
    ``d_ff``.  Raises ``ValueError`` with the failing dimension named."""
    kv_heads = config.num_kv_heads or config.num_heads
    for name, size in (
        ("num_heads", config.num_heads),
        ("num_kv_heads", kv_heads),
        ("vocab_size", config.vocab_size),
        ("d_ff", config.resolved_d_ff),
    ):
        if size % logical_tp:
            raise ValueError(
                f"tp={logical_tp} must divide {name}={size}"
            )


class _FoldMesh:
    """What the port's mesh helpers ask of a mesh: the six axis names and
    their sizes, the tensor axis at the fold's width."""

    mesh_dim_names = MESH_AXES

    def __init__(self, tensor: int):
        self.shape = tuple(tensor if a == TENSOR_AXIS else 1
                           for a in MESH_AXES)


#: Process groups of the first n ranks, by n (one ``new_group`` each,
#: made by every rank of the default group in the same order).
_GROUPS: Dict[int, Any] = {}


def _group(n: int):
    if n not in _GROUPS:
        if n == mesh_lib.process_count():
            _GROUPS[n] = None  # the default group
        else:
            _GROUPS[n] = dist.new_group(list(range(n)))
    return _GROUPS[n]


class ServeTPMesh:
    """A fixed logical TP width folded onto the first ``physical_tp`` ranks
    of the default group, seen from rank ``rank``.  :meth:`fold_to`
    returns the re-folded view a resize swaps in."""

    def __init__(self, logical_tp: int, physical_tp: int, rank: int = 0):
        if logical_tp < 1 or physical_tp < 1:
            raise ValueError(
                f"tp widths must be >= 1, got logical={logical_tp} "
                f"physical={physical_tp}"
            )
        if logical_tp % physical_tp:
            raise ValueError(
                f"physical_tp {physical_tp} must divide logical_tp "
                f"{logical_tp} (head shards stay device-whole)"
            )
        self.logical_tp = logical_tp
        self.physical_tp = physical_tp
        self.rank = rank
        self.mesh = _FoldMesh(physical_tp)

    @property
    def fold(self) -> int:
        """Logical head shards per rank at the current fold."""
        return self.logical_tp // self.physical_tp

    @property
    def member(self) -> bool:
        """Whether this rank holds a shard at the current fold."""
        return self.rank < self.physical_tp

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        """The resize-invariant program-family shape: the mesh with its
        tensor axis at the logical width."""
        return _FoldMesh(self.logical_tp).shape

    def fold_to(self, physical_tp: int) -> "ServeTPMesh":
        """The same logical model folded onto ``physical_tp`` ranks (every
        rank of the default group calls it: a new fold's group is made
        on all of them)."""
        return build_tp_mesh(self.logical_tp, physical_tp)

    @functools.cached_property
    def wire(self):
        """The fold's wire (its tensor axis), None at one rank or out of
        the fold."""
        from dlrover_tpu_torch.parallel.wire import Wire

        if self.physical_tp == 1 or not self.member:
            return None
        return Wire(_group(self.physical_tp), axis=TENSOR_AXIS)

    def parallel(self, rank: Optional[int] = None):
        """The fold's ``parallel/sharding.ModelParallel`` for ``rank``
        (default: this one) under :data:`SERVE_TP_RULES`: what the
        decode-mode model of a rank is built with."""
        from dlrover_tpu_torch.parallel.sharding import ModelParallel

        rank = self.rank if rank is None else rank
        wires = {TENSOR_AXIS: self.wire} if self.wire is not None else {}
        return ModelParallel(self.mesh, SERVE_TP_RULES, wires, rank=rank)

    def layouts(self, config) -> Dict[str, Any]:
        """``{name: parallel.sharding.LeafSplit}`` of the decode model's
        state dict at this fold."""
        from dlrover_tpu_torch.models.transformer import (
            TransformerLM,
            param_logical_axes,
            param_shapes,
        )

        axes = param_logical_axes(TransformerLM(config, device="meta"))
        return self.parallel().layouts(axes, param_shapes(config))

    def split_params(self, params: Mapping[str, Any], config,
                     rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Rank ``rank``'s slice of every leaf of a whole state dict
        (``models/from_jax.shard_state_dict`` under the fold's layouts); a
        state dict already at the rank's shapes passes as it is."""
        from dlrover_tpu_torch.models.from_jax import shard_state_dict

        layouts = self.layouts(config)
        par = self.parallel(rank)
        local = {n: lay.local_shape(par.sizes) for n, lay in layouts.items()}
        if all(tuple(params[n].shape) == s for n, s in local.items()):
            return dict(params)
        return shard_state_dict(params, layouts, par)

    def kv_heads(self, config) -> int:
        """KV heads a rank's pool holds."""
        return config.resolved_kv_heads // self.physical_tp

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """``[..., V / tp]`` logits of every rank of the fold -> the whole
        ``[..., V]`` on each (rank ``r`` holds vocabulary rows ``[r * V /
        tp, (r + 1) * V / tp)``)."""
        if self.wire is None:
            return logits
        local = logits.contiguous()
        out = torch.empty((self.physical_tp,) + tuple(local.shape),
                          dtype=local.dtype, device=local.device)
        self.wire.all_gather(out, local)
        return out.movedim(0, -2).reshape(tuple(local.shape[:-1]) + (-1,))

    def pool_device_bytes(self, config, slots: int) -> int:
        """The largest per-rank byte count of a pool of ``slots`` slots
        (its K and V) at this fold: the capacity number that falls as
        1/tp.  Every rank of a fold holds the same ``H_kv / physical_tp``
        heads, so it is one rank's pool, and the fold's number on a
        parked rank too."""
        itemsize = torch.empty((), dtype=config.dtype).element_size()
        return (2 * config.num_layers * slots * config.max_seq_len
                * self.kv_heads(config) * config.resolved_head_dim
                * itemsize)

def build_tp_mesh(logical_tp: int,
                  physical_tp: Optional[int] = None) -> ServeTPMesh:
    """The serve TP fold over the default process group: the first
    ``physical_tp`` ranks hold the logical model's shards.
    ``physical_tp=None`` folds the logical width onto however many
    processes there are (:func:`fold_width`)."""
    world = mesh_lib.process_count()
    if physical_tp is None:
        physical_tp = fold_width(logical_tp, world)
    if physical_tp > world:
        raise ValueError(
            f"physical_tp {physical_tp} exceeds the {world} processes of "
            f"the default group"
        )
    mesh = ServeTPMesh(logical_tp, physical_tp, mesh_lib.process_index())
    if world > 1:
        # Every rank makes the fold's group now, in the same order.
        _group(physical_tp)
    return mesh

"""ZeRO-1: cross-replica sharding of the weight update (port of
``dlrover_tpu/optimizers/zero1.py``).

In pure data parallelism the optimizer state and the update are computed
identically on every replica.  The reference extends each leaf's
``PartitionSpec`` with the ``data`` axis on one divisible dimension and
lets GSPMD lower the gradient sum as a reduce-scatter feeding a
shard-local update, and the re-replication as an all-gather.  The spec
functions here are the reference's on a plain spec (a tuple with one
entry per dimension: None, an axis name or a tuple of names).

:class:`ShardPlan` turns the specs into what each rank holds: for every
leaf of the (layer-stacked) parameter tree, the dimension the data axis
splits (or None: the leaf keeps a replicated update) and rank ``r``'s
slice ``[r * k, (r + 1) * k)`` of it.  Under the fsdp and tensor axes
the spec of a leaf carries them (``mesh_sizes`` gives their degrees):
the data axis goes on the first dimension that stays whole after both
splits, as ``zero1_partition_spec`` chooses it, and the plan's shapes
are a rank's fsdp/tensor slices, which the data axis splits further.
``block`` adds one rule an optimizer with block-quantized state needs: a
leaf is split only where each rank's slice is a whole number of
``block``-value blocks of the flattened slice (a contiguous range, so
the blocks of a shard are the blocks of the slice, and, where the
fsdp/tensor slice is whole blocks of the whole leaf, of the leaf).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

Spec = Tuple[Any, ...]


def _entry_names(entry) -> Tuple[str, ...]:
    """Normalize one spec entry to a tuple of mesh-axis names."""
    if entry is None:
        return ()
    if isinstance(entry, tuple):
        return tuple(entry)
    return (entry,)


def _dim_shard(mesh_sizes: Dict[str, int], entry) -> int:
    out = 1
    for name in _entry_names(entry):
        out *= mesh_sizes.get(name, 1)
    return out


def zero1_partition_spec(
    shape: Tuple[int, ...],
    spec: Spec,
    mesh_sizes: Dict[str, int],
    axis: str = "data",
) -> Optional[Spec]:
    """The update-sharded spec for one leaf, or None.

    Appends ``axis`` to the first dimension that stays whole-sized after
    the split (``dim % (existing_shard * dp) == 0``).  Returns None when
    the leaf cannot take the axis: scalars, leaves already sharded over
    ``axis`` somewhere, or leaves with no divisible dimension (the caller
    keeps the replicated update for that leaf).
    """
    dp = mesh_sizes.get(axis, 1)
    if dp <= 1 or not shape:
        return None
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for entry in entries:
        if axis in _entry_names(entry):
            return None  # already laid out over the data axis
    for i, dim in enumerate(shape):
        cur = _dim_shard(mesh_sizes, entries[i])
        if dim > 0 and dim % (cur * dp) == 0:
            new_entry = (*_entry_names(entries[i]), axis)
            new_entries = list(entries)
            new_entries[i] = new_entry[0] if len(new_entry) == 1 \
                else new_entry
            return tuple(new_entries)
    return None


def _dim_shard_total(mesh_sizes: Dict[str, int], spec: Spec) -> int:
    out = 1
    for entry in spec:
        out *= _dim_shard(mesh_sizes, entry)
    return out


def data_axis_dim(spec: Optional[Spec], axis: str = "data") -> Optional[int]:
    """Which dimension of ``spec`` carries ``axis`` (None when absent)."""
    if spec is None:
        return None
    for i, entry in enumerate(spec):
        if axis in _entry_names(entry):
            return i
    return None


def shard_update_shardings(
    mesh_sizes: Dict[str, int],
    leaves: Dict[str, Tuple[Tuple[int, ...], int]],
    specs: Dict[str, Spec],
    axis: str = "data",
) -> Tuple[Dict[str, Optional[Spec]], Dict[str, Any]]:
    """Map ``{name: (shape, itemsize)}`` with ``{name: spec}`` to ZeRO-1
    specs.

    Returns ``(new_specs, stats)``: every shardable leaf gets the
    ``axis``-extended spec from :func:`zero1_partition_spec`, the rest
    keep their own.  ``stats`` has the reference's keys: per-device bytes
    before and after and the leaf counts."""
    dp = mesh_sizes.get(axis, 1)
    stats = {
        "axis": axis,
        "dp": dp,
        "sharded_leaves": 0,
        "replicated_leaves": 0,
        "bytes_per_device_before": 0,
        "bytes_per_device_after": 0,
    }
    out: Dict[str, Optional[Spec]] = {}
    for name, (shape, itemsize) in leaves.items():
        spec = specs.get(name, ())
        nbytes = math.prod(shape) * itemsize
        before = nbytes / max(1, _dim_shard_total(mesh_sizes, spec))
        zspec = zero1_partition_spec(tuple(shape), spec, mesh_sizes, axis)
        stats["bytes_per_device_before"] += before
        if zspec is None:
            stats["replicated_leaves"] += 1
            stats["bytes_per_device_after"] += before
            out[name] = spec
        else:
            stats["sharded_leaves"] += 1
            stats["bytes_per_device_after"] += before / dp
            out[name] = zspec
    return out, stats


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """One leaf's layout: the whole shape, and the dimension the data axis
    splits into ``dp`` equal slices (None: replicated)."""

    shape: Tuple[int, ...]
    dim: Optional[int]
    dp: int

    @property
    def chunk(self) -> int:
        return self.shape[self.dim] // self.dp if self.dim is not None else 0

    def local_shape(self) -> Tuple[int, ...]:
        if self.dim is None:
            return self.shape
        out = list(self.shape)
        out[self.dim] = self.chunk
        return tuple(out)

    def index(self, rank: int) -> Tuple[Tuple[int, int], ...]:
        """Rank ``rank``'s slice as ``(start, stop)`` per dimension."""
        out = [(0, d) for d in self.shape]
        if self.dim is not None:
            out[self.dim] = (rank * self.chunk, (rank + 1) * self.chunk)
        return tuple(out)

    def take(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of the whole leaf ``t`` (a view)."""
        if self.dim is None:
            return t
        return t.narrow(self.dim, rank * self.chunk, self.chunk)


class ShardPlan:
    """Every leaf's :class:`LeafShard` for a ``dp``-way data axis.

    ``shapes`` is ``{name: shape}`` of the whole leaves; ``specs`` their
    model-parallel specs (empty: replicated) on a mesh of ``mesh_sizes``
    (the model-parallel degrees); ``block`` > 0 asks that a split leaf's
    slices be contiguous, whole ``block``-value blocks of the flattened
    leaf.  Each :class:`LeafShard` describes the rank's model-parallel
    slice of its leaf."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], dp: int, *,
                 specs: Optional[Dict[str, Spec]] = None, block: int = 0,
                 itemsizes: Optional[Dict[str, int]] = None,
                 mesh_sizes: Optional[Dict[str, int]] = None):
        self.dp = dp
        self.block = block
        sizes = dict(mesh_sizes or {})
        sizes["data"] = dp
        specs = specs or {}
        self.leaves: Dict[str, LeafShard] = {}
        for name, shape in shapes.items():
            shape = tuple(int(d) for d in shape)
            spec = specs.get(name, ())
            local = tuple(d // _dim_shard(sizes, e) for d, e in zip(
                shape, tuple(spec) + (None,) * (len(shape) - len(spec))))
            dim = data_axis_dim(zero1_partition_spec(shape, spec, sizes))
            if dim is not None and block and not self._aligned(local, dim):
                dim = None
            self.leaves[name] = LeafShard(local, dim, dp)
        _, self.stats = shard_update_shardings(
            sizes,
            {n: (tuple(int(d) for d in shapes[n]),
                 (itemsizes or {}).get(n, 4)) for n in self.leaves},
            specs)
        self.stats["sharded_leaves"] = sum(
            leaf.dim is not None for leaf in self.leaves.values())
        self.stats["replicated_leaves"] = len(self.leaves) - \
            self.stats["sharded_leaves"]
        self.stats["bytes_per_device_after"] = sum(
            math.prod(leaf.local_shape()) * (itemsizes or {}).get(n, 4)
            for n, leaf in self.leaves.items())

    def _aligned(self, shape: Tuple[int, ...], dim: int) -> bool:
        outer = math.prod(shape[:dim])
        per_rank = math.prod(shape) // self.dp
        return outer == 1 and per_rank % self.block == 0

    def __getitem__(self, name: str) -> LeafShard:
        return self.leaves[name]

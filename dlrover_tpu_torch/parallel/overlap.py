"""Bucketed collective schedule: structural comm/compute overlap (port of
``dlrover_tpu/parallel/overlap.py``).

:func:`plan_buckets` splits the gradient tree into ~``bucket_mb``-MB
buckets (greedy fill in the reference's leaf order, the order its
``tree_leaves`` gives), and :class:`OverlapPlan` is the reference's, field
for field.

The reference orders its per-bucket collectives with an
``optimization_barrier`` staircase inside one XLA program.  Its torch
counterpart is :class:`BucketIssuer`: each bucket's collectives are
issued asynchronously as soon as the backward has produced every
gradient of the bucket (``Tensor.register_post_accumulate_grad_hook``),
but always in the plan's order, never in the order the hooks fire, so
every rank issues the same sequence and the collectives match.  They are
waited before the update.  Reduce-scatter is linear, so scattering each
microbatch's gradient and accumulating the shards equals scattering the
accumulated gradient; the wire rides under the rest of the backward and
the accumulator is 1/dp of the parameter bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

# Default bucket size: big enough that per-bucket launch latency
# amortizes, small enough that several buckets exist to pipeline.
DEFAULT_BUCKET_MB = 4.0


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Static assignment of gradient-tree leaves to collective buckets.

    ``buckets`` holds leaf indices in tree order; every leaf appears in
    exactly one bucket, and buckets preserve leaf order.
    """

    buckets: Tuple[Tuple[int, ...], ...]
    bucket_bytes: Tuple[int, ...]
    bucket_mb: float
    total_bytes: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def num_leaves(self) -> int:
        return sum(len(b) for b in self.buckets)

    def describe(self) -> dict:
        """Summary stats (the train's bookkeeping)."""
        return {
            "num_buckets": self.num_buckets,
            "num_leaves": self.num_leaves,
            "bucket_mb": self.bucket_mb,
            "total_mb": round(self.total_bytes / 1e6, 3),
            "bucket_bytes": list(self.bucket_bytes),
        }


def _leaf_size(leaf) -> int:
    """Elements of a leaf: a tensor or array, a shape, or a count."""
    if isinstance(leaf, int):
        return leaf
    if isinstance(leaf, (tuple, list)):
        out = 1
        for d in leaf:
            out *= int(d)
        return out
    numel = getattr(leaf, "numel", None)
    if callable(numel):
        return int(numel())
    size = getattr(leaf, "size", None)
    if isinstance(size, int):
        return size
    shape = getattr(leaf, "shape", ())
    out = 1
    for d in shape:
        out *= int(d)
    return out


def plan_buckets(
    leaves: Sequence,
    bucket_mb: float = DEFAULT_BUCKET_MB,
    *,
    dtype_bytes: int = 4,
) -> OverlapPlan:
    """Greedy-fill leaves (tensors, arrays, shapes or element counts, in
    the tree's order) into ~``bucket_mb``-MB buckets.

    ``dtype_bytes`` is the *wire* element size (the accumulator's dtype).
    A leaf larger than a whole bucket gets a bucket of its own; a zero or
    negative ``bucket_mb`` degenerates to one bucket holding everything.
    """
    leaves = list(leaves)
    sizes = [int(_leaf_size(leaf)) * dtype_bytes for leaf in leaves]
    total = sum(sizes)
    if bucket_mb <= 0:
        buckets = [tuple(range(len(leaves)))] if leaves else []
        return OverlapPlan(
            buckets=tuple(buckets),
            bucket_bytes=tuple([total] if leaves else []),
            bucket_mb=float(bucket_mb),
            total_bytes=total,
        )
    cap = int(bucket_mb * 1e6)
    buckets: List[Tuple[int, ...]] = []
    bucket_bytes: List[int] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, nbytes in enumerate(sizes):
        if cur and cur_bytes + nbytes > cap:
            buckets.append(tuple(cur))
            bucket_bytes.append(cur_bytes)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(tuple(cur))
        bucket_bytes.append(cur_bytes)
    return OverlapPlan(
        buckets=tuple(buckets),
        bucket_bytes=tuple(bucket_bytes),
        bucket_mb=float(bucket_mb),
        total_bytes=total,
    )


class BucketIssuer:
    """Issue a plan's buckets in plan order as their leaves become ready.

    ``leaf_parts[i]`` is how many gradient tensors make leaf ``i`` (a
    layer-stacked leaf is ready when every layer's gradient is); ``issue(
    bucket_index, leaf_indices)`` issues the bucket's collectives and
    returns what ``wait`` later completes.  :meth:`ready` is called once a
    part of a leaf is ready (from a gradient hook); :meth:`finish` issues
    whatever is left, in order, and returns every bucket's result in plan
    order.
    """

    def __init__(self, plan: OverlapPlan, leaf_parts: Sequence[int],
                 issue: Callable[[int, Tuple[int, ...]], object]):
        if plan.num_leaves != len(leaf_parts):
            raise ValueError(
                f"overlap plan covers {plan.num_leaves} leaves but the "
                f"tree has {len(leaf_parts)}; rebuild the plan against "
                "this tree")
        self.plan = plan
        self._parts = list(leaf_parts)
        self._issue = issue
        self.reset()

    def reset(self) -> None:
        self._left: Dict[int, int] = dict(enumerate(self._parts))
        self._next = 0
        self.issued: List[object] = []
        #: Buckets issued from a gradient hook, before the backward ended.
        self.early = 0

    def ready(self, leaf: int) -> None:
        self._left[leaf] -= 1
        while self._next < self.plan.num_buckets and all(
                self._left[i] <= 0 for i in self.plan.buckets[self._next]):
            self._issue_next()
            self.early += 1

    def _issue_next(self) -> None:
        b = self._next
        self.issued.append(self._issue(b, self.plan.buckets[b]))
        self._next += 1

    def finish(self) -> List[object]:
        while self._next < self.plan.num_buckets:
            self._issue_next()
        out, self.issued = self.issued, []
        self._left = dict(enumerate(self._parts))
        self._next = 0
        return out

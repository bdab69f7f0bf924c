"""VirtualMesh: a fixed logical mesh folded onto varying physical members
(port of ``dlrover_tpu/runtime/virtual_mesh.py``).

The *logical* mesh is sized once from the job's reference world (the
elastic grad-accum booking) and never changes afterwards.  What changes
on a resize is only the fold: how many logical submeshes each surviving
member hosts.  A shrink deepens the fold (more microbatches per step,
``grad_accum_for``), a grow fans it back out.  The per-process mesh (the
data group) is constant for the process's lifetime, as the reference's
per-process device mesh is: a resize is a re-layout of live state plus
a step for the new fold, with no restore.

Ownership rule: logical shard ``s`` lives on physical member ``s % P``.
``data.loader.ElasticDistributedSampler`` implements the same rule inline;
the two must not diverge.

``relayout_state`` re-lays a live state out in memory through the
checkpoint's own record path (``shm_handler.pack_pytree``,
``assemble_tensor``, ``engine.materialize_records``), with the data
ranks' records exchanged over the group instead of storage, so a live
re-layout equals a save and a cross-world restore bit for bit.  The
expert plane's fields (``expert_logical``, ``with_expert_world``: the
elastic expert world and its re-layout) are not ported yet (ROADMAP
Queue 1 item 6's remainder); the expert axis itself is
``runtime/mesh.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


def shard_owner(shard: int, physical_world: int) -> int:
    """THE ownership rule: logical shard ``s`` lives on physical member
    ``s % P``.  The sharded embedding plane's bucket->owner map is this
    rule, as in the JAX package."""
    return shard % physical_world


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """Fixed logical mesh of ``logical_world`` host-granular submeshes,
    currently folded onto ``physical_world`` live members.  ``mesh_shape``
    is the per-process mesh's axis sizes (constant for the process's
    lifetime: resizes change membership, not local devices)."""

    mesh_shape: Tuple[int, ...]
    logical_world: int
    physical_world: int

    def __post_init__(self):
        if self.logical_world < 1 or self.physical_world < 1:
            raise ValueError(
                f"worlds must be >= 1, got logical={self.logical_world} "
                f"physical={self.physical_world}"
            )

    @property
    def fold(self) -> int:
        """Max logical submeshes any surviving member hosts (ceil(L/P))."""
        return -(-self.logical_world // self.physical_world)

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        """The resize-invariant program shape: the per-process mesh with
        its outermost (data) axis scaled by the logical world, constant
        across every resize."""
        shape = list(self.mesh_shape)
        shape[0] *= self.logical_world
        return tuple(shape)

    def owner(self, shard: int) -> int:
        """Physical member hosting logical shard ``shard``."""
        return shard_owner(shard, self.physical_world)

    def owned_shards(self, rank: int) -> Tuple[int, ...]:
        """Logical shards folded onto physical member ``rank`` (empty when
        the world grew past the logical mesh: the member idles)."""
        return tuple(
            range(rank, self.logical_world, self.physical_world)
        ) if rank < self.physical_world else ()

    def with_world(self, new_world: int) -> "VirtualMesh":
        """The same logical mesh folded onto ``new_world`` members."""
        return dataclasses.replace(
            self, physical_world=max(1, int(new_world)))

    def relayout_plan(self, new_world: int) -> List[Dict[str, int]]:
        """Shard moves a resize implies: ``[{shard, src, dst}]`` for every
        logical shard whose owner changes."""
        target = self.with_world(new_world)
        return [
            {"shard": s, "src": self.owner(s), "dst": target.owner(s)}
            for s in range(self.logical_world)
            if self.owner(s) != target.owner(s)
        ]

    def shard_rng(self, base_seed: int, shard: int) -> torch.Generator:
        """Per-shard random stream keyed by the LOGICAL shard index, never
        the physical rank: the stream a submesh draws is the same no
        matter which member hosts it."""
        s = shard % self.logical_world
        seed = (int(base_seed) * 1000003 + s) & 0x7FFFFFFFFFFFFFFF
        return torch.Generator().manual_seed(seed)

    def grad_accum_for(
        self, ref_accum: int, global_batch_size: int, dp_shards: int
    ) -> int:
        """Microbatches per step at the current fold: tokens/step stays
        pinned to the logical world's budget (``train_lib.
        elastic_grad_accum``)."""
        # Deferred: runtime must not import trainer at module scope.
        from dlrover_tpu_torch.trainer import train_lib

        return train_lib.elastic_grad_accum(
            ref_accum, self.logical_world, self.physical_world,
            global_batch_size, dp_shards,
        )


def _host_bytes(block) -> np.ndarray:
    """A record's bytes on the host, flat uint8."""
    if isinstance(block, torch.Tensor):
        t = block.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(block)).reshape(-1).view(np.uint8)


def relayout_state(
    tree: Any,
    layouts: Callable[[int], Dict[Tuple[str, ...], Any]],
    target: Dict[Tuple[str, ...], Any],
    template: Any,
    device: torch.device,
    wire=None,
):
    """Re-lay out a live state tree in memory.

    ``layouts(r)`` is where each leaf lies on data rank ``r`` now (one
    rank without a ``wire``); ``target`` this rank's layout after the
    re-layout, and ``template`` a tree of the target's structure.  Each
    rank packs its records (``shm_handler.pack_pytree``, the checkpoint's
    replica-0 selection), the records travel over ``wire`` (a record every
    rank writes is all-gathered, one written by a single rank is
    broadcast from it), every leaf is reassembled
    (``shm_handler.assemble_tensor``) and landed under ``target``
    (``engine.materialize_records``): the same mapping as a save and a
    cross-world restore, with the wire in place of storage.

    Cost: one host round trip of the state, and the records over the
    wire once."""
    from dlrover_tpu_torch.checkpoint import engine as ckpt_engine
    from dlrover_tpu_torch.checkpoint import shm_handler

    n = wire.size if wire is not None else 1
    rank = wire.rank if wire is not None else 0
    all_layouts = [layouts(r) for r in range(n)]
    meta, blocks = shm_handler.pack_pytree(tree, step=0,
                                           layout=all_layouts[rank])
    mine = iter(blocks)
    arrays: Dict[Tuple[str, ...], torch.Tensor] = {}
    for tensor in meta.tensors:
        own = [_host_bytes(next(mine)) for _ in tensor.shards]
        records, pieces = [], []
        owners = [r for r in range(n)
                  if all_layouts[r][tensor.path].replica_id == 0]
        itemsize = shm_handler._container(tensor.dtype).itemsize
        for r in owners:
            index = tuple(all_layouts[r][tensor.path].index)
            shape = tuple(e - b for b, e in index)
            records.append(shm_handler.ShardRecord(
                index=index, offset=0,
                nbytes=int(np.prod(shape)) * itemsize, shape=shape))
        if n == 1:
            pieces = own
        elif len(owners) == n and len({r.nbytes for r in records}) == 1:
            out = torch.empty((n, records[0].nbytes), dtype=torch.uint8)
            wire.all_gather(out, torch.from_numpy(own[0].copy()))
            pieces = [out[r].numpy() for r in range(n)]
        else:
            for r, record in zip(owners, records):
                buf = (torch.from_numpy(own[0].copy()) if r == rank
                       else torch.empty(record.nbytes, dtype=torch.uint8))
                wire.broadcast(buf, src=r)
                pieces.append(buf.numpy())
        by_id = {id(rec): piece for rec, piece in zip(records, pieces)}
        whole = shm_handler.TensorMeta(
            path=tensor.path, global_shape=tensor.global_shape,
            dtype=tensor.dtype, shards=records)
        arrays[tensor.path] = shm_handler.assemble_tensor(
            whole, lambda rec: by_id[id(rec)])
    return ckpt_engine.materialize_records(arrays, meta, template, device,
                                           target)

"""VirtualMesh: a fixed logical mesh folded onto varying physical members
(port of ``dlrover_tpu/runtime/virtual_mesh.py``: the fold rule, the
logical shape and the grad-accumulation rule).

The *logical* mesh is sized once from the job's reference world (the
elastic grad-accum booking) and never changes afterwards.  What changes
on a resize is only the fold: how many logical submeshes each surviving
member hosts.  A shrink deepens the fold (more microbatches per step,
``grad_accum_for``), a grow fans it back out.

Ownership rule: logical shard ``s`` lives on physical member ``s % P``.
``data.loader.ElasticDistributedSampler`` implements the same rule inline;
the two must not diverge.

The port has no device mesh yet: ``mesh_shape`` is the per-process mesh's
axis sizes, ``(1,)`` on one device.  The resize accounting (``fold``,
``owner``, ``owned_shards``, ``with_world``) and the live re-layout
(``relayout_plan``, ``shard_rng``, ``relayout_state``) come with
``apply_world_change`` (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


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
    def logical_shape(self) -> Tuple[int, ...]:
        """The resize-invariant program shape: the per-process mesh with
        its outermost (data) axis scaled by the logical world, constant
        across every resize."""
        shape = list(self.mesh_shape)
        shape[0] *= self.logical_world
        return tuple(shape)

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

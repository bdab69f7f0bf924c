"""The fold rule of ``dlrover_tpu/runtime/virtual_mesh.py`` (port of
:func:`shard_owner` only; the virtual mesh itself waits for the port's
mesh)."""

from __future__ import annotations


def shard_owner(shard: int, physical_world: int) -> int:
    """THE ownership rule: logical shard ``s`` lives on physical member
    ``s % P``.  The sharded embedding plane's bucket->owner map is this
    rule, as in the JAX package."""
    return shard % physical_world

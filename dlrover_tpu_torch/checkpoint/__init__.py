"""Flash Checkpoint (port of ``dlrover_tpu/checkpoint``): the shm arena,
the trainer-side engine, the async saver and the user-facing
``Checkpointer``; ``from_jax`` restores a checkpoint the JAX package
wrote."""

from dlrover_tpu_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine  # noqa: F401
from dlrover_tpu_torch.checkpoint.saver import (  # noqa: F401
    AsyncCheckpointSaver,
)

__all__ = [
    "Checkpointer",
    "StorageType",
    "CheckpointEngine",
    "AsyncCheckpointSaver",
]

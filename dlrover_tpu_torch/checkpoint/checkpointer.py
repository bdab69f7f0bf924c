"""User-facing Flash Checkpoint API (port of
``dlrover_tpu/checkpoint/checkpointer.py``).

One class for every layout: the state is a tree of tensors, and a restore
fills a template of the same structure (``shm_handler.tree_map_with_path``)
with tensors on the engine's device.  A data rank saves its pieces under
a layout (``{path: shm_handler.LeafLayout}``, ``train_lib.Train.
checkpoint_layout``), and a restore takes the target world's layout as
its ``shardings``: every leaf is reassembled from the saved records and
cut to this rank's slice, whatever world saved it.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Dict, Optional

from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.runtime.device import DeviceLike


class StorageType(Enum):
    MEMORY = "memory"
    DISK = "disk"


class Checkpointer:
    """Save/restore a train-state tree with second-scale blocking time.

    Usage::

        ckpt = Checkpointer(checkpoint_dir, local_saver=True)
        ckpt.save_checkpoint(step, state)                    # shm only
        ckpt.save_checkpoint(step, state, StorageType.DISK)  # + async persist
        step, state = ckpt.load_checkpoint(state_template=state)
    """

    def __init__(
        self,
        checkpoint_dir: str,
        storage=None,
        host_index: Optional[int] = None,
        num_hosts: Optional[int] = None,
        local_saver: bool = False,
        device: DeviceLike = None,
    ):
        self._engine = CheckpointEngine(
            checkpoint_dir,
            storage=storage,
            host_index=host_index,
            num_hosts=num_hosts,
            local_saver=local_saver,
            device=device,
        )

    def save_checkpoint(
        self,
        step: int,
        state: Any,
        storage_type: StorageType = StorageType.MEMORY,
        extra: Optional[Dict[str, Any]] = None,
        layout: Any = None,
    ) -> bool:
        """Save ``state`` at ``step``; ``layout`` is where each leaf lies
        on this rank (None: whole leaves)."""
        if storage_type == StorageType.MEMORY:
            return self._engine.save_to_memory(step, state, extra, layout)
        return self._engine.save_to_storage(step, state, extra, layout)

    def load_checkpoint(self, shardings: Any = None,
                        state_template: Any = None):
        """Returns (step, state); step==-1 when nothing exists yet.

        ``state_template`` (any tree of tensors with the target structure,
        dtypes and shapes, e.g. a freshly initialised state) gives the
        structure; each restored tensor lands on the engine's device.
        ``shardings`` (``{path: LeafLayout}`` of the target world) cuts
        each leaf to this rank's slice.  Without a template, state is the
        flat ``{path: tensor}`` dict.
        """
        return self._engine.load(template=state_template, layout=shardings)

    @property
    def last_extra(self) -> Dict[str, Any]:
        """The ``extra`` sidecar restored by the latest ``load_checkpoint``
        ({} when nothing restored or the checkpoint carried none)."""
        return dict(getattr(self._engine, "last_restored_extra", {}) or {})

    def wait(self, timeout: float = 600.0) -> bool:
        """Block until async persists drained (call before clean job exit)."""
        return self._engine.wait_saver(timeout)

    def close(self):
        self._engine.close()

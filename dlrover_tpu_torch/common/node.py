"""Canonical node/job state objects held by the master (port of
``dlrover_tpu/common/node.py``).

A ``Node`` is one host; ``SliceSpec`` keeps the reference's slice record
(the group of hosts that is allocated and preempted as one unit), so the
master's inventory reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType


@dataclasses.dataclass
class NodeResource:
    """Host-side resources plus attached TPU chips."""

    cpu: float = 0.0
    memory_mb: int = 0
    chips: int = 0                 # TPU chips attached to this host
    accelerator: str = ""          # Accelerators.* value

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "NodeResource":
        return cls(**d)


@dataclasses.dataclass
class SliceSpec:
    """The TPU slice this node belongs to.

    A slice (e.g. v5e-64 = 16 hosts x 4 chips) is the atomic unit the platform
    allocates and preempts; hosts within a slice share ICI, hosts across
    slices communicate over DCN.
    """

    slice_id: str = ""
    topology: str = ""             # e.g. "4x4", "8x8"
    num_hosts: int = 1
    chips_per_host: int = 4


@dataclasses.dataclass
class Node:
    type: str = NodeType.WORKER
    node_id: int = 0
    rank: int = -1                 # node rank assigned at rendezvous
    name: str = ""
    status: str = NodeStatus.INITIAL
    resource: NodeResource = dataclasses.field(default_factory=NodeResource)
    slice: SliceSpec = dataclasses.field(default_factory=SliceSpec)
    host_addr: str = ""
    create_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0
    relaunch_count: int = 0
    max_relaunch_count: int = 3
    relaunchable: bool = True
    is_released: bool = False
    exit_reason: str = ""
    heartbeat_time: float = 0.0
    paral_config: Optional[Dict] = None
    start_hang_time: float = 0.0

    def update_status(self, status: str) -> None:
        self.status = status
        if status == NodeStatus.RUNNING and not self.start_time:
            self.start_time = time.time()
        if NodeStatus.is_terminal(status):
            self.finish_time = time.time()

    def inc_relaunch_count(self) -> None:
        self.relaunch_count += 1

    def exceeded_max_relaunch(self) -> bool:
        return self.relaunch_count >= self.max_relaunch_count

    def is_unrecoverable_failure(self) -> bool:
        return (
            self.status == NodeStatus.FAILED
            and (not self.relaunchable or self.exceeded_max_relaunch())
        )

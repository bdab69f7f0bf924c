"""Master-side rendezvous: collect hosts, emit the communication world
(port of ``dlrover_tpu/master/rdzv_manager.py``).

Capability ref: ``dlrover/python/master/elastic_training/rdzv_manager.py``
(``ElasticTrainingRendezvousManager:291``, ``NetworkCheckRendezvousManager:349``,
``join_rendezvous:198``, ``get_comm_world:267``, ``_check_rdzv_completed:129``,
pairwise fault bisection ``:408-530``, straggler detection ``:550-565``).

A "node" is a host; its ``local_world_size`` is its device count.  The
emitted world {host_rank: devices} is what the agent hands the trainer for
``torch.distributed.init_process_group`` (coordinator = rank 0).
Elasticity is at host granularity — preemption takes out whole hosts, so
min/max_nodes and node_unit express whole units.
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from typing import Dict, List, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger


class RendezvousName:
    TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class RendezvousParameters:
    def __init__(
        self,
        min_nodes: int = 1,
        max_nodes: int = 1,
        waiting_timeout: float = 60.0,
        node_unit: int = 1,
        join_timeout: float = 600.0,
    ):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.waiting_timeout = waiting_timeout
        self.node_unit = node_unit
        self.join_timeout = join_timeout


class RendezvousManager(ABC):
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._params = RendezvousParameters()
        self._waiting_nodes: Dict[int, int] = {}  # node_rank -> local_world
        self._rdzv_nodes: Dict[int, int] = {}  # the latest completed world
        self._rdzv_round = 0
        self._lastcall_time = 0.0
        self._start_rdzv_time = 0.0
        self._node_unit = 1
        self._alive_nodes: set = set()
        self._scale_down_ts = 0.0
        # True while the latest sealed world has lost a member: survivors
        # polling ``world_changed`` must restart and re-join so a smaller
        # world can seal (the scale-down half of membership detection).
        self._world_broken = False
        # Quarantined ranks: join_rendezvous ignores them, so a corrupting
        # host that keeps heartbeating can never re-enter a world.
        self._banned: set = set()

    def update_rdzv_params(
        self, min_nodes: int, max_nodes: int,
        waiting_timeout: float = 60.0, node_unit: int = 1,
    ):
        with self._lock:
            self._params = RendezvousParameters(
                min_nodes, max_nodes, waiting_timeout, node_unit
            )
            self._node_unit = node_unit

    def add_alive_node(self, node_rank: int):
        self._alive_nodes.add(node_rank)

    def remove_alive_node(self, node_rank: int):
        with self._lock:
            self._alive_nodes.discard(node_rank)
            if node_rank in self._waiting_nodes:
                del self._waiting_nodes[node_rank]
            if node_rank in self._rdzv_nodes:
                # A member died: survivors must learn the world is broken and
                # re-join so the next round seals without the dead node.
                self._world_broken = True
                logger.info(
                    "%s: node %d left the formed world (round %d broken)",
                    self.name, node_rank, self._rdzv_round,
                )

    def invalidate_world(self):
        """Force a re-form of the current sealed world (hang remediation):
        members polling ``world_changed`` restart and re-join."""
        with self._lock:
            if self._rdzv_nodes:
                self._world_broken = True

    def world_changed(self, round_: int) -> bool:
        """True when the world an agent joined at ``round_`` no longer holds:
        a newer round sealed past it, or a member of the current round died.
        This is the scale-down/death half of membership-change detection (the
        scale-up half is ``num_nodes_waiting``); capability ref
        ``dlrover/python/elastic_agent/torch/training.py:694``."""
        with self._lock:
            return self._rdzv_round > round_ or self._world_broken

    def ban_node(self, node_rank: int):
        """Quarantine: evict the rank from waiting/alive/sealed sets and
        refuse every future join.  Breaks the sealed world if the rank was
        a member, exactly like a death — survivors re-form without it."""
        with self._lock:
            self._banned.add(node_rank)
        self.remove_alive_node(node_rank)
        logger.warning(
            "%s: node %d banned from rendezvous (quarantine)",
            self.name, node_rank,
        )

    def join_rendezvous(self, node_rank: int, local_world_size: int) -> int:
        """Register a host; returns the round it will join."""
        with self._lock:
            if node_rank in self._banned:
                logger.warning(
                    "%s: refusing join from quarantined node %d",
                    self.name, node_rank,
                )
                return self._rdzv_round
            if not self._waiting_nodes:
                self._start_rdzv_time = time.monotonic()
            self._waiting_nodes[node_rank] = local_world_size
            self._alive_nodes.add(node_rank)
            self._lastcall_time = time.monotonic()
            return self._rdzv_round

    def num_nodes_waiting(self) -> int:
        with self._lock:
            return len(self._waiting_nodes)

    def _check_rdzv_completed(self) -> bool:
        """Called under lock: world forms when every expected node arrived, or
        min_nodes arrived and the waiting window lapsed (rounded down to a
        multiple of node_unit so sub-slice worlds are never emitted)."""
        waiting = len(self._waiting_nodes)
        if waiting == 0:
            return False
        if waiting >= self._params.max_nodes:
            self._seal_world(sorted(self._waiting_nodes)[: self._params.max_nodes])
            return True
        lapsed = (
            self._lastcall_time
            and time.monotonic() - self._lastcall_time
            > self._params.waiting_timeout
        )
        usable = (waiting // self._node_unit) * self._node_unit
        if lapsed and usable >= max(self._params.min_nodes, 1):
            self._seal_world(sorted(self._waiting_nodes)[:usable])
            return True
        return False

    def _seal_world(self, members: List[int]):
        self._rdzv_nodes = {
            rank: self._waiting_nodes[rank] for rank in members
        }
        for rank in members:
            del self._waiting_nodes[rank]
        self._rdzv_round += 1
        self._world_broken = False
        logger.info(
            "%s: round %d sealed with %d nodes (%.1fs to form)",
            self.name, self._rdzv_round, len(self._rdzv_nodes),
            time.monotonic() - self._start_rdzv_time,
        )

    @abstractmethod
    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int]]:
        """Returns (round, group, {node_rank: local_world_size}); empty world
        while the rendezvous is still forming."""


class ElasticTrainingRendezvousManager(RendezvousManager):
    def __init__(self):
        super().__init__(RendezvousName.TRAINING)

    def get_comm_world(self, node_rank: int):
        with self._lock:
            if self._waiting_nodes:
                self._check_rdzv_completed()
            # A node still in the waiting set has *re-joined* (restart) and is
            # asking for the next round's world — the old sealed world must
            # not satisfy it, or membership-change restarts would loop.
            if (
                node_rank in self._rdzv_nodes
                and node_rank not in self._waiting_nodes
            ):
                return self._rdzv_round, 0, dict(self._rdzv_nodes)
            return self._rdzv_round, 0, {}


class NetworkCheckRendezvousManager(RendezvousManager):
    """Pairwise-bisection fault localisation over ICI/host network probes.

    Round 1 groups hosts into pairs; a failed pair marks both suspect.
    Round 2 re-pairs each suspect with a known-healthy host; the node whose
    new pair also fails is the faulty one (capability ref
    ``rdzv_manager.py:408-530``).  Straggler = probe elapsed time exceeding
    ``straggler_ratio`` x the median.
    """

    GROUP_SIZE = 2
    STRAGGLER_RATIO = 3.0

    def __init__(self):
        super().__init__(RendezvousName.NETWORK_CHECK)
        self._node_status: Dict[int, bool] = {}
        self._node_elapsed: Dict[int, Dict[int, float]] = {}  # round->rank->s
        self._check_round = 0
        self._groups: List[List[int]] = []

    def get_comm_world(self, node_rank: int):
        with self._lock:
            if self._waiting_nodes and self._check_rdzv_completed():
                # Each check round re-joins and re-seals: recompute groups
                # (round 0 pairs; later rounds bisect suspects).
                self._groups = self._group_nodes(self._check_round)
                self._check_round += 1
            if (
                node_rank in self._rdzv_nodes
                and node_rank not in self._waiting_nodes
            ):
                for group_idx, group in enumerate(self._groups):
                    if node_rank in group:
                        world = {r: self._rdzv_nodes[r] for r in group}
                        return self._rdzv_round, group_idx, world
            return self._rdzv_round, 0, {}

    def _group_nodes(self, check_round: int) -> List[List[int]]:
        ranks = sorted(self._rdzv_nodes)
        if check_round == 0:
            groups = [
                ranks[i : i + self.GROUP_SIZE]
                for i in range(0, len(ranks), self.GROUP_SIZE)
            ]
            # A trailing singleton can't allgather-probe; merge it.
            if len(groups) > 1 and len(groups[-1]) == 1:
                groups[-2].extend(groups.pop())
            return groups
        # Round >= 1: pair each suspect with a healthy node to bisect.
        suspects = [r for r in ranks if not self._node_status.get(r, True)]
        healthy = [r for r in ranks if self._node_status.get(r, True)]
        groups, pool = [], list(healthy)
        for suspect in suspects:
            if pool:
                groups.append([suspect, pool.pop(0)])
            else:
                groups.append([suspect])
        if len(pool) > 1:
            groups.extend(
                [pool[i : i + 2] for i in range(0, len(pool), 2)]
            )
            # A trailing singleton can't allgather-probe; merge it (mirrors
            # the round-0 merge so no node spins in an empty comm world).
            if len(groups[-1]) == 1:
                groups[-2].extend(groups.pop())
        elif pool:
            if groups:
                groups[-1].append(pool[0])
            else:
                groups.append([pool[0]])
        return groups

    def report_network_status(
        self, node_rank: int, normal: bool, elapsed: float
    ):
        with self._lock:
            self._node_status[node_rank] = normal
            self._node_elapsed.setdefault(self._check_round, {})[
                node_rank
            ] = elapsed

    def check_fault_node(self) -> Tuple[List[int], str]:
        """Returns (fault_nodes, reason); call once all members reported."""
        with self._lock:
            reported = set(self._node_status)
            expected = set(self._rdzv_nodes) or reported
            if not expected.issubset(reported):
                return [], "waiting"
            faults = [r for r in sorted(expected) if not self._node_status[r]]
            return faults, "done"

    def get_stragglers(self) -> List[int]:
        with self._lock:
            rounds = sorted(self._node_elapsed)
            if not rounds:
                return []
            elapsed = self._node_elapsed[rounds[-1]]
            if len(elapsed) < 2:
                return []
            times = sorted(elapsed.values())
            median = times[len(times) // 2]
            if median <= 0:
                return []
            return [
                rank
                for rank, t in elapsed.items()
                if t > self.STRAGGLER_RATIO * median
            ]

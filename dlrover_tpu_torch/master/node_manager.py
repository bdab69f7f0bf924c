"""Node (host) lifecycle: inventory, heartbeats, relaunch decisions (port
of ``dlrover_tpu/master/node_manager.py``).

Capability ref: ``dlrover/python/master/node/dist_job_manager.py:88-864``
(``_monitor_node_heart_beat:355``, ``_process_event:473``,
``_should_relaunch:561``, ``_relaunch_node:605``) and the event callbacks
(``node/event_callback.py``: recover shards / reset speed on node death).

The schedulable unit is a host and elasticity is host-granular.  Actual pod/VM creation sits behind the ``NodeLauncher``
seam (mirroring the reference's Scaler/Watcher seam) so unit tests and the
local standalone mode need no cloud API.
"""

from __future__ import annotations

import threading
import time
from enum import Enum
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class NodeStatus(str, Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    PREEMPTING = "preempting"
    DEAD = "dead"


class ExceptionLevel(str, Enum):
    PROCESS = "process"  # restart training processes in place
    NODE = "node"        # relaunch the host/slice
    JOB = "job"          # unrecoverable: fail the job


class NodeState:
    def __init__(self, node_id: int, max_relaunches: int = 3,
                 node_type: str = "worker"):
        self.node_id = node_id
        self.node_type = node_type
        self.status = NodeStatus.PENDING
        self.last_heartbeat = time.time()
        self.relaunch_count = 0
        self.max_relaunches = max_relaunches
        self.exit_code = 0
        self.error = ""


class NodeLauncher:
    """Platform seam: create/delete hosts. Local/test impls are no-ops
    or subprocess spawns; the GKE impl talks to the cloud API."""

    def launch(self, node_id: int) -> None:
        logger.info("launcher: (noop) launch node %d", node_id)

    def delete(self, node_id: int) -> None:
        logger.info("launcher: (noop) delete node %d", node_id)


class LocalNodeLauncher(NodeLauncher):
    """Subprocess-spawning launcher: each "host" is a local agent process.

    The local stand-in for the reference's pod scaler
    (ref ``dlrover/python/master/scaler/pod_scaler.py:78-662``): tests and
    the goodput harness exercise real host relaunch — a launched node is a
    ``dlrover_tpu_torch.run`` agent subprocess in its own process group.
    ``command_builder(node_id) -> argv`` supplies the agent command line.
    """

    def __init__(self, command_builder, env: Optional[dict] = None):
        import os

        self._command_builder = command_builder
        self._env = dict(env) if env is not None else dict(os.environ)
        self.procs: Dict[int, "subprocess.Popen"] = {}

    def launch(self, node_id: int) -> None:
        import subprocess

        existing = self.procs.get(node_id)
        if existing is not None and existing.poll() is None:
            logger.info("launcher: node %d already running", node_id)
            return
        self.procs[node_id] = subprocess.Popen(
            self._command_builder(node_id),
            env=self._env,
            start_new_session=True,
        )
        logger.info(
            "launcher: spawned node %d (pid %d)",
            node_id, self.procs[node_id].pid,
        )

    def delete(self, node_id: int) -> None:
        import os
        import signal
        import subprocess

        proc = self.procs.pop(node_id, None)
        if proc is None or proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.wait(timeout=5)
        except ProcessLookupError:
            pass
        logger.info("launcher: deleted node %d", node_id)

    def shutdown(self):
        for node_id in list(self.procs):
            self.delete(node_id)


class NodeManager:
    HEARTBEAT_TIMEOUT = 300.0
    # Node-id namespace per typed pool (ref typed PS/worker managers,
    # ``master/node/ps.py:369`` / ``worker.py:307``): the "worker" pool
    # owns [0, POOL_ID_STRIDE); each additional pool the next stride.
    # Agents carry plain node ids, so the wire protocol is unchanged.
    POOL_ID_STRIDE = 10_000

    def __init__(
        self,
        num_nodes: int = 1,
        launcher: Optional[NodeLauncher] = None,
        max_relaunches: int = 3,
        heartbeat_timeout: float = 0.0,
        pools: Optional[Dict[str, int]] = None,
    ):
        """``pools`` maps extra typed pools to their sizes (e.g.
        ``{"coworker": 2}`` — data-preprocessing hosts beside the
        ``num_nodes`` trainers).  The reference runs typed PS/worker
        node groups; here the trainer pool is the rendezvous world and
        auxiliary pools (coworker preprocessing, embedding-service
        hosts) are supervised/repaired but never join the training
        rendezvous or the auto-scaler's sizing."""
        if heartbeat_timeout:
            self.HEARTBEAT_TIMEOUT = heartbeat_timeout
        self._lock = threading.Lock()
        self._nodes: Dict[int, NodeState] = {
            i: NodeState(i, max_relaunches) for i in range(num_nodes)
        }
        self._pool_bases: Dict[str, int] = {"worker": 0}
        for k, (pool, size) in enumerate(sorted((pools or {}).items())):
            base = (k + 1) * self.POOL_ID_STRIDE
            self._pool_bases[pool] = base
            for i in range(size):
                self._nodes[base + i] = NodeState(
                    base + i, max_relaunches, node_type=pool
                )
        self._launcher = launcher or NodeLauncher()
        self._max_relaunches = max_relaunches
        # Migrations in flight: new_id -> old_id (retire the old host
        # once its replacement reports in).
        self._migrations: Dict[int, int] = {}
        # SDC quarantine blacklist: node_id -> reason.  A quarantined host
        # computes wrong numbers — it is never relaunched, never rejoins a
        # rendezvous, and the ban survives master restarts (state_store).
        self._quarantined: Dict[int, str] = {}
        # Nodes whose trainer reported success: done, not missing (the
        # repair loop must not relaunch a finished job's nodes; a retired
        # node is SUCCEEDED too, but stays relaunchable for a scale-up).
        self._finished: set = set()
        # Event callbacks: fn(node_id, old_status, new_status).
        self._callbacks: List[Callable[[int, NodeStatus, NodeStatus], None]] = []
        self.job_failed = False
        self.job_failure_reason = ""

    def _pool_for_id(self, node_id: int) -> str:
        """The ONE id->pool rule (stride ranges, "worker" otherwise) —
        shared by every classifier so they cannot diverge."""
        for pool, base in self._pool_bases.items():
            if base <= node_id < base + self.POOL_ID_STRIDE:
                return pool
        return "worker"

    def pool_of(self, node_id: int) -> str:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                return node.node_type
        return self._pool_for_id(node_id)

    def add_callback(self, fn: Callable[[int, NodeStatus, NodeStatus], None]):
        self._callbacks.append(fn)

    def _transition(self, node: NodeState, status: NodeStatus):
        old = node.status
        if old == status:
            return
        node.status = status
        logger.info("node %d: %s -> %s", node.node_id, old.value, status.value)
        for fn in self._callbacks:
            try:
                fn(node.node_id, old, status)
            except Exception as e:
                logger.warning("node callback failed: %s", e)

    def ensure_node(self, node_id: int) -> NodeState:
        if node_id not in self._nodes:
            self._nodes[node_id] = NodeState(
                node_id, self._max_relaunches,
                node_type=self._pool_for_id(node_id),
            )
        return self._nodes[node_id]

    def report_event(self, node_id: int, event: str, detail: str = ""):
        migrated_out = None
        with self._lock:
            node = self.ensure_node(node_id)
            node.last_heartbeat = time.time()
            mapping = {
                "started": NodeStatus.RUNNING,
                "succeeded": NodeStatus.SUCCEEDED,
                "failed": NodeStatus.FAILED,
                "preempting": NodeStatus.PREEMPTING,
            }
            if event in mapping:
                self._transition(node, mapping[event])
            if event == "succeeded":
                self._finished.add(node_id)
            elif event in mapping:
                self._finished.discard(node_id)
            if event == "started":
                migrated_out = self._complete_migration_locked(node_id)
            if event == "failed":
                node.error = detail
                if node_id in self._migrations.values():
                    # The draining side of an in-flight migration: its
                    # replacement is already coming up — relaunching the
                    # old id would create a VM only to tear it down when
                    # the replacement reports in, and burn budget.
                    logger.info(
                        "node %d failed mid-migration; replacement "
                        "already in flight, not relaunching", node_id,
                    )
                else:
                    self._maybe_relaunch(node)
        if migrated_out is not None:
            self._launcher.delete(migrated_out)

    def report_heartbeat(self, node_id: int, timestamp: float):
        migrated_out = None
        with self._lock:
            node = self.ensure_node(node_id)
            node.last_heartbeat = timestamp
            if node.status == NodeStatus.PENDING:
                self._transition(node, NodeStatus.RUNNING)
                migrated_out = self._complete_migration_locked(node_id)
        if migrated_out is not None:
            self._launcher.delete(migrated_out)

    def report_failure(
        self, node_id: int, error: str, exit_code: int, level: str
    ) -> str:
        """Returns the action the agent should take: restart|relaunch|stop."""
        with self._lock:
            node = self.ensure_node(node_id)
            node.error = error
            node.exit_code = exit_code
            if level == ExceptionLevel.JOB:
                self.job_failed = True
                self.job_failure_reason = error
                return "stop"
            if level == ExceptionLevel.NODE:
                self._transition(node, NodeStatus.FAILED)
                return (
                    "relaunch" if self._maybe_relaunch(node) else "stop"
                )
            # process-level: agent restarts workers in place; node stays up.
            node.relaunch_count += 1
            if node.relaunch_count > node.max_relaunches:
                self.job_failed = True
                self.job_failure_reason = (
                    f"node {node_id} exceeded {node.max_relaunches} restarts"
                )
                return "stop"
            return "restart"

    def _maybe_relaunch(self, node: NodeState) -> bool:
        """ref ``_should_relaunch:561``: relaunch unless budget exhausted or
        the failure is fatal (exit code classified as unrecoverable)."""
        if node.node_id in self._quarantined:
            logger.info(
                "node %d is quarantined; not relaunching", node.node_id
            )
            return False
        if node.relaunch_count >= node.max_relaunches:
            self.job_failed = True
            self.job_failure_reason = (
                f"node {node.node_id} exceeded relaunch budget"
            )
            return False
        node.relaunch_count += 1
        self._launcher.delete(node.node_id)
        self._launcher.launch(node.node_id)
        self._transition(node, NodeStatus.PENDING)
        return True

    def relaunchable(self, node_id: int) -> bool:
        with self._lock:
            if node_id in self._quarantined:
                return False
            node = self._nodes.get(node_id)
            return node is None or node.relaunch_count < node.max_relaunches

    def quarantine(self, node_id: int, reason: str = ""):
        """Blacklist a silently-corrupting host: retire it and pin its
        relaunch budget to zero so neither the auto-scaler's repair loop
        nor a node-level failure path ever brings it back."""
        with self._lock:
            if node_id in self._quarantined:
                return
            self._quarantined[node_id] = reason
            node = self.ensure_node(node_id)
            self._transition(node, NodeStatus.FAILED)
            node.error = reason or "quarantined"
        logger.warning(
            "node %d QUARANTINED: %s", node_id, reason or "SDC suspect"
        )
        self._launcher.delete(node_id)

    def finished(self) -> List[int]:
        """Nodes whose trainer reported success and that still stand
        SUCCEEDED (a later start or failure takes a node off the list)."""
        with self._lock:
            return sorted(
                i for i in self._finished
                if self._nodes[i].status == NodeStatus.SUCCEEDED
            )

    def is_quarantined(self, node_id: int) -> bool:
        with self._lock:
            return node_id in self._quarantined

    def quarantined(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._quarantined)

    def launch_node(self, node_id: int, bootstrap: bool = False) -> bool:
        """Scaler entry: (re)launch a host if its relaunch budget remains.

        ``bootstrap=True`` is the initial-creation path (the reference's
        operator creating the job's first pods): it launches a
        never-started PENDING node without consuming relaunch budget.

        The launcher call itself runs OUTSIDE the lock — a real launcher
        (cloud API, subprocess teardown) can block for seconds and every
        heartbeat/event RPC contends on this lock.
        """
        with self._lock:
            node = self.ensure_node(node_id)
            if node_id in self._quarantined:
                logger.warning(
                    "node %d is quarantined; refusing launch", node_id
                )
                return False
            if node_id in self._migrations.values():
                # The draining side of an in-flight migration (it may
                # have gone silent — the normal preemption signature):
                # its replacement is already coming up; relaunching here
                # would burn budget on a VM the completion hook then
                # tears straight down.
                logger.info(
                    "node %d is mid-migration; replacement in flight, "
                    "not relaunching", node_id,
                )
                return True
            if node.status == NodeStatus.RUNNING or (
                node.status == NodeStatus.PENDING and not bootstrap
            ):
                return True
            if not bootstrap and node.relaunch_count >= node.max_relaunches:
                logger.warning(
                    "node %d relaunch budget exhausted", node_id
                )
                return False
            if not bootstrap:
                node.relaunch_count += 1
            node.last_heartbeat = time.time()
            self._transition(node, NodeStatus.PENDING)
        try:
            self._launcher.launch(node_id)
        except Exception as e:  # noqa: BLE001 - cloud APIs fail transiently
            logger.error("launch of node %d failed: %s", node_id, e)
            with self._lock:
                self._transition(self.ensure_node(node_id), NodeStatus.DEAD)
            return False
        return True

    def retire_node(self, node_id: int):
        """Scaler entry: remove a host from the job (scale-down); launcher
        teardown (possibly seconds) runs outside the lock."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            self._finished.discard(node_id)
            self._transition(node, NodeStatus.SUCCEEDED)
        self._launcher.delete(node_id)

    def check_heartbeats(self) -> List[int]:
        """Mark hosts with stale heartbeats dead; returns newly-dead ids
        (ref ``_monitor_node_heart_beat:355``, 300s window).  Relaunching is
        the caller's decision (JobMaster death handler or the auto-scaler's
        repair loop) — doing it here too would double-spend the budget."""
        newly_dead = []
        now = time.time()
        with self._lock:
            for node in self._nodes.values():
                if node.status in (NodeStatus.RUNNING, NodeStatus.PREEMPTING):
                    if now - node.last_heartbeat > self.HEARTBEAT_TIMEOUT:
                        self._transition(node, NodeStatus.DEAD)
                        newly_dead.append(node.node_id)
        return newly_dead

    def statuses(self, pool: Optional[str] = None) -> Dict[int, str]:
        with self._lock:
            return {
                i: n.status.value for i, n in self._nodes.items()
                if pool is None or n.node_type == pool
            }

    def migrate(self, node_id: int) -> Optional[int]:
        """Typed-pool migration (ref the PS migration flow): launch a
        REPLACEMENT host at a fresh id in the same pool, drain the
        original (PREEMPTING — it keeps serving until the replacement
        reports started, then it is retired).  Returns the new id, or
        None when the node is unknown."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return None
            base = self._pool_bases.get(node.node_type, 0)
            peers = [
                i for i, n in self._nodes.items()
                if n.node_type == node.node_type
            ]
            new_id = max(peers) + 1
            if new_id >= base + self.POOL_ID_STRIDE:
                logger.error(
                    "pool %r id space exhausted", node.node_type
                )
                return None
            self._nodes[new_id] = NodeState(
                new_id, self._max_relaunches, node_type=node.node_type
            )
            self._migrations[new_id] = node_id
            self._transition(node, NodeStatus.PREEMPTING)
        try:
            self._launcher.launch(new_id)
        except Exception as e:  # noqa: BLE001 - cloud APIs fail transiently
            # Roll back: a failed replacement launch must not strand the
            # original in PREEMPTING with a dangling migration entry.
            logger.error(
                "migration launch of node %d failed: %s; keeping %d",
                new_id, e, node_id,
            )
            with self._lock:
                self._migrations.pop(new_id, None)
                # Remove, don't mark DEAD: a dead orphan NodeState would
                # pin all_succeeded()/statuses() forever.
                self._nodes.pop(new_id, None)
                original = self._nodes.get(node_id)
                if original is not None and (
                    original.status == NodeStatus.PREEMPTING
                ):
                    self._transition(original, NodeStatus.RUNNING)
            return None
        logger.info(
            "migrating node %d -> %d (pool %s)", node_id, new_id,
            node.node_type,
        )
        return new_id

    def _complete_migration_locked(self, new_id: int) -> Optional[int]:
        """Under self._lock: retire the migrated-away node's state.
        Returns the old id for the caller to launcher-delete OUTSIDE the
        lock (teardown can block for seconds)."""
        old_id = self._migrations.pop(new_id, None)
        if old_id is None:
            return None
        logger.info(
            "migration complete: replacement %d up; retiring %d",
            new_id, old_id,
        )
        old = self._nodes.get(old_id)
        if old is not None:
            self._transition(old, NodeStatus.SUCCEEDED)
        return old_id

    def snapshot(self) -> Dict[int, Dict]:
        """Consistent inventory copy for persistence/diagnosis readers."""
        with self._lock:
            return {
                i: {
                    "status": n.status.value,
                    "relaunch_count": n.relaunch_count,
                    "max_relaunches": n.max_relaunches,
                    "quarantined": i in self._quarantined,
                    "quarantine_reason": self._quarantined.get(i, ""),
                }
                for i, n in self._nodes.items()
            }

    def force_relaunch(self, node_id: int) -> bool:
        """Diagnosis-driven relaunch: tear the host down and relaunch even
        when it still looks RUNNING (wedged-below-the-agent remediation).
        Budget-limited like every other relaunch path."""
        with self._lock:
            node = self.ensure_node(node_id)
            if node_id in self._quarantined:
                logger.warning(
                    "node %d is quarantined; refusing force relaunch",
                    node_id,
                )
                return False
            if node.relaunch_count >= node.max_relaunches:
                logger.warning(
                    "node %d relaunch budget exhausted (force)", node_id
                )
                return False
            node.relaunch_count += 1
            node.last_heartbeat = time.time()
            self._transition(node, NodeStatus.PENDING)
        self._launcher.delete(node_id)
        try:
            self._launcher.launch(node_id)
        except Exception as e:  # noqa: BLE001 - cloud APIs fail transiently
            logger.error("force relaunch of node %d failed: %s", node_id, e)
            with self._lock:
                self._transition(self.ensure_node(node_id), NodeStatus.DEAD)
            return False
        return True

    def all_succeeded(self) -> bool:
        """Worker-pool success only (same scoping as ``job_phase``):
        auxiliary pools serve the workers and never reach SUCCEEDED —
        counting them would make a finished job look unfinished forever."""
        with self._lock:
            return all(
                n.status == NodeStatus.SUCCEEDED
                for n in self._nodes.values()
                if n.node_type == "worker" and n.node_id not in self._quarantined
            )

"""Job master composition root + periodic control loop (port of
``dlrover_tpu/master/job_master.py``).

Capability ref: ``dlrover/python/master/dist_master.py:86-304``
(``prepare()``, 30s ``run()`` loop) and ``local_master.py`` (the standalone
variant ``dlrover-run`` spawns when no cluster control plane exists).
One class covers both here: the platform seam is the NodeLauncher.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.auto_scaler import JobAutoScaler
from dlrover_tpu_torch.master.kv_store import KVStore
from dlrover_tpu_torch.master.metrics import MetricsCollector
from dlrover_tpu_torch.master.node_manager import NodeLauncher, NodeManager
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
    RendezvousName,
)
from dlrover_tpu_torch.master.servicer import MasterServicer, start_master_server
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.task_manager import TaskManager


class JobMaster:
    CONTROL_LOOP_INTERVAL = 10.0
    # Consecutive reconcile ticks a PENDING node's current-generation VM
    # must read dead before it is failed: one tick of grace absorbs cloud
    # list() caches that serve the pre-delete record briefly after a
    # replacement create lands.
    PENDING_DEAD_TICKS = 2

    def __init__(
        self,
        port: int = 0,
        num_nodes: int = 1,
        node_unit: int = 1,
        launcher: Optional[NodeLauncher] = None,
        max_relaunches: int = 3,
        min_nodes: int = 0,
        rdzv_waiting_timeout: float = 60.0,
        heartbeat_timeout: float = 0.0,
        hang_threshold: float = 0.0,
        auto_scale: bool = True,
        optimize_interval_s: float = 300.0,
        state_path: str = "",
        brain_overrides: Optional[Dict[str, float]] = None,
        pools: Optional[Dict[str, int]] = None,
        metrics_port: int = 0,
        healthz_hbm_floor: float = 0.0,
    ):
        from dlrover_tpu_torch.master.calibration import CalibrationLedger
        from dlrover_tpu_torch.master.memory_ledger import MemoryLedger
        from dlrover_tpu_torch.master.timeline import JobTimeline

        self.speed_monitor = SpeedMonitor()
        self.calibration = CalibrationLedger()
        self.memory_ledger = MemoryLedger()
        self.task_manager = TaskManager()
        self.kv_store = KVStore()
        self.metrics = MetricsCollector()
        self.timeline = JobTimeline()
        self._launcher = launcher
        self._pending_dead_ticks: Dict[int, int] = {}
        self.node_manager = NodeManager(
            num_nodes=num_nodes,
            launcher=launcher,
            max_relaunches=max_relaunches,
            heartbeat_timeout=heartbeat_timeout,
            pools=pools,
        )
        # A node leaving the job through node_manager itself (retire,
        # migration completion) must drop its observability series the
        # same way the scaler's retire hook does — otherwise a replaced
        # host's samples keep skewing job aggregates and straggler stats.
        from dlrover_tpu_torch.master.node_manager import NodeStatus as _NS

        def _evict_observability(node_id, old_status, new_status):
            if new_status == _NS.SUCCEEDED:
                self.metrics.evict(node_id)
                self.timeline.evict_node(node_id)
                self.memory_ledger.evict(node_id)

        self.node_manager.add_callback(_evict_observability)
        from dlrover_tpu_torch.master.brain import RunningJobOptimizer

        self.auto_scaler = JobAutoScaler(
            self.node_manager,
            self.speed_monitor,
            metrics=self.metrics,
            min_nodes=min_nodes or num_nodes,
            max_nodes=num_nodes,
            node_unit=node_unit,
            retire_hook=self._handle_node_retired,
            # Observation-driven sizing only makes sense with an elastic
            # range; a fixed-size job gets the repair loop alone.
            # brain_overrides: the job spec's [brain] thresholds
            # (common/job_spec.py BrainSpec).
            optimizer=RunningJobOptimizer(**(brain_overrides or {}))
            if (min_nodes and min_nodes < num_nodes) else None,
            optimize_interval_s=optimize_interval_s,
        ) if auto_scale else None
        # Hang remediation (ref CheckTrainingHangOperator +
        # atorch HangingDetector): 0 disables.
        self.hang_threshold = hang_threshold
        from dlrover_tpu_torch.master.diagnosis import DiagnosisManager

        # Remediation re-fire gate keeps the pre-diagnosis semantics: wait
        # at least hang_threshold between world restarts (a restore slower
        # than a short fixed cooldown must not be re-broken mid-restore).
        self.diagnosis = DiagnosisManager(
            cooldown_s=hang_threshold or 120.0
        )
        # Master-restart persistence (ref util/state/store_mananger.py).
        self._state_store = None
        if state_path:
            from dlrover_tpu_torch.master.state_store import MasterStateStore

            self._state_store = MasterStateStore(state_path)
        elastic = ElasticTrainingRendezvousManager()
        netcheck = NetworkCheckRendezvousManager()
        for manager in (elastic, netcheck):
            manager.update_rdzv_params(
                min_nodes=min_nodes or num_nodes, max_nodes=num_nodes,
                waiting_timeout=rdzv_waiting_timeout, node_unit=node_unit,
            )
        self.rdzv_managers = {
            RendezvousName.TRAINING: elastic,
            RendezvousName.NETWORK_CHECK: netcheck,
        }
        # Creation-failure backchannel: a launcher that gives up on a VM
        # create (stockout after retries) must surface as a node failure,
        # or the node sits PENDING forever (PENDING never heartbeat-times-
        # out and counts as live in the scaler).
        if launcher is not None and hasattr(launcher, "node_failed_hook") \
                and launcher.node_failed_hook is None:
            launcher.node_failed_hook = self._handle_launch_failed
        self.servicer = MasterServicer(
            rdzv_managers=self.rdzv_managers,
            task_manager=self.task_manager,
            node_manager=self.node_manager,
            speed_monitor=self.speed_monitor,
            kv_store=self.kv_store,
            metrics=self.metrics,
            timeline=self.timeline,
            auto_scaler=self.auto_scaler,
            calibration=self.calibration,
            memory_ledger=self.memory_ledger,
        )
        self._server = None
        self.port = port
        # Live scrape surface (master/http_plane.py); 0 = off.
        self.metrics_port = metrics_port
        self.healthz_hbm_floor = healthz_hbm_floor
        self.http_plane = None
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None

    def attach_serve_frontend(self, frontend):
        """Wire a serving front door (serving/frontend.py) into the
        servicer: ServeSubmit/ServePoll/ServeCancel become live RPCs on
        the master's existing 2-RPC transport.  The fleet's retire hook
        closes the eviction gap: a drained/killed replica drops its
        timeline + serve-ledger series exactly like a retired node does."""
        self.servicer.serve_frontend = frontend
        fleet = getattr(frontend, "fleet", None)
        if fleet is not None and getattr(fleet, "retire_hook", None) is None:
            fleet.retire_hook = self._handle_replica_retired

    def _handle_replica_retired(self, rid: str):
        """A serving replica left the fleet (drain on scale-in, or death):
        evict its observability series so a retired replica's stale step
        spans and serve stats stop polluting the aggregates — the same
        contract node retirement has."""
        digits = "".join(ch for ch in str(rid) if ch.isdigit())
        if not digits:
            return
        node_id = int(digits)
        self.timeline.evict_node(node_id)
        self.speed_monitor.evict_serve(node_id)

    def prepare(self):
        self._server, self.port = start_master_server(self.servicer, self.port)
        if self.metrics_port > 0 and self.http_plane is None:
            from dlrover_tpu_torch.master.http_plane import MetricsHTTPServer

            self.http_plane = MetricsHTTPServer(
                self.servicer, port=self.metrics_port,
                healthz_hbm_floor=self.healthz_hbm_floor,
            )
            self.metrics_port = self.http_plane.start()

    def start(self):
        # Restore BEFORE the server opens: a reconnecting agent racing
        # the restore could fetch a shard that the restore then clobbers.
        if self._state_store is not None:
            self._state_store.restore(self)
        if self._server is None:
            self.prepare()
        self._loop_thread = threading.Thread(
            target=self._control_loop, name="master-loop", daemon=True
        )
        self._loop_thread.start()
        return self.port

    def _control_loop(self):
        """ref ``dist_master.py:211-269``: periodic health/housekeeping."""
        while not self._stop.is_set():
            try:
                newly_dead = self.node_manager.check_heartbeats()
                for node_id in newly_dead:
                    self._handle_node_death(node_id)
                self._reconcile_cloud()
                self.task_manager.reassign_timeout_tasks()
                if self.auto_scaler is not None:
                    self.auto_scaler.step()
                self._run_diagnosis()
                if self._state_store is not None:
                    self._state_store.save(self)
            except Exception as e:
                logger.warning("master control loop error: %s", e)
            self._stop.wait(self.CONTROL_LOOP_INTERVAL)

    def job_phase(self) -> str:
        """Operator-style job lifecycle phase (ref the ElasticJob CRD's
        status.phase, ``elasticjob_controller.go``): pending -> running ->
        succeeded | failed."""
        from dlrover_tpu_torch.master.node_manager import NodeStatus

        nm = self.node_manager
        if nm.job_failed:
            return "failed"
        # The WORKER pool decides the phase: auxiliary pools (coworker
        # preprocessing hosts) serve the workers and never "succeed".
        statuses = nm.statuses(pool="worker")
        if not statuses:
            return "pending"
        values = set(statuses.values())
        if values == {NodeStatus.SUCCEEDED.value}:
            return "succeeded"
        if NodeStatus.RUNNING.value in values or (
            NodeStatus.SUCCEEDED.value in values
        ):
            return "running"
        return "pending"

    def teardown_nodes(self):
        """Delete every node's VM through the launcher (the operator's
        job-teardown half: a finished cloud job must not leave billing
        VMs behind)."""
        if self._launcher is None:
            return
        for node_id in sorted(self.node_manager.statuses()):
            try:
                self._launcher.delete(node_id)
            except Exception as e:  # noqa: BLE001 - best-effort teardown
                logger.warning(
                    "teardown of node %d failed: %s", node_id, e
                )

    def _handle_launch_failed(self, node_id: int, reason: str):
        """The launcher exhausted its create retries: count it against the
        node's relaunch budget (repeated stockouts eventually fail the job
        instead of wedging the rendezvous on a phantom PENDING node)."""
        logger.error("node %d VM creation failed: %s", node_id, reason)
        self.node_manager.report_event(
            node_id, "failed", f"vm create: {reason}"
        )

    def bootstrap_nodes(self):
        """Create the initial inventory through the launcher (cloud jobs —
        the reference's operator creates the first pods on job submit;
        standalone local mode never calls this: the launching host IS the
        first node and ``run.py`` spawns the rest)."""
        for node_id in sorted(self.node_manager.statuses()):
            self.node_manager.launch_node(node_id, bootstrap=True)

    def _reconcile_cloud(self):
        """Map cloud VM states onto the inventory (the reference's pod
        Watcher role, as a poll — ``pod_watcher.py`` equivalent): a
        PREEMPTED/TERMINATED VM behind a node the master still thinks is
        alive gets the node-death treatment without waiting out the
        heartbeat timeout."""
        reconcile = getattr(self._launcher, "reconcile", None)
        if reconcile is None:
            return
        from dlrover_tpu_torch.master.cloud_launcher import TpuVmState
        from dlrover_tpu_torch.master.node_manager import NodeStatus

        statuses = self.node_manager.statuses()
        vm_is_current = getattr(self._launcher, "vm_is_current", None)
        pending_dead_seen = set()
        for node_id, vm_state in reconcile().items():
            if vm_state in (TpuVmState.PREEMPTED, TpuVmState.TERMINATED):
                status = statuses.get(node_id)
                if status == NodeStatus.RUNNING.value:
                    logger.warning(
                        "cloud reconcile: node %d VM is %s", node_id, vm_state
                    )
                    self.node_manager.report_event(
                        node_id, "failed", f"vm {vm_state}"
                    )
                    self._handle_node_death(node_id)
                elif status == NodeStatus.PENDING.value and (
                    vm_is_current is not None and vm_is_current(node_id)
                ):
                    # A VM preempted after its create landed but before the
                    # agent's first heartbeat: without this the node stays
                    # PENDING forever and wedges the rendezvous.  The
                    # generation check keeps the old behavior for the stale
                    # VM a relaunch is still replacing, and the
                    # consecutive-tick debounce covers laggy cloud list()
                    # caches that keep serving the pre-delete record for a
                    # few ticks after the replacement create landed.
                    pending_dead_seen.add(node_id)
                    ticks = self._pending_dead_ticks.get(node_id, 0) + 1
                    self._pending_dead_ticks[node_id] = ticks
                    if ticks < self.PENDING_DEAD_TICKS:
                        continue
                    self._pending_dead_ticks.pop(node_id, None)
                    logger.warning(
                        "cloud reconcile: PENDING node %d's current VM "
                        "died before first heartbeat (%s)",
                        node_id, vm_state,
                    )
                    self.node_manager.report_event(
                        node_id, "failed", f"vm {vm_state} before startup"
                    )
        # A healthy observation resets the debounce.
        for node_id in list(self._pending_dead_ticks):
            if node_id not in pending_dead_seen:
                del self._pending_dead_ticks[node_id]

    def _run_diagnosis(self):
        """One inference-chain pass; execute what it prescribes (ref
        ``inference_chain.py:28-62`` + ``check_training_hang_operator``)."""
        from dlrover_tpu_torch.master.diagnosis import (
            ActionType,
            DiagnosisContext,
        )

        ctx = DiagnosisContext(
            speed_monitor=self.speed_monitor,
            metrics=self.metrics,
            node_manager=self.node_manager,
            hang_threshold=self.hang_threshold,
            timeline=self.timeline,
            memory=self.memory_ledger,
        )
        for action in self.diagnosis.run(ctx):
            logger.error("diagnosis remediation: %s (%s)",
                         action.action, action.reason)
            if action.action == ActionType.RESTART_WORLD:
                for manager in self.rdzv_managers.values():
                    manager.invalidate_world()
                self.speed_monitor.reset_running_speed()
            elif action.action == ActionType.RELAUNCH_NODE:
                # The target still heartbeats (it is wedged, not dead):
                # force teardown + relaunch, not the repair-path launch that
                # no-ops on RUNNING nodes.
                self.node_manager.force_relaunch(action.node_id)
            elif action.action == ActionType.QUARANTINE:
                self._quarantine_node(action.node_id, action.reason)

    def _quarantine_node(self, node_id: int, reason: str):
        """Eject a silently-corrupting host: blacklist it, ban it from every
        rendezvous, request a replacement, and restart the world onto the
        last verified checkpoint (the survivors' re-join goes through the
        cross-world restore path, which drops the poisoned in-memory
        state)."""
        self.node_manager.quarantine(node_id, reason)
        for manager in self.rdzv_managers.values():
            manager.ban_node(node_id)
            manager.invalidate_world()
        self.servicer.sync_service.remove_node(node_id)
        self.task_manager.recover_tasks(node_id)
        self.speed_monitor.record_sdc_quarantine(node_id)
        # A quarantined host's memory snapshot must not keep weighing on
        # the fleet headroom aggregates (same contract as retirement).
        self.memory_ledger.evict(node_id)
        self.speed_monitor.begin_resize(reason=f"quarantine:{node_id}")
        self.speed_monitor.reset_running_speed()
        if self.auto_scaler is not None:
            self.auto_scaler.note_quarantine(node_id)

    def _handle_node_death(self, node_id: int):
        """Silent host death (heartbeat timeout) gets the same recovery as a
        reported failure (ref ``dist_job_manager.py:355-400``): evict it from
        every rendezvous so survivors see the broken world and re-form,
        requeue its unfinished data shards, reset the speed window."""
        logger.warning("node %d declared dead (heartbeat timeout)", node_id)
        for manager in self.rdzv_managers.values():
            manager.remove_alive_node(node_id)
        self.servicer.sync_service.remove_node(node_id)
        self.task_manager.recover_tasks(node_id)
        self.speed_monitor.reset_running_speed()
        if self.auto_scaler is None or (
            self.node_manager.pool_of(node_id) != "worker"
        ):
            # No scaler repair loop — or an auxiliary-pool node, which
            # the scaler (worker-pool-scoped by design) never repairs:
            # relaunch directly (budget-limited).
            self.node_manager.launch_node(node_id)

    def _handle_node_retired(self, node_id: int):
        """Scale-down teardown: survivors must see the broken world and
        re-form (otherwise their trainers hang in dead collectives).  The
        departed node's observability series go too — a retired host's
        stale resource samples and step durations would pollute job
        aggregates (mean_cpu, staleness sweeps) and straggler stats."""
        for manager in self.rdzv_managers.values():
            manager.remove_alive_node(node_id)
        self.task_manager.recover_tasks(node_id)
        self.metrics.evict(node_id)
        self.timeline.evict_node(node_id)
        self.memory_ledger.evict(node_id)

    def stop(self):
        self._stop.set()
        if self._loop_thread:
            self._loop_thread.join(timeout=5)
        if self.http_plane is not None:
            self.http_plane.stop()
            self.http_plane = None
        if self._server:
            self._server.stop()
            self._server = None

    def run_forever(self):
        """Block until the job ends (all nodes succeeded or job failed)."""
        try:
            while not self._stop.is_set():
                if self.node_manager.job_failed:
                    logger.error(
                        "job failed: %s", self.node_manager.job_failure_reason
                    )
                    return 1
                if self.node_manager.all_succeeded():
                    logger.info("job succeeded")
                    return 0
                time.sleep(2)
        finally:
            self.stop()
        return 0


def main():  # python -m dlrover_tpu_torch.master.job_master --port N --nodes N
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--nodes", type=int, default=1)
    parser.add_argument("--min-nodes", type=int, default=0)
    parser.add_argument("--node-unit", type=int, default=1)
    parser.add_argument("--heartbeat-timeout", type=float, default=0.0)
    parser.add_argument("--metrics-port", type=int, default=0,
                        help="HTTP scrape port for /metrics /timeline "
                             "/healthz /memory (0 = off)")
    parser.add_argument("--healthz-hbm-floor", type=float, default=0.0,
                        help="flip /healthz not-ok when measured HBM "
                             "headroom drops below this fraction "
                             "(0 = off)")
    args = parser.parse_args()
    master = JobMaster(
        port=args.port, num_nodes=args.nodes, node_unit=args.node_unit,
        min_nodes=args.min_nodes, heartbeat_timeout=args.heartbeat_timeout,
        metrics_port=args.metrics_port,
        healthz_hbm_floor=args.healthz_hbm_floor,
    )
    master.start()
    print(f"DLROVER_TPU_MASTER_PORT={master.port}", flush=True)
    raise SystemExit(master.run_forever())


if __name__ == "__main__":
    main()

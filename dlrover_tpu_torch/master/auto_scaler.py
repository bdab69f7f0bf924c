"""Auto-scaling loop: observe, decide, actuate through the NodeLauncher
(port of ``dlrover_tpu/master/auto_scaler.py``).

Capability ref: ``dlrover/python/master/node/job_auto_scaler.py:73-317``
(``AllreduceTrainingAutoScaler._periodic_optimize_running_resource``) and the
ScalePlan flow (``master/scaler/base_scaler.py``; the operator applies pod
deltas — here the launcher seam does).

The schedulable unit is a host, so a ScalePlan is just a desired host count
(``node_unit``-aligned).  Policy:

* **repair** — a host that died (heartbeat timeout / reported node failure)
  is relaunched through the launcher while relaunch budget remains;
* **target tracking** — a manual/planned target (``set_target``) is
  converged on by launching or deleting hosts;
* **observation-driven sizing** — with an ``optimizer``
  (``master/brain.RunningJobOptimizer``) the target moves from the
  observed throughput history, on a timer, with no operator input;
* **serving** — ``ServeScalePolicy`` moves the target from the serve
  ledger; ``serving/fleet.ReplicaFleet.maybe_scale`` evaluates the same
  policy over the fleet's own statistics.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.brain import Observation, RunningJobOptimizer
from dlrover_tpu_torch.master.metrics import MetricsCollector
from dlrover_tpu_torch.master.node_manager import NodeManager, NodeStatus
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor


@dataclasses.dataclass
class ScalePlan:
    """One actuation decision (ref ScalePlan CRD, slice-granular)."""

    target_nodes: int
    launch: List[int] = dataclasses.field(default_factory=list)
    delete: List[int] = dataclasses.field(default_factory=list)
    reason: str = ""

    @property
    def empty(self) -> bool:
        return not self.launch and not self.delete


@dataclasses.dataclass
class ServeScalePolicy:
    """Replica policy for the serving plane.

    Scale out when the fleet's worst-replica p95 breaches the SLO or the
    slot pools run hot; scale in only when both latency and occupancy sit
    comfortably low (shrinking on latency alone would thrash against a
    bursty arrival process).  ``min_qps`` ignores idle or starting ledgers
    whose quantiles carry no signal, and ``min_samples`` ignores p95s over
    fewer completed requests than that (occupancy still acts).
    ``prefill_backlog_high`` drives a disaggregated fleet's prefill pool:
    queued prompts per prefill replica above it spawn a prefill replica,
    whatever the decode pool's signals.
    """

    slo_p95_s: float = 1.0
    occupancy_high: float = 0.85
    occupancy_low: float = 0.30
    min_qps: float = 0.0
    min_samples: int = 8
    prefill_backlog_high: float = 4.0


class JobAutoScaler:
    def __init__(
        self,
        node_manager: NodeManager,
        speed_monitor: SpeedMonitor,
        metrics: Optional[MetricsCollector] = None,
        min_nodes: int = 1,
        max_nodes: int = 1,
        node_unit: int = 1,
        cooldown_s: float = 30.0,
        retire_hook: Optional[Callable[[int], None]] = None,
        optimizer: Optional[RunningJobOptimizer] = None,
        optimize_interval_s: float = 300.0,
        serve_policy: Optional[ServeScalePolicy] = None,
    ):
        self.node_manager = node_manager
        self.speed_monitor = speed_monitor
        self.metrics = metrics or MetricsCollector()
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.node_unit = max(1, node_unit)
        self.cooldown_s = cooldown_s
        # Called per retired node AFTER launcher teardown: the master wires
        # rendezvous eviction + shard requeue here so survivors see the
        # broken world and re-form instead of hanging in dead collectives.
        self.retire_hook = retire_hook
        # Observation-driven sizing (ref _periodic_optimize_running_resource):
        # None disables; the repair/target-tracking loop still runs.
        self.optimizer = optimizer
        self.optimize_interval_s = optimize_interval_s
        # Latency/occupancy-driven serving replica policy: None disables.
        self.serve_policy = serve_policy
        self._target = max_nodes
        self._last_scale = 0.0
        self._lock = threading.Lock()
        self.plans: deque = deque(maxlen=256)
        # First optimize only after a full interval of observations.
        self._last_optimize = time.monotonic()

    def set_target(self, target_nodes: int, reason: str = "manual"):
        """Request a new world size (node_unit-aligned, clamped to range)."""
        aligned = max(
            self.min_nodes,
            min(self.max_nodes,
                (target_nodes // self.node_unit) * self.node_unit),
        )
        with self._lock:
            if aligned != self._target:
                logger.info(
                    "scale target %d -> %d (%s)", self._target, aligned, reason
                )
                self._target = aligned

    @property
    def target(self) -> int:
        with self._lock:
            return self._target

    def note_preemption(self, node_id: int) -> ScalePlan:
        """A node announced its own preemption: shrink the target around it
        and retire it immediately — no cooldown, no heartbeat wait.

        The regular ``decide()`` loop would treat the disappearing node as
        damage to repair (relaunch toward the old target); a preemption is
        capacity *leaving*, so the target follows the survivors and the
        world re-forms smaller.  A later ``set_target`` (operator or brain)
        can grow it back once capacity returns.
        """
        statuses = self.node_manager.statuses(pool="worker")
        survivors = [
            n for n, s in statuses.items()
            if n != node_id
            and s in (NodeStatus.RUNNING.value, NodeStatus.PENDING.value)
        ]
        plan = ScalePlan(
            target_nodes=len(survivors),
            delete=[node_id],
            reason=f"preemption notice from node {node_id}",
        )
        self.set_target(len(survivors), reason=plan.reason)
        self.plans.append(plan)
        logger.info(
            "preemption scale plan: delete=%s target=%d",
            plan.delete, plan.target_nodes,
        )
        self.node_manager.retire_node(node_id)
        if self.retire_hook is not None:
            self.retire_hook(node_id)
        self.speed_monitor.reset_running_speed()
        return plan

    def note_quarantine(self, node_id: int) -> ScalePlan:
        """A node was quarantined for silent data corruption: request a
        replacement at a FRESH id, keeping the target unchanged.

        Unlike ``note_preemption`` (capacity leaving — the target follows
        the survivors), a quarantine is capacity going BAD: the job still
        wants the same world size, and the regular repair loop can never
        supply it because ``relaunchable()`` is pinned False for the
        blacklisted id.  The replacement id is minted past the pool's
        current maximum, exactly like a typed-pool migration.
        """
        statuses = self.node_manager.statuses(pool="worker")
        new_id = max(statuses, default=-1) + 1
        plan = ScalePlan(
            target_nodes=self.target,
            launch=[new_id],
            delete=[node_id],
            reason=f"quarantine of node {node_id}",
        )
        self.plans.append(plan)
        logger.info(
            "quarantine scale plan: delete=[%d] launch=[%d] target=%d",
            node_id, new_id, plan.target_nodes,
        )
        # The quarantined host's launcher teardown already ran inside
        # ``node_manager.quarantine``; only the replacement launch and the
        # master-side retire bookkeeping remain.
        self.node_manager.launch_node(new_id, bootstrap=True)
        if self.retire_hook is not None:
            self.retire_hook(node_id)
        self.speed_monitor.reset_running_speed()
        return plan

    def decide(self) -> ScalePlan:
        """Compare live inventory with the target; no side effects."""
        statuses = self.node_manager.statuses(pool="worker")
        live = [
            n for n, s in statuses.items()
            if s in (NodeStatus.RUNNING.value, NodeStatus.PENDING.value)
        ]
        # A worker whose trainer finished is done, not missing: the
        # reference repairs it and so relaunches a finished job's nodes.
        done = [n for n in self.node_manager.finished() if n in statuses]
        target = self.target
        plan = ScalePlan(target_nodes=target)
        if len(live) + len(done) < target:
            # Repair/up-scale: (re)launch the lowest missing node ids whose
            # relaunch budget remains (a permanently-failed node must not
            # produce a futile plan every cooldown tick forever).
            missing = [
                n for n in range(self.max_nodes)
                if n not in live and n not in done
                and self.node_manager.relaunchable(n)
            ][: target - len(live) - len(done)]
            plan.launch = missing
            plan.reason = f"live {len(live)} < target {target}"
        elif len(live) > target:
            # Down-scale: retire the highest node ids (keeps rank-0 stable).
            plan.delete = sorted(live, reverse=True)[: len(live) - target]
            plan.reason = f"live {len(live)} > target {target}"
        return plan

    def observe_and_optimize(self) -> None:
        """Feed the running-job optimizer and move the target from its
        recommendation — the observation-driven half of the scaler (ref
        ``job_auto_scaler.py:161`` periodic optimize; no ``set_target``
        call from any operator involved)."""
        if self.optimizer is None:
            return
        now = time.monotonic()
        statuses = self.node_manager.statuses(pool="worker")
        live = sum(
            1 for s in statuses.values() if s == NodeStatus.RUNNING.value
        )
        speed = self.speed_monitor.running_speed()
        # Observations are recorded only for a STEADY world (live == target):
        # right after a death/resize the speed window can still span the old
        # world, and attributing its throughput to the new size poisons the
        # per-size history (retreat would then permanently shrink the job).
        if live > 0 and speed > 0 and live == self.target:
            self.optimizer.observe(
                Observation(
                    num_nodes=live, speed=speed,
                    goodput=self.speed_monitor.goodput(),
                )
            )
        if now - self._last_optimize < self.optimize_interval_s:
            return
        self._last_optimize = now
        if live == 0 or live != self.target:
            # A repair or an in-flight resize is converging: sizing off a
            # transiently-shrunk world would cancel the repair.
            return
        plan = self.optimizer.recommend(
            current_nodes=live, min_nodes=self.min_nodes,
            max_nodes=self.max_nodes, node_unit=self.node_unit,
        )
        if plan.num_nodes != self.target:
            self.set_target(plan.num_nodes, reason=f"brain: {plan.reason}")
        elif "degraded" in plan.reason:
            # Same-size degradation is a world-HEALTH problem, not a sizing
            # problem: surface it loudly so the operator (or the diagnosis
            # chain reading the log/metrics) can act — silence here would
            # let the job limp at a fraction of its proven speed forever.
            logger.warning("brain health: %s", plan.reason)

    def observe_serving(self) -> None:
        """Move the target from the serving ledger (the serving analogue
        of ``observe_and_optimize``): p95-SLO breach or hot slot pools
        scale out one node_unit; cold pools under half the SLO scale in.
        ``set_target`` clamps/aligns; the ``decide`` loop actuates under
        the usual cooldown."""
        policy = self.serve_policy
        if policy is None:
            return
        ledger = self.speed_monitor.serve_ledger()
        if ledger["replicas"] < 1 or ledger["qps"] < policy.min_qps:
            return
        target = self.target
        p95 = ledger["p95_s"]
        occupancy = ledger["occupancy"]
        # A p95 backed by too few completed requests is treated as
        # unknown: it neither triggers a breach scale-out nor licenses an
        # idle scale-in (occupancy, always well-sampled, still acts).
        if ledger.get("p95_n", float("inf")) < policy.min_samples:
            if occupancy > policy.occupancy_high:
                self.set_target(
                    target + self.node_unit,
                    reason=f"serve: occupancy {occupancy:.2f} (p95 "
                    "unconfident)",
                )
            return
        if p95 > policy.slo_p95_s or occupancy > policy.occupancy_high:
            self.set_target(
                target + self.node_unit,
                reason=(
                    f"serve: p95 {p95:.3f}s (slo {policy.slo_p95_s}s), "
                    f"occupancy {occupancy:.2f}"
                ),
            )
        elif (
            p95 < 0.5 * policy.slo_p95_s
            and occupancy < policy.occupancy_low
        ):
            self.set_target(
                target - self.node_unit,
                reason=(
                    f"serve: idle (p95 {p95:.3f}s, occupancy "
                    f"{occupancy:.2f})"
                ),
            )

    def step(self) -> Optional[ScalePlan]:
        """One control-loop tick: decide and actuate (cooldown-limited)."""
        self.observe_and_optimize()
        self.observe_serving()
        now = time.monotonic()
        if now - self._last_scale < self.cooldown_s:
            return None
        plan = self.decide()
        if plan.empty:
            return None
        self._last_scale = now
        self.plans.append(plan)
        logger.info(
            "scale plan: launch=%s delete=%s (%s)",
            plan.launch, plan.delete, plan.reason,
        )
        for node_id in plan.launch:
            self.node_manager.launch_node(node_id)
        for node_id in plan.delete:
            self.node_manager.retire_node(node_id)
            if self.retire_hook is not None:
                self.retire_hook(node_id)
        # The gap until the re-formed world's first step report is downtime,
        # and speed samples must not straddle the resize (the optimizer
        # would attribute the old world's speed to the new size).
        self.speed_monitor.reset_running_speed()
        return plan

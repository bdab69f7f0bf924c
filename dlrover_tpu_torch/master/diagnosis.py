"""Diagnosis subsystem: observation -> inference chain -> remediation
(port of ``dlrover_tpu/master/diagnosis.py``).

Capability ref: ``dlrover/python/master/diagnosis/``
(``inferencechain/inference_chain.py:28-62`` rule engine,
``operator/check_training_hang_operator.py:26`` hang rule,
``diagnosis.py`` manager loop) and the in-trainer
``atorch/atorch/fault_tolerance/hanging_detector.py:86-137``.

One pass of the chain turns master-side observations (speed monitor,
metrics time series, node inventory) into prioritized actions the master
executes: restart the world, relaunch a node, or surface a report.  Each
operator is independent and composable — adding a diagnosis rule is adding
one class with ``observe``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class ActionType:
    NONE = "none"
    RESTART_WORLD = "restart_world"   # break rendezvous; agents restart
    RELAUNCH_NODE = "relaunch_node"   # node-level relaunch via launcher
    QUARANTINE = "quarantine"         # eject + blacklist a corrupting node
    REPORT = "report"                 # surfaced only (operator judgment)


@dataclasses.dataclass
class DiagnosisAction:
    action: str
    reason: str
    node_id: int = -1
    severity: int = 0   # higher wins when actions conflict


class InferenceOperator:
    """One diagnosis rule: look at the master state, emit actions."""

    name = "base"

    def observe(self, ctx: "DiagnosisContext") -> List[DiagnosisAction]:
        raise NotImplementedError


@dataclasses.dataclass
class DiagnosisContext:
    """The read surface operators see (no direct mutation)."""

    speed_monitor: object
    metrics: object
    node_manager: object
    hang_threshold: float = 300.0
    resource_stale_s: float = 300.0
    # Merged job timeline (master/timeline.py) — step-skew evidence for
    # the StragglerOperator.  Optional: None disables skew rules.
    timeline: object = None
    # Classified HBM ledger (master/memory_ledger.py) — measured
    # headroom for the HBMPressureOperator.  None disables it.
    memory: object = None


class TrainingHangOperator(InferenceOperator):
    """No global-step progress past the threshold while nodes look alive:
    a wedged collective or data stall — restart the world."""

    name = "training_hang"

    def observe(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        sm = ctx.speed_monitor
        if not ctx.hang_threshold or sm.global_step == 0:
            return []
        stalled = sm.no_progress_for()
        if stalled <= ctx.hang_threshold:
            return []
        return [
            DiagnosisAction(
                ActionType.RESTART_WORLD,
                reason=(
                    f"no step progress for {stalled:.0f}s "
                    f"(> {ctx.hang_threshold:.0f}s)"
                ),
                severity=2,
            )
        ]


class ResourceStallOperator(InferenceOperator):
    """A node that heartbeats but stopped reporting resources is wedged
    below the agent (stuck trainer, dead monitor thread): flag it; paired
    with a hang it upgrades to a relaunch."""

    name = "resource_stall"

    def observe(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        if ctx.metrics is None:
            return []
        stale = ctx.metrics.stale_nodes(ctx.resource_stale_s)
        return [
            DiagnosisAction(
                ActionType.REPORT,
                reason=f"node {node} stopped reporting resources",
                node_id=node,
                severity=1,
            )
            for node in stale
        ]


class NodeFlappingOperator(InferenceOperator):
    """A node burning through its relaunch budget is probably bad hardware:
    surface it before the budget silently fails the job (ref
    ``_should_relaunch`` exit-code classification)."""

    name = "node_flapping"

    def observe(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        out = []
        for node_id, state in ctx.node_manager.snapshot().items():
            budget = state["max_relaunches"]
            if state["relaunch_count"] >= max(1, budget - 1):
                out.append(
                    DiagnosisAction(
                        ActionType.REPORT,
                        reason=(
                            f"node {node_id} relaunched "
                            f"{state['relaunch_count']}x (budget "
                            f"{budget}) — suspect hardware"
                        ),
                        node_id=node_id,
                        severity=1,
                    )
                )
        return out


class StragglerOperator(InferenceOperator):
    """Cross-node step-skew attribution from the job timeline: in a
    synchronous SPMD step every host blocks on the slowest participant, so
    one node persistently above K x the per-step median silently taxes the
    whole job (same signal class the network-check rendezvous measures,
    but continuous, from real training steps).  Surfaced as a REPORT —
    demoting a slow-but-correct host is an operator/scaler policy call.
    """

    name = "straggler"
    SKEW_RATIO = 2.0       # K: slow means > K x per-step median
    MIN_STEPS = 8          # attribution window must hold this many steps
    MIN_SKEW_FRACTION = 0.5  # ...and the node slow in at least this share

    def observe(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        timeline = getattr(ctx, "timeline", None)
        if timeline is None:
            return []
        observed = timeline.steps_observed()
        if observed < self.MIN_STEPS:
            return []
        skew = timeline.step_skew(self.SKEW_RATIO)
        out = []
        for node_id, slow_steps in sorted(skew.items()):
            if slow_steps < self.MIN_SKEW_FRACTION * observed:
                continue
            stats = timeline.step_stats().get(node_id, {})
            out.append(
                DiagnosisAction(
                    ActionType.REPORT,
                    reason=(
                        f"node {node_id} is a straggler: slower than "
                        f"{self.SKEW_RATIO:g}x the step median in "
                        f"{slow_steps}/{observed} recent steps "
                        f"(p50 {stats.get('p50', 0.0):.3f}s)"
                    ),
                    node_id=node_id,
                    severity=1,
                )
            )
        return out


class NumericAnomalyOperator(InferenceOperator):
    """Numeric-health input to the chain (ref ``loss_spike_utils.py`` +
    ``numberic_checker.py``, which the reference leaves as offline tools —
    here the signal closes the loop):

    * a reported **nan** poisons every replica of the state — restarting
      the world restores the last good checkpoint (severity above a hang:
      continuing to step a NaN'd model productively burns the job);
    * sustained **loss_spike** / **grad_explosion** reports are surfaced
      (an operator decision: could be bad data or an LR cliff — automatic
      rollback of a *finite* divergence is a policy call, not a reflex).
    """

    name = "numeric_anomaly"
    SPIKE_REPORT_THRESHOLD = 2  # distinct spike reports inside the window

    def __init__(self):
        # A stale NaN report must trigger ONE restart, not one per
        # cooldown until it ages out of the window.
        self._consumed_ts = 0.0

    def observe(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        sm = ctx.speed_monitor
        recent = getattr(sm, "recent_anomalies", lambda: [])()
        if not recent:
            return []
        out: List[DiagnosisAction] = []
        nans = [
            a for a in recent
            if a[2].startswith("nan@") and a[0] > self._consumed_ts
        ]
        if nans:
            self._consumed_ts = nans[-1][0]
            out.append(DiagnosisAction(
                ActionType.RESTART_WORLD,
                reason=(
                    f"non-finite training state reported: {nans[-1][2]} — "
                    "restoring last good checkpoint"
                ),
                severity=3,
            ))
        spikes = [a for a in recent if not a[2].startswith("nan@")]
        if len(spikes) >= self.SPIKE_REPORT_THRESHOLD:
            out.append(DiagnosisAction(
                ActionType.REPORT,
                reason=(
                    f"{len(spikes)} numeric anomalies in window "
                    f"(latest: {spikes[-1][2]})"
                ),
                severity=1,
            ))
        return out


class SDCVoteOperator(InferenceOperator):
    """Silent-data-corruption attribution from the digest ledger.

    Every replica's post-update state digest (trainer/state_digest.py) is
    majority-voted per step by the speed monitor; a node voted into the
    minority on ``STREAK_THRESHOLD`` consecutive checks is computing wrong
    numbers — quarantine it (blacklist + eject + replace) and restart the
    world onto the last verified checkpoint.  A single transient mismatch
    (one flipped bit in activation memory, a racy read) only surfaces a
    REPORT that asks the agent for a golden-batch confirm probe; the
    quarantine trigger must be persistent state corruption, which the
    checkpoint restore cannot wash out.
    """

    name = "sdc_vote"
    STREAK_THRESHOLD = 2  # consecutive minority votes before quarantine

    def __init__(self):
        # Same one-shot latch as NumericAnomalyOperator: a mismatch count
        # that stopped moving must not re-trigger every control tick.
        self._consumed_mismatches = 0

    def observe(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        sm = ctx.speed_monitor
        ledger = getattr(sm, "sdc_ledger", lambda: None)()
        if not ledger or not ledger["mismatches"]:
            return []
        out: List[DiagnosisAction] = []
        fresh = ledger["mismatches"] > self._consumed_mismatches
        # Latch NOW: whatever this tick surfaces (confirm REPORT or
        # QUARANTINE), the same mismatch count must not re-trigger it
        # every control tick — only fresh evidence reopens the gate.
        self._consumed_mismatches = ledger["mismatches"]
        for node_id, streak in sorted(ledger["streaks"].items()):
            if streak >= self.STREAK_THRESHOLD:
                out.append(DiagnosisAction(
                    ActionType.QUARANTINE,
                    reason=(
                        f"node {node_id} SDC: state digest in the minority "
                        f"on {streak} consecutive checks (last mismatch at "
                        f"step {ledger['last_mismatch_step']}) — "
                        "quarantining and restoring last verified checkpoint"
                    ),
                    node_id=node_id,
                    severity=4,
                ))
            elif fresh:
                out.append(DiagnosisAction(
                    ActionType.REPORT,
                    reason=(
                        f"node {node_id} SDC suspect: transient digest "
                        f"mismatch at step {ledger['last_mismatch_step']} — "
                        "golden-batch confirm probe advised"
                    ),
                    node_id=node_id,
                    severity=1,
                ))
        return out


class StepRegressionOperator(InferenceOperator):
    """Performance-regression sentinel over the job's step-time series.

    Freezes a p50 baseline from the first ``MIN_STEPS`` steps of a
    *program generation* — the generation key is (compile events,
    resizes), so any recompile or elastic resize starts a fresh baseline
    instead of tripping the alarm (a resize legitimately changes the step
    time; that's a re-layout, not a regression).  Within a stable
    generation, a recent p50 drifting more than ``DRIFT`` above the
    baseline is the machine-got-slower signature (thermal throttling, a
    sick interconnect, noisy neighbor) and surfaces ONE latched REPORT,
    counted on ``dlrover_perf_regressions_total``.
    """

    name = "step_regression"
    MIN_STEPS = 8          # steps to freeze the baseline / judge recency
    DRIFT = 1.15           # recent p50 > 1.15x baseline p50 fires

    def __init__(self):
        self._generation = None
        self._baseline: Optional[float] = None
        self._pending: List[float] = []
        self._fired = False

    @staticmethod
    def _p50(values: List[float]) -> float:
        ordered = sorted(values)
        return ordered[len(ordered) // 2]

    def observe(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        if ctx.timeline is None:
            return []
        sm = ctx.speed_monitor
        compile_events = getattr(
            sm, "compile_ledger", lambda: {}
        )().get("compile_events", 0)
        resizes = getattr(
            sm, "resize_ledger", lambda: {}
        )().get("resizes", 0)
        generation = (compile_events, resizes)
        if generation != self._generation:
            # New program generation: everything seen so far priced a
            # different program/world — reset and relearn.
            self._generation = generation
            self._baseline = None
            self._pending = []
            self._fired = False
        series = ctx.timeline.step_time_series()
        if self._baseline is None:
            # Freeze the baseline from the generation's FIRST window.
            self._pending = [d for _, d in series[-self.MIN_STEPS:]]
            if len(self._pending) >= self.MIN_STEPS:
                self._baseline = self._p50(self._pending)
            return []
        if self._fired or len(series) < 2 * self.MIN_STEPS:
            return []
        recent = self._p50([d for _, d in series[-self.MIN_STEPS:]])
        if self._baseline <= 0 or recent <= self.DRIFT * self._baseline:
            return []
        self._fired = True  # one report per generation, not per tick
        if hasattr(ctx.timeline, "bump"):
            ctx.timeline.bump("perf_regressions")
        return [DiagnosisAction(
            ActionType.REPORT,
            reason=(
                f"step time regressed: recent p50 {recent:.4f}s vs "
                f"baseline {self._baseline:.4f}s "
                f"(+{(recent / self._baseline - 1) * 100:.0f}%) with no "
                "compile or resize in the window"
            ),
            severity=1,
        )]


class HBMPressureOperator(InferenceOperator):
    """Measured HBM headroom below the floor: the OOM early-warning.

    Reads the classified MemoryLedger (utils/memory_profile events —
    *measured* allocator headroom, not tune's modeled bytes) and
    surfaces ONE latched REPORT naming the tightest node while any node
    sits under ``HEADROOM_FLOOR``; re-arms once every node recovers
    past the floor plus hysteresis.  Nodes that cannot price headroom
    (no allocator limit — the CPU fallback) report ``-1`` and are
    skipped: unknown is not pressure.  This is the HBM-pressure re-plan
    signal ROADMAP item 4 names.
    """

    name = "hbm_pressure"
    HEADROOM_FLOOR = 0.05   # fire below 5% measured headroom
    HYSTERESIS = 0.02       # re-arm above floor + 2%

    def __init__(self, floor: Optional[float] = None):
        if floor is not None:
            self.HEADROOM_FLOOR = floor
        self._fired = False

    def observe(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        if ctx.memory is None or not len(ctx.memory):
            return []
        pressured = [
            (snap["headroom_frac"], node_id)
            for node_id, snap in ctx.memory.per_node().items()
            if 0.0 <= snap.get("headroom_frac", -1.0)
            < self.HEADROOM_FLOOR
        ]
        if not pressured:
            fleet = ctx.memory.headroom_frac()
            if fleet < 0.0 or fleet > self.HEADROOM_FLOOR + self.HYSTERESIS:
                self._fired = False
            return []
        if self._fired:
            return []
        self._fired = True
        headroom, node_id = min(pressured)
        return [
            DiagnosisAction(
                ActionType.REPORT,
                reason=(
                    f"measured HBM headroom {headroom:.1%} below "
                    f"{self.HEADROOM_FLOOR:.0%} floor on "
                    f"{len(pressured)} node(s)"
                ),
                node_id=node_id,
                severity=2,
            )
        ]


class InferenceChain:
    """Run the operators, combine evidence, rank the produced actions.

    Cross-rule inference (the "chain" in the reference's InferenceChain): a
    hang observed TOGETHER with a node that stopped reporting resources
    localizes the fault — the stalled node is relaunched instead of (only)
    restarting the world blind.
    """

    def __init__(self, operators: Optional[List[InferenceOperator]] = None):
        self.operators = operators or [
            TrainingHangOperator(),
            ResourceStallOperator(),
            NodeFlappingOperator(),
            StragglerOperator(),
            NumericAnomalyOperator(),
            SDCVoteOperator(),
            StepRegressionOperator(),
            HBMPressureOperator(),
        ]

    def infer(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        actions: List[DiagnosisAction] = []
        for op in self.operators:
            try:
                actions.extend(op.observe(ctx))
            except Exception as e:  # noqa: BLE001 - one rule must not kill all
                logger.warning("diagnosis operator %s failed: %s", op.name, e)
        hang = any(a.action == ActionType.RESTART_WORLD for a in actions)
        if hang:
            for action in actions:
                if (
                    action.action == ActionType.REPORT
                    and "stopped reporting resources" in action.reason
                ):
                    action.action = ActionType.RELAUNCH_NODE
                    action.reason += " during a training hang"
                    action.severity = 3
        return sorted(actions, key=lambda a: -a.severity)


class DiagnosisManager:
    """Periodic chain execution + remediation bookkeeping for the master."""

    def __init__(
        self,
        chain: Optional[InferenceChain] = None,
        cooldown_s: float = 120.0,
    ):
        self.chain = chain or InferenceChain()
        self.cooldown_s = cooldown_s
        self._last_remediation = 0.0
        self.reports: List[DiagnosisAction] = []
        self._seen_reports: set = set()

    def run(self, ctx: DiagnosisContext) -> List[DiagnosisAction]:
        """Returns the actions the caller should EXECUTE (cooldown-gated);
        REPORT actions are recorded once per distinct finding on
        ``self.reports`` (a persistent condition must not re-log every
        control tick)."""
        actions = self.chain.infer(ctx)
        to_execute = []
        now = time.monotonic()
        # One cooldown gate per TICK, not per action: a tick prescribing
        # both a node relaunch and a world restart must execute both (the
        # relaunch alone would no-op the hang it was paired with).
        may_remediate = now - self._last_remediation >= self.cooldown_s
        for action in actions:
            if action.action == ActionType.REPORT:
                key = (action.node_id, action.reason)
                if key in self._seen_reports:
                    continue
                self._seen_reports.add(key)
                if len(self._seen_reports) > 1000:
                    self._seen_reports.clear()
                self.reports.append(action)
                self.reports = self.reports[-100:]
                logger.warning("diagnosis: %s", action.reason)
            elif may_remediate:
                self._last_remediation = now
                to_execute.append(action)
        return to_execute

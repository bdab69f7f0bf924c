"""Brain-lite: job-history store + resource optimization service (port of
``dlrover_tpu/master/brain.py``).

Capability ref: the reference's Brain tier — ``dlrover/go/brain/``
(optimize() RPCs over a MySQL job-metrics store; algorithms in
``pkg/optimizer/implementation/*``), its python client
(``dlrover/python/brain/client.py``) and the master-local fallback
(``master/resource/local_optimizer.py:66-397``).

TPU redesign: the persistent tier is a JSON history file (one record per
completed job: model scale, mesh, throughput, goodput) instead of MySQL,
and ``optimize()`` recommends a ResourcePlan for a new job from the most
similar past runs — the same observe-and-recommend loop at laptop scale.
The JobMaster records its own run on stop; the auto-scaler's ``set_target``
is the actuation path for a recommendation.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger


@dataclasses.dataclass
class JobRecord:
    job_name: str
    model_params: int            # parameter count (scale proxy)
    num_nodes: int
    global_batch_size: int
    tokens_per_sec: float = 0.0
    goodput: float = 0.0
    completed: bool = True
    timestamp: float = 0.0


@dataclasses.dataclass
class ResourcePlan:
    """What the optimizer recommends (slice-granular node count + batch)."""

    num_nodes: int
    global_batch_size: int
    reason: str = ""
    confidence: float = 0.0


class BrainService:
    """History store + recommendation algorithms (local file backend)."""

    def __init__(self, history_path: str):
        self.history_path = history_path
        self._records: List[JobRecord] = []
        self._load()

    def _load(self):
        if not os.path.exists(self.history_path):
            return
        try:
            faults.fire(
                "storage.read", path=os.path.basename(self.history_path)
            )
            with open(self.history_path) as f:
                raw = json.load(f)
            self._records = [JobRecord(**r) for r in raw]
        except (OSError, ValueError, TypeError, faults.FaultInjected) as e:
            logger.warning("brain history unreadable (%s); starting empty", e)

    def persist_metrics(self, record: JobRecord):
        """The Brain.persist_metrics() equivalent."""
        record.timestamp = record.timestamp or time.time()
        self._records.append(record)
        tmp = self.history_path + ".tmp"
        os.makedirs(os.path.dirname(self.history_path) or ".", exist_ok=True)
        faults.fire(
            "storage.write", path=os.path.basename(self.history_path)
        )
        with open(tmp, "w") as f:
            json.dump(
                [dataclasses.asdict(r) for r in self._records[-1000:]], f
            )
        os.replace(tmp, self.history_path)

    def get_job_metrics(self, job_name: str) -> List[JobRecord]:
        return [r for r in self._records if r.job_name == job_name]

    def optimize(
        self,
        model_params: int,
        max_nodes: int,
        min_nodes: int = 1,
        default_batch: int = 8,
    ) -> ResourcePlan:
        """Recommend node count + batch from the most similar past runs.

        Similarity = log-scale closeness of parameter count; among similar
        runs, pick the configuration with the best goodput-weighted
        throughput per node (the reference's job-resource optimizer
        objective: utilization, not raw speed).
        """
        def distance(r: JobRecord) -> float:
            return abs(
                math.log10(max(r.model_params, 1))
                - math.log10(max(model_params, 1))
            )

        # Only genuinely comparable runs may drive the plan: within one
        # order of magnitude in parameter count.  A toy run must not size a
        # billion-parameter job.
        candidates = [
            r for r in self._records
            if r.completed and r.tokens_per_sec > 0 and distance(r) <= 1.0
        ]
        if not candidates:
            return ResourcePlan(
                num_nodes=max_nodes,
                global_batch_size=default_batch,
                reason="no comparable history; defaulting to max_nodes",
                confidence=0.0,
            )
        similar = sorted(candidates, key=distance)[:8]

        def score(r: JobRecord) -> float:
            per_node = r.tokens_per_sec / max(r.num_nodes, 1)
            return per_node * max(r.goodput, 0.5)

        best = max(similar, key=score)
        nodes = max(min_nodes, min(max_nodes, best.num_nodes))
        return ResourcePlan(
            num_nodes=nodes,
            global_batch_size=best.global_batch_size or default_batch,
            reason=(
                f"best of {len(similar)} similar runs: "
                f"{best.job_name} ({best.tokens_per_sec:.0f} tok/s on "
                f"{best.num_nodes} nodes, goodput {best.goodput:.2f})"
            ),
            confidence=min(1.0, len(similar) / 4.0),
        )


@dataclasses.dataclass
class Observation:
    """One live sample of the running job (ref ``job_auto_scaler.py``'s
    periodic stats gather)."""

    num_nodes: int
    speed: float          # steps/sec (or any monotone throughput measure)
    goodput: float = 1.0
    timestamp: float = 0.0


class RunningJobOptimizer:
    """Observation-driven scaling recommendations for the RUNNING job.

    Capability ref:
    ``dlrover/python/master/node/job_auto_scaler.py:161-252``
    (``_periodic_optimize_running_resource``) +
    ``master/resource/local_optimizer.py:66-397``: derive resource plans
    from the observed throughput history on a timer, no operator input.

    Policy (slice-granular, node_unit-aligned):

    * **explore up** — while the ceiling is untested, try one unit more;
      sync SPMD throughput should scale near-linearly over ICI, and the
      observation at the larger world either confirms (keep) or refutes
      (come back down) the step.
    * **retreat** — if the larger world's measured total throughput is NOT
      at least ``uplift_threshold`` better than the best smaller world,
      the extra unit is wasted resource: recommend the smaller world.
    * **degraded** — if the current world's recent speed has fallen below
      ``degrade_threshold`` x its own historical best for ``patience``
      consecutive observations, recommend the best historical
      configuration (which may equal the current size — the caller then
      treats it as a world-health problem, not a sizing problem).

    Pure function of the observation history: fully unit-testable with
    synthetic speeds, no cluster required.
    """

    HISTORY = 64

    def __init__(
        self,
        uplift_threshold: float = 1.1,
        degrade_threshold: float = 0.7,
        patience: int = 3,
        stale_after_s: float = 3600.0,
    ):
        self.uplift_threshold = uplift_threshold
        self.degrade_threshold = degrade_threshold
        self.patience = patience
        # Re-exploration bound: a size whose newest
        # sample is older than this is eligible for exploration again —
        # one bad reading taken during a degraded window must not lock a
        # size out forever (observe() only records at the CURRENT size,
        # so stale history never refreshes on its own).  The reference
        # re-optimizes on a timer regardless
        # (ref ``job_auto_scaler.py:161-252``).
        self.stale_after_s = stale_after_s
        self._obs: Dict[int, List[Observation]] = {}
        self._degraded_ticks = 0

    def observe(self, obs: Observation):
        if obs.speed <= 0:
            return  # warmup/restart gaps carry no sizing signal
        obs.timestamp = obs.timestamp or time.time()
        hist = self._obs.setdefault(obs.num_nodes, [])
        hist.append(obs)
        del hist[: -self.HISTORY]
        # Degradation is tracked per OBSERVATION (not per recommend() call,
        # which runs on a much slower cadence): consecutive readings below
        # threshold x the best seen at this size.
        best = self._best_speed(obs.num_nodes)
        if best > 0 and obs.speed < self.degrade_threshold * best:
            self._degraded_ticks += 1
        else:
            self._degraded_ticks = 0

    def _best_speed(self, num_nodes: int) -> float:
        hist = self._obs.get(num_nodes, [])
        return max((o.speed for o in hist), default=0.0)

    def _size_is_stale(self, num_nodes: int) -> bool:
        """No sample at this size newer than ``stale_after_s``."""
        hist = self._obs.get(num_nodes, [])
        newest = max((o.timestamp for o in hist), default=0.0)
        return time.time() - newest > self.stale_after_s

    def _recent_speed(self, num_nodes: int, k: int = 3) -> float:
        hist = self._obs.get(num_nodes, [])
        recent = hist[-k:]
        return sum(o.speed for o in recent) / len(recent) if recent else 0.0

    def recommend(
        self,
        current_nodes: int,
        min_nodes: int,
        max_nodes: int,
        node_unit: int = 1,
    ) -> ResourcePlan:
        """Target world size from the observation history alone."""
        unit = max(1, node_unit)
        cur_best = self._best_speed(current_nodes)
        cur_recent = self._recent_speed(current_nodes)

        # Degradation watch (counter maintained in observe()).
        if self._degraded_ticks >= self.patience:
            sized = {
                n: self._best_speed(n)
                for n in self._obs if min_nodes <= n <= max_nodes
            }
            if sized:
                ticks = self._degraded_ticks
                # One plan per sustained episode: continued degradation
                # re-accumulates the counter from fresh observations.
                self._degraded_ticks = 0
                best_n = max(sized, key=lambda n: sized[n])
                return ResourcePlan(
                    num_nodes=best_n,
                    global_batch_size=0,
                    reason=(
                        f"degraded: recent {cur_recent:.2f} < "
                        f"{self.degrade_threshold} x best {cur_best:.2f} at "
                        f"{current_nodes} nodes for {ticks} obs"
                    ),
                    confidence=0.9,
                )
            # No in-range history to recommend from: fall through to the
            # sizing rules instead of crashing on an empty argmax.

        larger = current_nodes + unit
        smaller = current_nodes - unit
        # Retreat: the step up did not pay for itself.  Gated on having at
        # least `patience` samples at the current size — the first readings
        # after an explore step are contaminated by the re-form/restore
        # warmup, and an ungated retreat would permanently lock the job
        # out of the larger world (explore never revisits a tested size).
        if smaller >= min_nodes and self._best_speed(smaller) > 0 and (
            len(self._obs.get(current_nodes, [])) >= self.patience
        ) and (
            cur_best < self.uplift_threshold * self._best_speed(smaller)
        ):
            return ResourcePlan(
                num_nodes=smaller,
                global_batch_size=0,
                reason=(
                    f"{current_nodes} nodes give {cur_best:.2f} <= "
                    f"{self.uplift_threshold} x {self._best_speed(smaller):.2f} "
                    f"at {smaller}: extra unit is wasted"
                ),
                confidence=0.8,
            )
        # Explore: the next size up is untested — or every sample there
        # has gone stale (e.g. measured once during a degraded window).
        if larger <= max_nodes and len(self._obs.get(current_nodes, [])) >= (
            self.patience
        ) and (self._best_speed(larger) == 0 or self._size_is_stale(larger)):
            why = (
                "untested" if self._best_speed(larger) == 0
                else f"stale > {self.stale_after_s:.0f}s"
            )
            return ResourcePlan(
                num_nodes=larger,
                global_batch_size=0,
                reason=f"exploring {larger} nodes ({why}, ceiling "
                       f"{max_nodes})",
                confidence=0.5,
            )
        return ResourcePlan(
            num_nodes=current_nodes,
            global_batch_size=0,
            reason="current size is the best known configuration",
            confidence=0.6,
        )


def record_job(
    brain: BrainService,
    job_name: str,
    speed_monitor,
    num_nodes: int,
    model_params: int = 0,
    global_batch_size: int = 0,
    completed: bool = True,
):
    """Convenience hook for the master's shutdown path."""
    brain.persist_metrics(
        JobRecord(
            job_name=job_name,
            model_params=model_params,
            num_nodes=num_nodes,
            global_batch_size=global_batch_size,
            tokens_per_sec=speed_monitor.token_throughput(),
            goodput=speed_monitor.goodput(),
            completed=completed,
        )
    )

"""Numeric health: loss-spike / NaN / gradient-norm anomaly detection
(port of ``dlrover_tpu/trainer/numeric_health.py``, whole).

Capability ref: ``atorch/atorch/utils/loss_spike_utils.py`` (TokenLossSpike:
rolling loss statistics, spike save/inspect) and
``atorch/atorch/utils/numberic_checker.py`` (NaN/Inf and magnitude checks on
module outputs/grads).

The step returns scalar ``loss`` and ``grad_norm`` (train_lib metrics),
and those two series carry the trainable signal: NaN/Inf poisoning, loss spikes relative
to the rolling window, exploding gradients.  The trainer runs this monitor
on every reported step and ships anomalies to the master with the step
report, where the ``NumericAnomalyOperator`` (master/diagnosis.py) turns
them into remediation (a NaN'd world restarts onto the last good
checkpoint) — closing the loop the reference leaves to manual inspection.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional


@dataclasses.dataclass
class Anomaly:
    kind: str      # "nan" | "loss_spike" | "grad_explosion"
    step: int
    detail: str

    def encode(self) -> str:
        return f"{self.kind}@{self.step}:{self.detail}"


class NumericHealthMonitor:
    """Rolling-window anomaly detector over (loss, grad_norm) series.

    * **nan** — loss or grad_norm is NaN/Inf: always an anomaly.
    * **loss_spike** — loss exceeds ``mean + spike_sigma * std`` of the
      window AND ``spike_ratio x`` the window mean (the sigma test alone
      misfires on converged, near-zero-variance losses).
    * **grad_explosion** — grad_norm exceeds ``grad_ratio x`` the window
      median.

    Warmup: no spike/explosion verdicts until ``min_samples`` healthy
    observations exist — early-training loss is legitimately wild.
    """

    def __init__(
        self,
        window: int = 64,
        min_samples: int = 8,
        spike_sigma: float = 4.0,
        spike_ratio: float = 1.5,
        grad_ratio: float = 10.0,
    ):
        self.window = window
        self.min_samples = min_samples
        self.spike_sigma = spike_sigma
        self.spike_ratio = spike_ratio
        self.grad_ratio = grad_ratio
        self._losses: Deque[float] = deque(maxlen=window)
        self._grad_norms: Deque[float] = deque(maxlen=window)
        self.anomalies: List[Anomaly] = []

    def check(self, step: int, loss: float,
              grad_norm: Optional[float] = None) -> List[Anomaly]:
        """Feed one step's scalars; returns anomalies found at this step."""
        found: List[Anomaly] = []
        if not math.isfinite(loss) or (
            grad_norm is not None and not math.isfinite(grad_norm)
        ):
            found.append(Anomaly(
                "nan", step,
                f"loss={loss} grad_norm={grad_norm}",
            ))
            # Poisoned values must not enter the rolling statistics.
            self.anomalies.extend(found)
            return found

        n = len(self._losses)
        if n >= self.min_samples:
            mean = sum(self._losses) / n
            var = sum((x - mean) ** 2 for x in self._losses) / n
            std = math.sqrt(var)
            if loss > mean + self.spike_sigma * std and (
                loss > self.spike_ratio * mean
            ):
                found.append(Anomaly(
                    "loss_spike", step,
                    f"loss={loss:.4g} vs window mean={mean:.4g} "
                    f"std={std:.4g}",
                ))
        if grad_norm is not None and len(self._grad_norms) >= (
            self.min_samples
        ):
            ordered = sorted(self._grad_norms)
            median = ordered[len(ordered) // 2]
            if median > 0 and grad_norm > self.grad_ratio * median:
                found.append(Anomaly(
                    "grad_explosion", step,
                    f"grad_norm={grad_norm:.4g} vs window "
                    f"median={median:.4g}",
                ))
        # Spiky readings stay OUT of the window: a genuine divergence would
        # otherwise drag the statistics up and mask its own continuation.
        if not found:
            self._losses.append(loss)
            if grad_norm is not None:
                self._grad_norms.append(grad_norm)
        self.anomalies.extend(found)
        return found

"""Online calibration ledger: measured/modeled correction factors (port
of ``dlrover_tpu/master/calibration.py``).

Every ``"calibration"`` wire event a profiled trainer ships (one per
capture window, ``utils/device_profile.emit_measured_phases``) carries per
phase *kind* (compute/collective) the measured device seconds next to the
modeled seconds the cost model apportioned for the same step.  This ledger
folds those pairs into per-cache-key EWMA ratios — ``measured / modeled``
per kind.  The master's servicer routes the events here, its timeline
renders the ratios as gauges and its state store persists
:meth:`CalibrationLedger.state`; ``auto/tune.py``, which reads them to
correct its ranking in the reference, is ROADMAP Queue 1 item 10c.

A ratio of 1.0 means the model priced that kind perfectly; >1 the model is
optimistic (reality slower), <1 pessimistic.  Keys are the step program's
compile-cache key, so a resize (different fold, different key) never
pollutes another program's correction.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

#: EWMA smoothing: new observation weight.  High enough to follow a real
#: shift within a few capture windows, low enough that one noisy window
#: (e.g. a capture overlapping a checkpoint) does not whipsaw the tuner.
EWMA_ALPHA = 0.3

#: The two phase kinds the measured/modeled pairing compares
#: (utils/device_profile.PHASE_KINDS values).
PHASE_KINDS = ("compute", "collective")


class CalibrationLedger:
    """Thread-safe per-cache-key EWMA of measured/modeled phase ratios."""

    def __init__(self, alpha: float = EWMA_ALPHA):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        # cache_key -> phase kind -> EWMA ratio.
        self._ratios: Dict[str, Dict[str, float]] = {}
        # cache_key -> phase kind -> observation count (diagnostic +
        # lets the first observation seed the EWMA instead of decaying
        # toward an arbitrary prior).
        self._counts: Dict[str, Dict[str, int]] = {}
        # cache_key -> {"fraction": EWMA overlap fraction, "count": n}.
        # Separate from _ratios: overlap is a [0,1] fraction of measured
        # collective seconds hidden under compute, not a measured/modeled
        # ratio.
        self._overlap: Dict[str, Dict[str, float]] = {}

    def observe(
        self, cache_key: str, phase: str, measured: float, modeled: float
    ):
        """Fold one measured/modeled pair in.  Pairs where either side is
        non-positive carry no signal (phase absent from the window or from
        the plan) and are skipped."""
        if measured <= 0.0 or modeled <= 0.0:
            return
        key = cache_key or "uncacheable"
        ratio = measured / modeled
        with self._lock:
            per_key = self._ratios.setdefault(key, {})
            counts = self._counts.setdefault(key, {})
            if phase in per_key:
                per_key[phase] += self.alpha * (ratio - per_key[phase])
            else:
                per_key[phase] = ratio
            counts[phase] = counts.get(phase, 0) + 1

    def observe_overlap(self, cache_key: str, fraction: float):
        """Fold one *measured* collective-overlap fraction in (the share
        of device collective seconds that ran concurrently with compute,
        ``utils/device_profile.DeviceWindow.overlap_fraction``).  Values
        outside [0, 1] carry no signal and are skipped."""
        if not 0.0 <= fraction <= 1.0:
            return
        key = cache_key or "uncacheable"
        with self._lock:
            per_key = self._overlap.setdefault(key, {})
            if "fraction" in per_key:
                per_key["fraction"] += self.alpha * (
                    fraction - per_key["fraction"]
                )
            else:
                per_key["fraction"] = fraction
            per_key["count"] = per_key.get("count", 0.0) + 1.0

    def overlap(self, cache_key: Optional[str] = None) -> float:
        """Measured collective-overlap fraction EWMA.

        With ``cache_key``: that program's fraction (0.0 when never
        observed).  Without: the mean over all observed keys — what
        ``auto/tune.est_comm_time`` uses as the learned hidden share and
        the ``dlrover_overlap_fraction`` gauge renders."""
        with self._lock:
            if cache_key is not None:
                per_key = self._overlap.get(cache_key or "uncacheable", {})
                return float(per_key.get("fraction", 0.0))
            fracs = [
                v["fraction"] for v in self._overlap.values()
                if "fraction" in v
            ]
            return sum(fracs) / len(fracs) if fracs else 0.0

    def ratios(self, cache_key: Optional[str] = None) -> Dict[str, float]:
        """Per-phase-kind correction factors.

        With ``cache_key``: that program's ratios (empty dict when never
        observed).  Without: the mean over all observed keys — the
        aggregate the gauges render and the tuner falls back to when it
        prices a candidate whose key was never profiled."""
        with self._lock:
            if cache_key is not None:
                return dict(self._ratios.get(cache_key or "uncacheable", {}))
            out: Dict[str, float] = {}
            for per_key in self._ratios.values():
                for phase, ratio in per_key.items():
                    out[phase] = out.get(phase, 0.0) + ratio
            n = len(self._ratios)
            return {p: v / n for p, v in out.items()} if n else {}

    def observations(self, cache_key: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts.get(cache_key or "uncacheable", {}))

    def __len__(self) -> int:
        with self._lock:
            return len(set(self._ratios) | set(self._overlap))

    # -- state snapshot ------------------------------------------------------

    def state(self) -> Dict:
        """JSON-able snapshot for the master state store."""
        with self._lock:
            return {
                "alpha": self.alpha,
                "ratios": {k: dict(v) for k, v in self._ratios.items()},
                "counts": {k: dict(v) for k, v in self._counts.items()},
                "overlap": {k: dict(v) for k, v in self._overlap.items()},
            }

    def restore(self, state: Dict):
        if not state:
            return
        with self._lock:
            self.alpha = float(state.get("alpha", self.alpha))
            self._ratios = {
                str(k): {str(p): float(r) for p, r in v.items()}
                for k, v in state.get("ratios", {}).items()
            }
            self._counts = {
                str(k): {str(p): int(c) for p, c in v.items()}
                for k, v in state.get("counts", {}).items()
            }
            self._overlap = {
                str(k): {str(p): float(r) for p, r in v.items()}
                for k, v in state.get("overlap", {}).items()
            }

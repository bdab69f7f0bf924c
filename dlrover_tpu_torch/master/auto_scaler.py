"""The serving plane's replica policy (port of ``ServeScalePolicy`` of
``dlrover_tpu/master/auto_scaler.py``).

``serving/fleet.ReplicaFleet.maybe_scale`` evaluates it over the fleet's
own statistics.  The rest of the reference file, ``JobAutoScaler`` and
its scale plans, drives the master's node manager and waits for the
control plane (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses


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

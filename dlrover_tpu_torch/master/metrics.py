"""Master-side metrics store: node resource time series + job aggregates
(port of ``dlrover_tpu/master/metrics.py``).

Capability ref: ``dlrover/python/master/stats/job_collector.py`` +
``stats/reporter.py`` (JobMetricCollector with a local reporter; the Brain/
MySQL tier is out of scope — the seam is the collector interface).  This is
the auto-scaler's and diagnosis subsystem's data source.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


class MetricsCollector:
    """Bounded per-node time series of reported resource stats."""

    WINDOW = 120  # samples per node (~1h at 30s cadence)

    def __init__(self):
        self._lock = threading.Lock()
        # node_id -> deque[(ts, cpu%, mem_gb, device_mem_gb, device_util,
        #                   device_mem_max_gb, device_util_max)]
        self._series: Dict[int, Deque[Tuple[float, ...]]] = {}

    def collect(
        self,
        node_id: int,
        cpu_percent: float,
        mem_gb: float,
        device_mem_gb: float = 0.0,
        device_util: float = 0.0,
        timestamp: Optional[float] = None,
        device_mem_max_gb: float = 0.0,
        device_util_max: float = 0.0,
    ):
        ts = timestamp or time.time()
        with self._lock:
            series = self._series.setdefault(
                node_id, deque(maxlen=self.WINDOW)
            )
            series.append((
                ts, cpu_percent, mem_gb, device_mem_gb, device_util,
                device_mem_max_gb, device_util_max,
            ))

    def evict(self, node_id: int):
        """Drop a removed node's series (scale-down, migration-out):
        a departed host must stop feeding ``mean_cpu`` and showing up in
        ``stale_nodes`` forever as "stopped reporting"."""
        with self._lock:
            self._series.pop(node_id, None)

    def latest(self, node_id: int) -> Optional[Dict[str, float]]:
        with self._lock:
            series = self._series.get(node_id)
            if not series:
                return None
            sample = series[-1]
            # Old snapshots may carry 5-tuples (pre per-device-max);
            # pad so restores across versions keep working.
            ts, cpu, mem, dmem, dutil = sample[:5]
            dmem_max = sample[5] if len(sample) > 5 else 0.0
            dutil_max = sample[6] if len(sample) > 6 else 0.0
            return {
                "timestamp": ts,
                "cpu_percent": cpu,
                "mem_gb": mem,
                "device_mem_gb": dmem,
                "device_util": dutil,
                "device_mem_max_gb": dmem_max,
                "device_util_max": dutil_max,
            }

    def nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._series)

    def mean_cpu(self, window_s: float = 300.0) -> float:
        """Mean cpu%% across nodes over the recent window (scaler input)."""
        cutoff = time.time() - window_s
        values = []
        with self._lock:
            for series in self._series.values():
                values.extend(c for ts, c, *_ in series if ts >= cutoff)
        return sum(values) / len(values) if values else 0.0

    def stale_nodes(self, max_age_s: float) -> List[int]:
        """Nodes whose newest sample is older than ``max_age_s``."""
        now = time.time()
        out = []
        with self._lock:
            for node_id, series in self._series.items():
                if series and now - series[-1][0] > max_age_s:
                    out.append(node_id)
        return sorted(out)

"""Agent-side resource monitor: host cpu/mem + trainer-reported device
memory (port of ``dlrover_tpu/agent/monitor.py``).

Capability ref: ``dlrover/python/elastic_agent/monitor/resource.py:86-180``
(``ResourceMonitor`` sampling cpu/mem/gpu and reporting to the master) and
``monitor/training.py`` (metrics handed over through a file the trainer
writes: only the trainer process can read its own CUDA allocator, so the
same file seam carries its device numbers out).  ``client`` is the
agent's ``agent/master_client.MasterClient`` (duck-typed:
``report_resource``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger


def read_cpu_times() -> Tuple[float, float]:
    """(busy_jiffies, total_jiffies) from /proc/stat."""
    with open("/proc/stat") as f:
        fields = f.readline().split()[1:]
    values = [float(v) for v in fields]
    idle = values[3] + (values[4] if len(values) > 4 else 0.0)
    total = sum(values)
    return total - idle, total


def read_mem_gb() -> float:
    """Used host memory (total - available) in GiB."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            info[key] = float(rest.split()[0])  # kB
    used_kb = info.get("MemTotal", 0.0) - info.get("MemAvailable", 0.0)
    return used_kb / 2**20


def write_device_metrics(path: Optional[str] = None) -> Optional[Dict]:
    """Trainer-side half: dump the local cards' allocator stats for the
    agent.

    Call periodically from the training loop (cheap).  Per card this
    process has allocated on (``utils.memory_profile.card_memory_stats``):
    the allocated bytes, current and peak, against the card's memory;
    with no card in use every number is 0.  Returns the stats dict, or
    None when no metrics file is configured and no path given.
    """
    from dlrover_tpu_torch.common.constants import ConfigKey
    from dlrover_tpu_torch.utils.memory_profile import card_memory_stats

    path = path or os.environ.get(ConfigKey.METRICS_FILE)
    if not path:
        return None
    cards = card_memory_stats()
    bytes_used = sum(c["in_use"] for c in cards)
    peak = sum(c["peak"] for c in cards)
    limit = sum(c["limit"] for c in cards)
    # Per-card maxima: a single hot card (sharding skew, a leaked buffer
    # on one card) hides inside the host-wide sums.
    max_used = max((c["in_use"] for c in cards), default=0)
    max_util = max((c["in_use"] / c["limit"] for c in cards if c["limit"]),
                   default=0.0)
    payload = {
        "device_mem_gb": bytes_used / 2**30,
        "device_peak_gb": peak / 2**30,
        "device_util": (bytes_used / limit) if limit else 0.0,
        "device_mem_max_gb": max_used / 2**30,
        "device_util_max": max_util,
        "timestamp": time.time(),
    }
    tmp = path + ".tmp"
    try:
        # Seam: the metrics handoff file is a real storage write; a fired
        # fault exercises the degraded path (agent sees stale/no data).
        faults.fire("storage.write", path=os.path.basename(path))
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except (OSError, faults.FaultInjected) as e:
        logger.debug("device metrics write failed: %s", e)
    return payload


class ResourceMonitor:
    """Samples host + device telemetry and reports it to the master."""

    def __init__(self, client, interval: float = 30.0,
                 metrics_file: Optional[str] = None, recorder=None,
                 on_preemption=None):
        self._client = client
        self._interval = interval
        self._metrics_file = metrics_file
        # Optional agent telemetry recorder: shipped on the resource
        # cadence as a backstop for the heartbeat drain.
        self._recorder = recorder
        # Preemption watch: real deployments point DLROVER_TPU_PREEMPT_FILE
        # at the platform's maintenance-notice path (GCE metadata poller /
        # node-problem-detector drop file); chaos runs script the notice by
        # firing the ``preempt.notice`` seam.  Latched: one callback total.
        self._on_preemption = on_preemption
        self._preempt_file = os.environ.get("DLROVER_TPU_PREEMPT_FILE", "")
        self._preempted = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_cpu: Optional[Tuple[float, float]] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="resource-monitor", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def sample(self) -> Dict[str, float]:
        busy, total = read_cpu_times()
        cpu_percent = 0.0
        if self._last_cpu is not None:
            dbusy = busy - self._last_cpu[0]
            dtotal = total - self._last_cpu[1]
            if dtotal > 0:
                cpu_percent = 100.0 * dbusy / dtotal
        self._last_cpu = (busy, total)
        out = {"cpu_percent": cpu_percent, "mem_gb": read_mem_gb(),
               "device_mem_gb": 0.0, "device_util": 0.0,
               "device_mem_max_gb": 0.0, "device_util_max": 0.0}
        if self._metrics_file and os.path.exists(self._metrics_file):
            try:
                faults.fire(
                    "storage.read",
                    path=os.path.basename(self._metrics_file),
                )
                with open(self._metrics_file) as f:
                    device = json.load(f)
                out["device_mem_gb"] = float(device.get("device_mem_gb", 0.0))
                out["device_util"] = float(device.get("device_util", 0.0))
                out["device_mem_max_gb"] = float(
                    device.get("device_mem_max_gb", 0.0)
                )
                out["device_util_max"] = float(
                    device.get("device_util_max", 0.0)
                )
            except (OSError, ValueError, faults.FaultInjected):
                pass
        return out

    def check_preemption(self) -> bool:
        """One preemption probe; latches and fires the callback on the
        first detection.  Returns True iff this host has been warned.

        A fired ``preempt.notice`` error fault IS the scripted warning —
        that's how a Faultline plan preempts a specific host at a specific
        hit without any platform integration.
        """
        if self._preempted:
            return True
        if self._on_preemption is None:
            return False
        reason = ""
        try:
            faults.fire("preempt.notice")
        except faults.FaultInjected as f:
            reason = f"faultline:{f.seam}@{f.hit}"
        if not reason and self._preempt_file and os.path.exists(
            self._preempt_file
        ):
            try:
                with open(self._preempt_file) as f:
                    reason = f.read().strip() or "preempt-file"
            except OSError:
                reason = "preempt-file"
        if not reason:
            return False
        self._preempted = True
        logger.warning("preemption notice detected: %s", reason)
        try:
            self._on_preemption(reason)
        except Exception as e:  # noqa: BLE001 - watch must not kill agent
            logger.warning("preemption callback failed: %s", e)
        return True

    def _run(self):
        self.sample()  # prime the cpu delta
        # Tick fast enough that a preemption warning is seen within ~1s of
        # its grace window opening, while resource reports keep their
        # (much coarser) cadence.
        tick = min(self._interval, 1.0)
        next_report = time.monotonic() + self._interval
        while not self._stop.wait(tick):
            self.check_preemption()
            if time.monotonic() < next_report:
                continue
            next_report = time.monotonic() + self._interval
            try:
                s = self.sample()
                self._client.report_resource(
                    s["cpu_percent"], s["mem_gb"],
                    s["device_mem_gb"], s["device_util"],
                    device_mem_max_gb=s["device_mem_max_gb"],
                    device_util_max=s["device_util_max"],
                )
                if self._recorder is not None:
                    self._recorder.ship(self._client)
            except ConnectionError:
                logger.warning("resource report: master unreachable")
            except Exception as e:  # noqa: BLE001 - telemetry must not kill
                logger.warning("resource monitor error: %s", e)

"""Master-side job timeline: merged per-node telemetry + metrics
exposition (port of ``dlrover_tpu/master/timeline.py``).

The second tier of the observability plane.  Each node's trainer/agent
drains its :mod:`dlrover_tpu_torch.common.telemetry` ring into ``TelemetryEvents``
reports; the servicer feeds them here.  The timeline keeps a bounded
per-node event history keyed by ``(node_id, span)``, and on top of the
merge answers the three questions the control plane needs:

* **What was the job doing at second T?** — ``to_chrome_trace()`` renders
  the whole run (steps, compiles, checkpoints, rendezvous gaps, restarts)
  as a Perfetto/Chrome trace with one track per node
  (``tools/job_timeline.py`` dumps it).
* **How healthy is it right now?** — ``render_metrics()`` is a
  Prometheus-style text exposition: goodput, per-node step-time p50/p95,
  restart counts, compile seconds, numeric anomalies — served through the
  servicer's ``MetricsRequest`` seam.
* **Which node makes it slow?** — per-step cross-node skew attribution
  (``slowest_per_step`` histogram + ``step_stats``) feeding the
  ``StragglerOperator`` in ``master/diagnosis.py``.
"""

from __future__ import annotations

import threading
from collections import Counter, deque
from typing import Any, Deque, Dict, List, Optional, Sequence

from dlrover_tpu_torch.common.telemetry import WireEvent, events_to_chrome_trace


def _quantile(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted sequence."""
    if not sorted_values:
        return 0.0
    index = min(len(sorted_values) - 1, int(q * len(sorted_values)))
    return sorted_values[index]


class JobTimeline:
    """Merged, bounded, thread-safe per-node event streams."""

    # Events retained per node; at ~3 events/step this is hours of history
    # for the exposition while keeping a 1000-node master's footprint flat.
    EVENTS_PER_NODE = 8192
    # Per-step durations retained for skew attribution.
    STEP_WINDOW = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._events: Dict[int, Deque[WireEvent]] = {}
        # step -> {node_id: duration_s} for "step" spans (skew attribution).
        self._step_durations: Dict[int, Dict[int, float]] = {}
        self._step_order: Deque[int] = deque()
        # Lifecycle counters folded out of agent event streams.
        self._restart_counts: Counter = Counter()
        # Free-form master-side counters (telemetry drops, perf
        # regressions): bump() feeds them, render_metrics exposes them.
        self._counters: Counter = Counter()

    # -- ingestion ------------------------------------------------------------

    def add_events(self, node_id: int, events: Sequence[WireEvent]):
        """Ingest one node's drained telemetry batch (the wire format)."""
        with self._lock:
            ring = self._events.setdefault(
                int(node_id), deque(maxlen=self.EVENTS_PER_NODE)
            )
            for raw in events:
                try:
                    name, kind, t_wall, duration_s, attrs = raw
                except (TypeError, ValueError):
                    continue  # one malformed event must not drop the batch
                attrs = attrs if isinstance(attrs, dict) else {}
                ring.append(
                    (str(name), str(kind), float(t_wall),
                     float(duration_s), attrs)
                )
                if name == "step" and "step" in attrs:
                    self._note_step_locked(
                        int(node_id), int(attrs["step"]), float(duration_s)
                    )
                elif name == "restart":
                    self._restart_counts[int(node_id)] += 1

    def record(self, node_id: int, name: str, kind: str = "event",
               t_wall: float = 0.0, duration_s: float = 0.0,
               attrs: Optional[Dict[str, Any]] = None):
        """Master-local convenience for single events (tests, master's own
        lifecycle annotations)."""
        self.add_events(
            node_id, [(name, kind, t_wall, duration_s, attrs or {})]
        )

    def _note_step_locked(self, node_id: int, step: int, duration_s: float):
        if step not in self._step_durations:
            self._step_durations[step] = {}
            self._step_order.append(step)
            while len(self._step_order) > self.STEP_WINDOW:
                self._step_durations.pop(self._step_order.popleft(), None)
        self._step_durations[step][node_id] = duration_s

    def evict_node(self, node_id: int):
        """Drop a departed node's streams so replaced/retired hosts stop
        polluting skew stats and the exposition (paired with
        ``MetricsCollector.evict``)."""
        with self._lock:
            self._events.pop(node_id, None)
            self._restart_counts.pop(node_id, None)
            for per_node in self._step_durations.values():
                per_node.pop(node_id, None)

    def bump(self, name: str, n: int = 1):
        """Increment a master-side counter (rendered as
        ``dlrover_<name>_total``)."""
        if n <= 0:
            return
        with self._lock:
            self._counters[name] += int(n)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # -- queries --------------------------------------------------------------

    def nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._events)

    def events(self, node_id: Optional[int] = None) -> Dict[int, List[WireEvent]]:
        """Snapshot of the merged streams (all nodes, or one)."""
        with self._lock:
            if node_id is not None:
                return {node_id: list(self._events.get(node_id, ()))}
            return {n: list(ring) for n, ring in self._events.items()}

    def spans(self, node_id: int, name: str) -> List[WireEvent]:
        with self._lock:
            return [
                e for e in self._events.get(node_id, ())
                if e[0] == name and e[1] == "span"
            ]

    def restart_count(self, node_id: int) -> int:
        with self._lock:
            return self._restart_counts.get(node_id, 0)

    # -- skew attribution -----------------------------------------------------

    def step_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-node step-duration stats over the window:
        {node: {count, p50, p95, mean}}."""
        with self._lock:
            per_node: Dict[int, List[float]] = {}
            for durations in self._step_durations.values():
                for node_id, duration in durations.items():
                    per_node.setdefault(node_id, []).append(duration)
        out = {}
        for node_id, values in per_node.items():
            values.sort()
            out[node_id] = {
                "count": float(len(values)),
                "p50": _quantile(values, 0.50),
                "p95": _quantile(values, 0.95),
                "mean": sum(values) / len(values),
            }
        return out

    def slowest_per_step(self) -> Counter:
        """Histogram: node -> number of (multi-node) steps it was the
        slowest participant of.  A flat histogram is a healthy world; one
        node owning it is the straggler signature."""
        slowest: Counter = Counter()
        with self._lock:
            for durations in self._step_durations.values():
                if len(durations) < 2:
                    continue
                slowest[max(durations, key=durations.get)] += 1
        return slowest

    def step_skew(self, ratio: float) -> Dict[int, int]:
        """node -> count of steps where its duration exceeded ``ratio`` x
        the per-step median (the StragglerOperator's evidence)."""
        out: Counter = Counter()
        with self._lock:
            step_maps = [dict(d) for d in self._step_durations.values()]
        for durations in step_maps:
            if len(durations) < 2:
                continue
            values = sorted(durations.values())
            median = values[len(values) // 2]
            if median <= 0:
                continue
            for node_id, duration in durations.items():
                if duration > ratio * median:
                    out[node_id] += 1
        return dict(out)

    def step_time_series(self, last_n: int = 0) -> List[tuple]:
        """Ordered ``(step, duration_s)`` pairs over the attribution
        window.  The job-level duration of a step is the MAX across its
        reporting nodes — the job moves at its slowest participant's pace
        (the StepRegressionOperator's drift input)."""
        with self._lock:
            series = [
                (step, max(self._step_durations[step].values()))
                for step in self._step_order
                if self._step_durations.get(step)
            ]
        return series[-last_n:] if last_n > 0 else series

    def steps_observed(self) -> int:
        """Multi-node steps inside the attribution window."""
        with self._lock:
            return sum(
                1 for d in self._step_durations.values() if len(d) >= 2
            )

    # -- exports --------------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        return events_to_chrome_trace(self.events())

    def render_metrics(
        self,
        speed_monitor=None,
        node_manager=None,
        calibration=None,
        memory=None,
        metrics=None,
    ) -> str:
        """Prometheus text exposition of the merged job state.

        Serves the master's own ledgers (goodput, speed, compile ledger,
        numeric anomalies — the previously write-only ``SpeedMonitor``
        state) alongside the timeline-derived per-node series.  Metric
        names are documented in PROFILE.md "Job timeline".
        """
        lines: List[str] = []

        def gauge(name: str, value: float, help_text: str = "",
                  labels: str = ""):
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{labels} {value:.6g}")

        if speed_monitor is not None:
            gauge("dlrover_goodput", speed_monitor.goodput(),
                  "productive_time / wall_time since job start (0..1)")
            gauge("dlrover_global_step", speed_monitor.global_step,
                  "newest committed global step")
            gauge("dlrover_running_speed_steps_per_s",
                  speed_monitor.running_speed(),
                  "steps/s over the sample window")
            gauge("dlrover_token_throughput_per_s",
                  speed_monitor.token_throughput(),
                  "tokens/s over the sample window")
            ledger = speed_monitor.compile_ledger()
            gauge("dlrover_compile_seconds_total", ledger["compile_s"],
                  "trainer-reported compile wall seconds")
            gauge("dlrover_restart_compile_seconds_total",
                  ledger["restart_compile_s"],
                  "compile seconds paid on restarts (cache misses)")
            gauge("dlrover_compile_events_total", ledger["compile_events"],
                  "compile events trainers reported (cache hits included)")
            gauge("dlrover_cached_compiles_total", ledger["cached_compiles"],
                  "compile events served from the persistent cache")
            fault_ledger = speed_monitor.fault_ledger()
            gauge("dlrover_injected_faults_total",
                  fault_ledger["fault_events"],
                  "Faultline-injected faults reported via telemetry")
            gauge("dlrover_injected_fault_seconds_total",
                  fault_ledger["fault_lost_s"],
                  "wall seconds lost to injected delay faults")
            resize = speed_monitor.resize_ledger()
            gauge("dlrover_resizes_total", resize["resizes"],
                  "elastic resize events (preemption drains / scale plans)")
            gauge("dlrover_resize_seconds_total",
                  resize["resize_s_total"] + resize["resize_open_s"],
                  "wall seconds between a resize notice and the next "
                  "step advance (open window included)")
            # Per-kind split: "restore" = the classic rebuild-recompile-
            # restore cycle (seconds), "relayout" = virtual-mesh live
            # re-layout (milliseconds).  The open window's seconds count
            # under its own kind so the labeled series always sum to the
            # unlabeled total above (the parity the telemetry test pins).
            by_kind = dict(resize.get("by_kind", {}))
            if resize["resize_open_s"]:
                open_kind = resize.get("open_kind") or "restore"
                by_kind[open_kind] = (
                    by_kind.get(open_kind, 0.0) + resize["resize_open_s"]
                )
            for kind in ("restore", "relayout"):
                gauge("dlrover_resize_seconds_total",
                      by_kind.get(kind, 0.0),
                      labels=f'{{kind="{kind}"}}')
            serve = speed_monitor.serve_ledger()
            gauge("dlrover_serve_qps", serve["qps"],
                  "completed serving requests/s, summed over replicas")
            lines.append(
                "# HELP dlrover_serve_latency_seconds request latency "
                "quantiles (worst replica)"
            )
            lines.append("# TYPE dlrover_serve_latency_seconds gauge")
            gauge("dlrover_serve_latency_seconds", serve["p50_s"],
                  labels='{quantile="0.5"}')
            gauge("dlrover_serve_latency_seconds", serve["p95_s"],
                  labels='{quantile="0.95"}')
            gauge("dlrover_serve_slot_occupancy", serve["occupancy"],
                  "mean fraction of KV-cache slots live (0..1)")
            gauge("dlrover_serve_spec_accept_rate",
                  serve.get("spec_accept_rate", 0.0),
                  "speculative-decode acceptance: draft tokens the "
                  "target verified, over tokens proposed (greedy rows)")
            gauge("dlrover_serve_decode_step_p95_seconds",
                  serve.get("decode_step_p95_s", 0.0),
                  "p95 wall seconds of decode-advancing engine steps "
                  "(worst replica) - prefill interference shows up here")
            gauge("dlrover_serve_requests_total", serve["requests"],
                  "serving requests completed, summed over replicas")
            gauge("dlrover_serve_tokens_total", serve["tokens"],
                  "tokens generated by serving, summed over replicas")
            gauge("dlrover_serve_replicas", serve["replicas"],
                  "serving replicas that have reported stats")
            gauge("dlrover_serve_swaps_total", serve["swaps"],
                  "live weight hot-swap attempts reported fleet-wide")
            gauge("dlrover_serve_swap_rollbacks_total",
                  serve["swap_rollbacks"],
                  "hot-swaps rolled back on a digest mismatch")
            gauge("dlrover_serve_weights_version", serve["weights_version"],
                  "newest weights version any replica is serving")
            embed = speed_monitor.embed_ledger()
            gauge("dlrover_embed_rows_owned", embed["rows_owned"],
                  "embedding rows resident across the plane's owner hosts")
            gauge("dlrover_embed_rows_owned_max", embed["rows_owned_max"],
                  "rows on the fullest owner host (fold skew)")
            gauge("dlrover_embed_cache_hit_rate", embed["hit_rate"],
                  "device hot-row cache hit rate (0..1, mean of reporters)")
            gauge("dlrover_embed_lookups_total", embed["lookups"],
                  "sharded embedding lookups performed")
            gauge("dlrover_embed_rows_fetched_total", embed["rows_fetched"],
                  "unique rows exchanged with owner hosts on lookups")
            gauge("dlrover_embed_reshards_total", embed["reshards"],
                  "elastic bucket-map re-folds performed")
            gauge("dlrover_embed_reshard_seconds_total", embed["reshard_s"],
                  "wall seconds spent moving rows between owners")
            gauge("dlrover_embed_moved_rows_total", embed["moved_rows"],
                  "rows that changed owner across all reshards")
            gauge("dlrover_embed_spill_bytes", embed["spill_bytes"],
                  "cold rows spilled to host-disk tiers, in bytes")
            gauge("dlrover_embed_rows_per_s", embed["rows_per_s"],
                  "embedding rows served/s (newest reported snapshot)")
            moe = speed_monitor.moe_ledger()
            gauge("dlrover_moe_gate_entropy", moe["entropy"],
                  "mean per-token router entropy in nats (mean of "
                  "reporters; ln(E) = uniform routing, 0 = collapsed)")
            gauge("dlrover_moe_capacity_drop_fraction",
                  moe["drop_fraction"],
                  "fraction of token-choices dropped at expert capacity "
                  "(0 on the dropless grouped path)")
            gauge("dlrover_moe_experts", moe["experts"],
                  "expert count of the reported MoE model")
            gauge("dlrover_moe_top_k", moe["top_k"],
                  "router choices per token (top-k)")
            gauge("dlrover_moe_reporters", moe["reporters"],
                  "trainers that have reported router-health snapshots")
            lines.append(
                "# HELP dlrover_moe_expert_load fraction of kept "
                "token-choices routed to each expert (mean of reporters; "
                "1/E = perfectly balanced)"
            )
            lines.append("# TYPE dlrover_moe_expert_load gauge")
            if moe["load"]:
                for i, frac in enumerate(moe["load"]):
                    gauge("dlrover_moe_expert_load", frac,
                          labels=f'{{expert="{i}"}}')
            else:
                gauge("dlrover_moe_expert_load", 0)
            sdc = speed_monitor.sdc_ledger()
            gauge("dlrover_sdc_checks_total", sdc["checks"],
                  "cross-replica state-digest votes performed")
            gauge("dlrover_sdc_mismatch_total", sdc["mismatches"],
                  "digest votes with a minority (SDC suspect) replica")
            gauge("dlrover_sdc_quarantines_total", sdc["quarantines"],
                  "nodes quarantined by the SDC vote operator")
            anomalies = speed_monitor.recent_anomalies()
            kinds: Counter = Counter(
                encoded.split("@", 1)[0] for _, _, encoded in anomalies
            )
            lines.append(
                "# HELP dlrover_numeric_anomalies_recent anomaly reports "
                "inside the 600s window, by kind"
            )
            lines.append("# TYPE dlrover_numeric_anomalies_recent gauge")
            if kinds:
                for kind, count in sorted(kinds.items()):
                    gauge("dlrover_numeric_anomalies_recent", count,
                          labels=f'{{kind="{kind}"}}')
            else:
                gauge("dlrover_numeric_anomalies_recent", 0)

        if calibration is not None and len(calibration):
            lines.append(
                "# HELP dlrover_calibration_ratio measured/modeled device "
                "seconds per phase kind (EWMA over capture windows; 1.0 = "
                "the cost model priced it perfectly)"
            )
            lines.append("# TYPE dlrover_calibration_ratio gauge")
            for phase, ratio in sorted(calibration.ratios().items()):
                gauge("dlrover_calibration_ratio", ratio,
                      labels=f'{{phase="{phase}"}}')
            gauge("dlrover_overlap_fraction", calibration.overlap(),
                  "measured share of device collective seconds hidden "
                  "under compute (EWMA over capture windows)")
        with self._lock:
            dropped = self._counters.get("telemetry_dropped", 0)
            regressions = self._counters.get("perf_regressions", 0)
            retries = self._counters.get("retries", 0)
            circuit_opens = self._counters.get("circuit_opens", 0)
            replica_deaths = self._counters.get("replica_deaths", 0)
            worker_exits = self._counters.get("worker_exits", 0)
            worker_starts = self._counters.get("worker_starts", 0)
        gauge("dlrover_telemetry_dropped_total", dropped,
              "events the node telemetry rings overwrote before a drain")
        gauge("dlrover_perf_regressions_total", regressions,
              "step-time regressions flagged by the diagnosis sentinel")
        gauge("dlrover_retries_total", retries,
              "RetryPolicy attempts that failed and were retried")
        gauge("dlrover_circuit_opens_total", circuit_opens,
              "circuit-breaker trips (failure threshold reached)")
        gauge("dlrover_replica_deaths_total", replica_deaths,
              "serving replicas killed or declared dead by the fleet")
        gauge("dlrover_worker_exits_total", worker_exits,
              "training worker process exits the agent observed")
        gauge("dlrover_worker_starts_total", worker_starts,
              "training worker process launches the agent performed")
        stats = self.step_stats()
        if stats:
            lines.append(
                "# HELP dlrover_step_time_seconds per-node step span "
                "duration quantiles over the attribution window"
            )
            lines.append("# TYPE dlrover_step_time_seconds gauge")
            for node_id in sorted(stats):
                for q in ("p50", "p95"):
                    gauge(
                        "dlrover_step_time_seconds", stats[node_id][q],
                        labels=(
                            f'{{node="{node_id}",quantile='
                            f'"0.{q[1:]}"}}'
                        ),
                    )
        slowest = self.slowest_per_step()
        if slowest:
            lines.append(
                "# HELP dlrover_slowest_steps_total multi-node steps this "
                "node was the slowest participant of"
            )
            lines.append("# TYPE dlrover_slowest_steps_total gauge")
            for node_id in sorted(slowest):
                gauge("dlrover_slowest_steps_total", slowest[node_id],
                      labels=f'{{node="{node_id}"}}')
        with self._lock:
            restart_counts = dict(self._restart_counts)
        if restart_counts or node_manager is not None:
            lines.append(
                "# HELP dlrover_restart_events_total trainer restarts "
                "observed in the node's agent stream"
            )
            lines.append("# TYPE dlrover_restart_events_total gauge")
            for node_id in sorted(restart_counts):
                gauge("dlrover_restart_events_total",
                      restart_counts[node_id],
                      labels=f'{{node="{node_id}"}}')
        if node_manager is not None:
            lines.append(
                "# HELP dlrover_node_relaunch_count relaunches consumed "
                "from the node's budget"
            )
            lines.append("# TYPE dlrover_node_relaunch_count gauge")
            for node_id, state in sorted(node_manager.snapshot().items()):
                gauge("dlrover_node_relaunch_count",
                      state["relaunch_count"],
                      labels=f'{{node="{node_id}"}}')
        if memory is not None and len(memory):
            hbm = memory.ledger()
            gauge("dlrover_hbm_nodes", hbm["nodes"],
                  "nodes with a live classified HBM snapshot")
            gauge("dlrover_hbm_bytes_in_use", hbm["bytes_in_use"],
                  "allocator bytes_in_use summed over reporting nodes "
                  "(live-buffer nbytes fallback where the backend has "
                  "no allocator stats)")
            gauge("dlrover_hbm_peak_bytes", hbm["peak_bytes"],
                  "worst single-node peak allocator bytes")
            gauge("dlrover_hbm_limit_bytes", hbm["limit_bytes"],
                  "allocator bytes_limit summed over reporting nodes "
                  "(0 = backend does not price a limit)")
            gauge("dlrover_hbm_headroom_frac", hbm["headroom_frac"],
                  "tightest node's 1 - bytes_in_use/limit "
                  "(-1 = no node can price headroom)")
            lines.append(
                "# HELP dlrover_hbm_pool_bytes per-device bytes by "
                "classified pool, summed over reporting nodes"
            )
            lines.append("# TYPE dlrover_hbm_pool_bytes gauge")
            from dlrover_tpu_torch.utils.memory_profile import POOLS
            for pool in POOLS:
                gauge("dlrover_hbm_pool_bytes", hbm[f"pool_{pool}_b"],
                      labels=f'{{pool="{pool}"}}')
        if metrics is not None and metrics.nodes():
            lines.append(
                "# HELP dlrover_host_device_mem_gb host-wide device "
                "memory in use, summed over the node's local devices"
            )
            lines.append("# TYPE dlrover_host_device_mem_gb gauge")
            lines.append(
                "# HELP dlrover_host_device_mem_max_gb hottest single "
                "device's memory on the node (skew the sum hides)"
            )
            lines.append("# TYPE dlrover_host_device_mem_max_gb gauge")
            lines.append(
                "# HELP dlrover_host_device_util_max hottest single "
                "device's utilization on the node (0..1)"
            )
            lines.append("# TYPE dlrover_host_device_util_max gauge")
            for node_id in metrics.nodes():
                sample = metrics.latest(node_id)
                if not sample:
                    continue
                gauge("dlrover_host_device_mem_gb",
                      sample["device_mem_gb"],
                      labels=f'{{node="{node_id}"}}')
                gauge("dlrover_host_device_mem_max_gb",
                      sample["device_mem_max_gb"],
                      labels=f'{{node="{node_id}"}}')
                gauge("dlrover_host_device_util_max",
                      sample["device_util_max"],
                      labels=f'{{node="{node_id}"}}')
        return "\n".join(lines) + "\n"

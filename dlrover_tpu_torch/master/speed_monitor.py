"""Throughput tracking + goodput accounting (port of
``dlrover_tpu/master/speed_monitor.py``).

Capability ref: ``dlrover/python/master/monitor/speed_monitor.py:43-186``
(``collect_global_step``, ``running_speed``).  Extended with the goodput
ledger the north-star metric needs: wall-clock is classified into productive
(steps advancing) vs lost (init/restart/hang) time.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple


class SpeedMonitor:
    SAMPLE_WINDOW = 20

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Deque[Tuple[float, int, int]] = deque(
            maxlen=self.SAMPLE_WINDOW
        )  # (ts, global_step, tokens_cum)
        self._global_step = 0
        self._tokens_cum = 0
        self._start_time = time.time()
        # When the hang clock last restarted: the job's start, then each
        # reset of the running speed (a restart's downtime is measured
        # from the restart, not from the job's start).
        self._stalled_since = self._start_time
        self._productive_s = 0.0
        self._last_step_time: Optional[float] = None
        self._first_step_time: Optional[float] = None
        # (ts, step, encoded) numeric anomalies from trainers.
        self._anomalies: Deque[Tuple[float, int, str]] = deque(maxlen=256)
        # Compile-time ledger: first-start compiles are the price of
        # admission; RESTART compiles are pure goodput loss the persistent
        # compilation cache exists to erase — booked separately so the
        # ledger shows the cache working (restart_compile_s → 0).
        self._compile_s = 0.0
        self._restart_compile_s = 0.0
        self._compile_events = 0
        self._restart_compiles = 0
        self._cached_compiles = 0
        # Faultline ledger: injected-fault telemetry events, so chaos-run
        # goodput attributes lost time to the fault plan instead of
        # counting it as unexplained downtime.
        self._fault_events = 0
        self._fault_lost_s = 0.0
        self._faults_by_seam: Dict[str, int] = {}
        # Resize ledger: wall time between a resize notice (preemption
        # drain, scale plan) and the re-formed world's first step advance.
        # The paper's promise is that this stays seconds — the
        # ``dlrover_resize_seconds_total`` gauge makes it measurable.
        # Seconds split by KIND: "restore" (rebuild-recompile-restore
        # cycle, seconds-scale) vs "relayout" (virtual-mesh live
        # re-layout, milliseconds-scale) — the 10×+ gap between the two
        # is the headline the live-relayout drill certifies.
        self._resizes = 0
        self._resize_s_total = 0.0
        self._resize_started: Optional[float] = None
        self._resize_kind = "restore"  # kind of the open window, if any
        self._resizes_by_reason: Dict[str, int] = {}
        self._resize_s_by_kind: Dict[str, float] = {}
        # SDC digest ledger (trainer/state_digest.py DigestReports): votes
        # are per-step {node: digest} maps; a step is voted once, when a
        # NEWER step's report proves every replica that will ever report it
        # has (the watermark).  Persistent minority == the corrupting node.
        self._digest_votes: Dict[int, Dict[int, str]] = {}
        self._sdc_checks = 0
        self._sdc_mismatches = 0
        self._sdc_quarantines = 0
        self._sdc_streaks: Dict[int, int] = {}
        self._sdc_last_mismatch_step = -1
        self._sdc_check_every = 0
        # Per-node digest watermark: newest step each reporter has voted.
        self._sdc_latest: Dict[int, int] = {}
        # Recent (step, loss) samples from StepReports: the SDC drill's
        # post-restore parity check compares the recovered trajectory's
        # tail against an uninjected reference run.
        self._recent_losses: Deque[Tuple[int, float]] = deque(maxlen=512)
        # Serving ledger: latest snapshot per serving replica from its
        # "serve" telemetry events (QPS, latency quantiles, slot
        # occupancy) — the auto-scaler's replica policy and the
        # ``dlrover_serve_*`` gauges read the aggregate.
        self._serve_stats: Dict[int, Dict[str, float]] = {}
        self._serve_events = 0
        # Live weight hot-swap ledger ("serve.swap" telemetry events):
        # newest weights version seen fleet-wide, swap count, and how many
        # were rolled back on a digest mismatch.
        self._swaps = 0
        self._swap_rollbacks = 0
        self._swap_s_total = 0.0
        self._weights_version = 0
        # "embed" telemetry events: each reporter's newest plane-global
        # snapshot (rows owned, fold clocks, cache hit rate) — the
        # ``dlrover_embed_*`` gauges read the aggregate.
        self._embed_stats: Dict[int, Dict[str, float]] = {}
        self._embed_events = 0
        # "moe" telemetry events: each reporter's newest router-health
        # snapshot (gate entropy, capacity-drop fraction, per-expert
        # load) — the ``dlrover_moe_*`` gauges read the aggregate.
        self._moe_stats: Dict[int, Dict[str, Any]] = {}
        self._moe_events = 0

    def collect_global_step(
        self, step: int, timestamp: Optional[float] = None, tokens: int = 0
    ):
        ts = timestamp or time.time()
        with self._lock:
            if step <= self._global_step:
                return
            if self._resize_started is not None:
                # First step advance after a resize notice closes the
                # window: everything in between was resize downtime.
                elapsed = max(0.0, ts - self._resize_started)
                self._resize_s_total += elapsed
                self._resize_s_by_kind[self._resize_kind] = (
                    self._resize_s_by_kind.get(self._resize_kind, 0.0)
                    + elapsed
                )
                self._resize_started = None
            if self._last_step_time is not None:
                # Time between consecutive step reports counts as productive
                # as long as steps keep advancing.
                self._productive_s += ts - self._last_step_time
            elif self._first_step_time is None:
                # Only the job's FIRST step starts the training phase —
                # post-restart reports must not move it (goodput basis).
                self._first_step_time = ts
            self._last_step_time = ts
            self._global_step = step
            self._tokens_cum += tokens
            self._samples.append((ts, step, self._tokens_cum))

    def record_loss(self, step: int, loss: float):
        """Retain a trainer-reported loss sample (newest-wins per step)."""
        with self._lock:
            self._recent_losses.append((step, float(loss)))

    def recent_losses(self, last_n: int = 0) -> List[Tuple[int, float]]:
        """[(step, loss)] oldest first; the tail ``last_n`` if requested."""
        with self._lock:
            out = list(self._recent_losses)
        return out[-last_n:] if last_n else out

    def record_anomaly(self, step: int, encoded: str):
        """Numeric anomaly reported by a trainer (kind@step:detail); feeds
        the NumericAnomalyOperator in the diagnosis chain."""
        with self._lock:
            self._anomalies.append((time.time(), step, encoded))

    def recent_anomalies(self, window_s: float = 600.0):
        """[(ts, step, encoded)] within the window, oldest first."""
        cutoff = time.time() - window_s
        with self._lock:
            return [a for a in self._anomalies if a[0] >= cutoff]

    def record_compile(
        self, seconds: float, restart: bool = False, cached: bool = False
    ):
        """A trainer's (re)compile wall time, from its "compile" event."""
        with self._lock:
            self._compile_events += 1
            self._compile_s += seconds
            if restart:
                self._restart_compiles += 1
                self._restart_compile_s += seconds
            if cached:
                self._cached_compiles += 1

    def record_fault(self, seam: str, kind: str = "", lost_s: float = 0.0):
        """One injected fault (from a node's ``fault`` telemetry event).

        ``lost_s`` is the scripted delay for delay-kind faults; error-kind
        faults book 0 here (their cost shows up as retries/restarts, which
        the goodput ledger already accounts).
        """
        with self._lock:
            self._fault_events += 1
            self._fault_lost_s += max(0.0, lost_s)
            key = f"{seam}:{kind}" if kind else seam
            self._faults_by_seam[key] = self._faults_by_seam.get(key, 0) + 1

    def record_serve(
        self,
        node_id: int = 0,
        *,
        qps: float = 0.0,
        p50_s: float = 0.0,
        p95_s: float = 0.0,
        occupancy: float = 0.0,
        slots: float = 0.0,
        requests: float = 0.0,
        tokens: float = 0.0,
        p95_n: float = 1e9,
        spec_accept_rate: float = 0.0,
        spec_proposed: float = 0.0,
        spec_accepted: float = 0.0,
        decode_step_p95_s: float = 0.0,
        **_ignored,
    ):
        """A serving replica's stats snapshot (its ``serve`` telemetry
        event).  Newest-wins per replica; unknown attrs are ignored so
        engines can grow the event without breaking older masters.
        ``p95_n`` defaults to effectively-infinite so snapshots from
        engines that predate quantile confidence stay actionable."""
        with self._lock:
            self._serve_events += 1
            self._serve_stats[node_id] = {
                "qps": float(qps), "p50_s": float(p50_s),
                "p95_s": float(p95_s), "occupancy": float(occupancy),
                "slots": float(slots), "requests": float(requests),
                "tokens": float(tokens), "p95_n": float(p95_n),
                "spec_accept_rate": float(spec_accept_rate),
                "spec_proposed": float(spec_proposed),
                "spec_accepted": float(spec_accepted),
                "decode_step_p95_s": float(decode_step_p95_s),
            }

    def evict_serve(self, node_id: int):
        """Drop a retired replica's stats snapshot so a drained/killed
        replica stops counting toward ``dlrover_serve_replicas`` and the
        fleet's latency/QPS aggregates (paired with
        ``JobTimeline.evict_node`` at the fleet's retire hook)."""
        with self._lock:
            self._serve_stats.pop(node_id, None)

    def record_swap(
        self,
        node_id: int = 0,
        *,
        version: int = 0,
        ok: bool = False,
        rolled_back: bool = False,
        seconds: float = 0.0,
        **_ignored,
    ):
        """One live weight hot-swap attempt (a ``serve.swap`` telemetry
        event).  ``version`` is the replica's post-swap weights version —
        the ledger keeps the fleet-wide max, so the gauge answers "what
        weights is the fleet on" without a per-replica query."""
        with self._lock:
            self._swaps += 1
            if rolled_back or not ok:
                self._swap_rollbacks += 1
            self._swap_s_total += max(0.0, float(seconds))
            self._weights_version = max(self._weights_version, int(version))

    def record_embed(
        self,
        node_id: int = 0,
        *,
        world: float = 0.0,
        rows_owned: float = 0.0,
        rows_owned_max: float = 0.0,
        lookups: float = 0.0,
        rows_fetched: float = 0.0,
        reshards: float = 0.0,
        reshard_s: float = 0.0,
        moved_rows: float = 0.0,
        spill_bytes: float = 0.0,
        hit_rate: float = 0.0,
        rows_per_s: float = 0.0,
        **_ignored,
    ):
        """An embedding plane's stats snapshot (its ``embed`` telemetry
        event).  Newest-wins per reporting node; unknown attrs are ignored
        so the plane can grow the event without breaking older masters."""
        with self._lock:
            self._embed_events += 1
            self._embed_stats[node_id] = {
                "world": float(world),
                "rows_owned": float(rows_owned),
                "rows_owned_max": float(rows_owned_max),
                "lookups": float(lookups),
                "rows_fetched": float(rows_fetched),
                "reshards": float(reshards),
                "reshard_s": float(reshard_s),
                "moved_rows": float(moved_rows),
                "spill_bytes": float(spill_bytes),
                "hit_rate": float(hit_rate),
                "rows_per_s": float(rows_per_s),
            }

    def record_moe(
        self,
        node_id: int = 0,
        *,
        step: float = 0.0,
        entropy: float = 0.0,
        drop_fraction: float = 0.0,
        experts: float = 0.0,
        top_k: float = 0.0,
        load: Any = "[]",
        **_ignored,
    ):
        """A trainer's router-health snapshot (its ``moe`` telemetry
        event).  Newest-wins per reporting node; ``load`` arrives as a
        JSON array string of per-expert load fractions (wire attrs stay
        scalar-ish); unknown attrs are ignored so the trainer can grow
        the event without breaking older masters."""
        if isinstance(load, str):
            import json

            load = json.loads(load)
        with self._lock:
            self._moe_events += 1
            self._moe_stats[node_id] = {
                "step": float(step),
                "entropy": float(entropy),
                "drop_fraction": float(drop_fraction),
                "experts": float(experts),
                "top_k": float(top_k),
                "load": [float(v) for v in load],
            }

    def moe_ledger(self) -> Dict[str, Any]:
        """Router-health aggregate: entropy/drop average across reporters
        (each books its own replica's gate view), expert geometry takes
        the max, and per-expert load averages elementwise across the
        reporters that carry the full-width vector."""
        with self._lock:
            stats = list(self._moe_stats.values())
            n = len(stats)
            experts = max((s["experts"] for s in stats), default=0.0)
            loads = [
                s["load"] for s in stats
                if len(s["load"]) == int(experts) and experts
            ]
            load = [
                sum(vec[i] for vec in loads) / len(loads)
                for i in range(int(experts))
            ] if loads else []
            return {
                "moe_events": float(self._moe_events),
                "reporters": float(n),
                "step": max((s["step"] for s in stats), default=0.0),
                "entropy": (
                    sum(s["entropy"] for s in stats) / n if n else 0.0
                ),
                "drop_fraction": (
                    sum(s["drop_fraction"] for s in stats) / n if n else 0.0
                ),
                "experts": experts,
                "top_k": max((s["top_k"] for s in stats), default=0.0),
                "load": load,
            }

    def embed_ledger(self) -> Dict[str, float]:
        """Embedding-plane aggregate.  Every reporter books the same
        plane-GLOBAL snapshot (``ShardedEmbeddingTable.stats`` already sums
        over owner hosts), so counters take the max across reporters —
        summing would double-count a plane several agents report — and the
        cache hit rate averages (it is the only per-reporter field)."""
        with self._lock:
            stats = list(self._embed_stats.values())
            n = len(stats)

            def top(key: str) -> float:
                return max((s[key] for s in stats), default=0.0)

            return {
                "embed_events": float(self._embed_events),
                "reporters": float(n),
                "world": top("world"),
                "rows_owned": top("rows_owned"),
                "rows_owned_max": top("rows_owned_max"),
                "lookups": top("lookups"),
                "rows_fetched": top("rows_fetched"),
                "reshards": top("reshards"),
                "reshard_s": top("reshard_s"),
                "moved_rows": top("moved_rows"),
                "spill_bytes": top("spill_bytes"),
                "hit_rate": (
                    sum(s["hit_rate"] for s in stats) / n if n else 0.0
                ),
                "rows_per_s": top("rows_per_s"),
            }

    def serve_ledger(self) -> Dict[str, float]:
        """Fleet aggregate: QPS/requests/tokens/slots sum across replicas,
        latency quantiles take the WORST replica (an SLO is breached when
        any replica breaches it), occupancy averages."""
        with self._lock:
            stats = list(self._serve_stats.values())
            n = len(stats)
            worst = max(
                stats, key=lambda s: s["p95_s"], default=None
            )
            spec_prop = sum(
                s.get("spec_proposed", 0.0) for s in stats
            )
            spec_acc = sum(
                s.get("spec_accepted", 0.0) for s in stats
            )
            return {
                "serve_events": float(self._serve_events),
                "replicas": float(n),
                "qps": sum(s["qps"] for s in stats),
                "p50_s": max((s["p50_s"] for s in stats), default=0.0),
                "p95_s": max((s["p95_s"] for s in stats), default=0.0),
                # Sample count behind the worst replica's p95 — what the
                # scale policy's min_samples confidence gate reads.
                "p95_n": (
                    worst.get("p95_n", 1e9) if worst is not None else 0.0
                ),
                "decode_step_p95_s": max(
                    (s.get("decode_step_p95_s", 0.0) for s in stats),
                    default=0.0,
                ),
                "occupancy": (
                    sum(s["occupancy"] for s in stats) / n if n else 0.0
                ),
                "slots": sum(s["slots"] for s in stats),
                "requests": sum(s["requests"] for s in stats),
                "tokens": sum(s["tokens"] for s in stats),
                "spec_proposed": spec_prop,
                "spec_accepted": spec_acc,
                "spec_accept_rate": (
                    spec_acc / spec_prop if spec_prop else 0.0
                ),
                "swaps": float(self._swaps),
                "swap_rollbacks": float(self._swap_rollbacks),
                "swap_s_total": self._swap_s_total,
                "weights_version": float(self._weights_version),
            }

    # -- snapshot surfaces (master/state_store.py capture/restore) ------------
    #
    # The serve and resize ledgers are counters a Prometheus scraper rates
    # over time — a master restart zeroing them reads as a counter reset
    # mid-incident.  These two pairs round-trip exactly the fields the
    # ``dlrover_serve_*`` / ``dlrover_resize_*`` gauges render.

    def serve_state(self) -> Dict[str, object]:
        with self._lock:
            return {
                "stats": {k: dict(v) for k, v in self._serve_stats.items()},
                "events": self._serve_events,
                "swaps": self._swaps,
                "swap_rollbacks": self._swap_rollbacks,
                "swap_s_total": self._swap_s_total,
                "weights_version": self._weights_version,
            }

    def restore_serve_state(self, state: Dict[str, object]):
        with self._lock:
            for k, v in dict(state.get("stats", {})).items():
                self._serve_stats[int(k)] = dict(v)
            self._serve_events = int(state.get("events", 0))
            self._swaps = int(state.get("swaps", 0))
            self._swap_rollbacks = int(state.get("swap_rollbacks", 0))
            self._swap_s_total = float(state.get("swap_s_total", 0.0))
            self._weights_version = max(
                self._weights_version, int(state.get("weights_version", 0))
            )

    def embed_state(self) -> Dict[str, object]:
        with self._lock:
            return {
                "stats": {k: dict(v) for k, v in self._embed_stats.items()},
                "events": self._embed_events,
            }

    def restore_embed_state(self, state: Dict[str, object]):
        with self._lock:
            for k, v in dict(state.get("stats", {})).items():
                self._embed_stats[int(k)] = dict(v)
            self._embed_events = int(state.get("events", 0))

    def resize_state(self) -> Dict[str, object]:
        with self._lock:
            return {
                "resizes": self._resizes,
                "resize_s_total": self._resize_s_total,
                "by_reason": dict(self._resizes_by_reason),
                "by_kind": dict(self._resize_s_by_kind),
            }

    def restore_resize_state(self, state: Dict[str, object]):
        """An open resize window is deliberately NOT restored: the master
        that died mid-window cannot know when (or if) the world re-formed,
        so the conservative read is to drop the open window and keep only
        the closed totals."""
        with self._lock:
            self._resizes = int(state.get("resizes", 0))
            self._resize_s_total = float(state.get("resize_s_total", 0.0))
            for k, v in dict(state.get("by_reason", {})).items():
                self._resizes_by_reason[str(k)] = int(v)
            for k, v in dict(state.get("by_kind", {})).items():
                self._resize_s_by_kind[str(k)] = float(v)

    def fault_ledger(self) -> Dict[str, object]:
        with self._lock:
            return {
                "fault_events": self._fault_events,
                "fault_lost_s": self._fault_lost_s,
                "by_seam": dict(self._faults_by_seam),
            }

    def record_digest(
        self, node_id: int, step: int, digest: str, check_every: int = 0
    ):
        """One replica's post-update state digest for ``step``.

        Votes finalize behind a *per-node* watermark: a pending step is
        voted only once every known reporter has delivered a digest for a
        later step (replicas run minutes apart across restarts; a global
        watermark would finalize a fast node's steps before the slow
        nodes' votes arrive and drop them as single-report steps).  The
        watermark is an assignment, not a max — a post-restore rewind
        legitimately moves a replica's stream backward, and its re-voted
        steps overwrite the pre-restart digests by node key.  A reporter
        that vanishes without being quarantined would stall the pipeline,
        so steps more than four check intervals behind the fastest
        reporter force-finalize with whatever votes arrived; finalized
        steps with fewer than two votes carry no cross-replica
        information and are dropped silently.
        """
        with self._lock:
            if check_every:
                self._sdc_check_every = check_every
            self._digest_votes.setdefault(step, {})[node_id] = digest
            self._sdc_latest[node_id] = step
            low = min(self._sdc_latest.values())
            high = max(self._sdc_latest.values())
            horizon = max(low, high - 4 * max(self._sdc_check_every, 1))
            for pending in sorted(self._digest_votes):
                if pending >= horizon:
                    break
                self._vote_locked(pending, self._digest_votes.pop(pending))

    def _vote_locked(self, step: int, votes: Dict[int, str]):
        if len(votes) < 2:
            return
        self._sdc_checks += 1
        tally: Dict[str, int] = {}
        for digest in votes.values():
            tally[digest] = tally.get(digest, 0) + 1
        majority = max(tally, key=lambda d: (tally[d], d))
        outliers = [n for n, d in votes.items() if d != majority]
        if outliers and tally[majority] > len(outliers):
            self._sdc_mismatches += 1
            self._sdc_last_mismatch_step = step
            for node in votes:
                if node in outliers:
                    self._sdc_streaks[node] = (
                        self._sdc_streaks.get(node, 0) + 1
                    )
                else:
                    self._sdc_streaks.pop(node, None)
        else:
            # Unanimous (or a tie with no majority to trust): every
            # reporter's streak resets — corruption must be persistent.
            for node in votes:
                self._sdc_streaks.pop(node, None)

    def record_sdc_quarantine(self, node_id: int = -1):
        """A QUARANTINE action executed; the node's streak is consumed and
        its pending votes dropped (the world restarts without it)."""
        with self._lock:
            self._sdc_quarantines += 1
            self._sdc_streaks.pop(node_id, None)
            # Drop it from the watermark too, or the dead node's frozen
            # latest-step would gate every future vote.
            self._sdc_latest.pop(node_id, None)
            for votes in self._digest_votes.values():
                votes.pop(node_id, None)

    def sdc_ledger(self) -> Dict[str, object]:
        with self._lock:
            return {
                "checks": self._sdc_checks,
                "mismatches": self._sdc_mismatches,
                "quarantines": self._sdc_quarantines,
                "streaks": dict(self._sdc_streaks),
                "last_mismatch_step": self._sdc_last_mismatch_step,
                "check_every": self._sdc_check_every,
            }

    def begin_resize(self, reason: str = "", kind: str = "restore"):
        """A resize (preemption drain / scale event) started.  The window
        stays open until the next step advance; overlapping notices (every
        preempted host reports) fold into one window.  ``kind`` tags the
        window's seconds in the per-kind split ("restore" for the classic
        rebuild cycle; a live re-layout instead books itself in one shot
        via :meth:`record_relayout`, since the trainer already measured
        its own milliseconds)."""
        with self._lock:
            if self._resize_started is None:
                self._resize_started = time.time()
                self._resize_kind = kind or "restore"
            self._resizes += 1
            if reason:
                self._resizes_by_reason[reason] = (
                    self._resizes_by_reason.get(reason, 0) + 1
                )

    def record_relayout(
        self, seconds: float, ok: bool = True, reason: str = ""
    ):
        """One virtual-mesh live re-layout, trainer-measured.

        Unlike :meth:`begin_resize` there is no open window: the trainer
        performed (and timed) the whole resize itself, so the seconds land
        directly.  ``ok=False`` is the retry-exhausted degrade — the
        trainer fell back to checkpoint restore, so the event books under
        reason ``relayout_failed`` and its seconds under kind "restore"
        (that is the cycle actually paid)."""
        kind = "relayout" if ok else "restore"
        reason = reason or ("relayout" if ok else "relayout_failed")
        with self._lock:
            self._resizes += 1
            self._resizes_by_reason[reason] = (
                self._resizes_by_reason.get(reason, 0) + 1
            )
            seconds = max(0.0, float(seconds))
            self._resize_s_total += seconds
            self._resize_s_by_kind[kind] = (
                self._resize_s_by_kind.get(kind, 0.0) + seconds
            )

    def resize_ledger(self) -> Dict[str, object]:
        with self._lock:
            open_s = (
                time.time() - self._resize_started
                if self._resize_started is not None else 0.0
            )
            return {
                "resizes": self._resizes,
                "resize_s_total": self._resize_s_total,
                "resize_open_s": open_s,
                "open_kind": (
                    self._resize_kind
                    if self._resize_started is not None else ""
                ),
                "by_reason": dict(self._resizes_by_reason),
                "by_kind": dict(self._resize_s_by_kind),
            }

    def compile_ledger(self) -> Dict[str, float]:
        with self._lock:
            return {
                "compile_s": self._compile_s,
                "restart_compile_s": self._restart_compile_s,
                "compile_events": self._compile_events,
                "restart_compiles": self._restart_compiles,
                "cached_compiles": self._cached_compiles,
            }

    def reset_running_speed(self):
        """Call on restart: the gap until the next step report is downtime."""
        with self._lock:
            self._samples.clear()
            self._last_step_time = None
            self._stalled_since = time.time()

    @property
    def global_step(self) -> int:
        return self._global_step

    def running_speed(self) -> float:
        """Steps/sec over the sample window."""
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            (t0, s0, _), (t1, s1, _) = self._samples[0], self._samples[-1]
            if t1 <= t0:
                return 0.0
            return (s1 - s0) / (t1 - t0)

    def token_throughput(self) -> float:
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            (t0, _, k0), (t1, _, k1) = self._samples[0], self._samples[-1]
            if t1 <= t0:
                return 0.0
            return (k1 - k0) / (t1 - t0)

    def goodput(self) -> float:
        """productive_time / total_time since the job began (0..1)."""
        with self._lock:
            total = time.time() - self._start_time
            if total <= 0:
                return 0.0
            return min(1.0, self._productive_s / total)

    def no_progress_for(self) -> float:
        """Seconds since the last step advance (hang detection input), or
        since the last reset of the running speed when no step advanced
        after it.  The reference counts from the job's start there, so a
        hang threshold shorter than the job's age restarts the world in
        the middle of every restart (ROADMAP Queue 3 item 18)."""
        with self._lock:
            if self._last_step_time is None:
                return time.time() - self._stalled_since
            return time.time() - self._last_step_time

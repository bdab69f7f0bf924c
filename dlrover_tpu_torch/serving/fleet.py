"""Replica fleet: registry, health, failover and drain over ServingEngines
(port of ``dlrover_tpu/serving/fleet.py``).

The survivability layer between the front door
(:mod:`dlrover_tpu_torch.serving.frontend`) and the per-replica engines: N
:class:`~dlrover_tpu_torch.serving.engine.ServingEngine` replicas (sharing one
``ServePrograms`` through the process-wide memo: a replica is a model, a
slot pool and a KV cache) behind least-loaded routing, with the failure
machinery a single engine lacks:

* **registry + health** — replicas are routable while their serve
  telemetry stays fresh; a replica whose step stamp falls
  ``STALE_AFTER_S`` behind the fleet's newest is unroutable until it ticks again.
* **per-replica CircuitBreaker** (``common/retry.py``) — a replica that
  keeps failing its step trips open and stops receiving requests; one
  half-open probe readmits it after the reset window.
* **death + in-flight resubmission** — the ``replica.death`` Faultline
  seam fires on every replica's step probe; a fired error IS the scripted
  crash (so is any exception a step raises once the replica's breaker
  opens: a caller that must not hide a kernel failure holds ``deaths`` to
  the deaths it planted and ``step_failures`` to 0).  The fleet
  requeues every request the dead replica had not finished (queued *and*
  mid-decode, tracked by request id) onto survivors: zero lost.  Greedy
  requests reproduce identical tokens; a sampled request re-decodes under
  a survivor's RNG stream — the contract is completion, not bitwise
  replay.
* **drain before retire** — scale-in (``ServeScalePolicy`` via
  :meth:`maybe_scale`) moves a victim's queue to survivors, lets its live
  slots finish, and only then retires it; requests never die with a
  planned shrink.
* **disaggregated prefill transport** — replicas carry their engine's
  ``role``; prompts route only to prefill-capable replicas, and every
  fleet tick streams finished :class:`~dlrover_tpu_torch.serving.engine.
  PrefilledPage` s from prefill outboxes to the least-loaded
  decode-capable replica (re-assigning ownership, so failover debts
  follow the page).  A page with no live decode target simply waits in
  its outbox — the next tick retries.  A page the target refuses (a
  speculating decode replica holds a page from a replica without a draft
  to its own γ headroom) stays in its outbox too, and the tick raises.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common import faults, telemetry
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.retry import CircuitBreaker
from dlrover_tpu_torch.serving.engine import (
    Request,
    RequestResult,
    ServingEngine,
)


#: A replica whose step stamp falls this far behind the fleet's newest is
#: unroutable until it steps again.
STALE_AFTER_S = 5.0
#: Step failures in a row that open a replica's breaker, and the seconds
#: before its one half-open probe.
BREAKER_THRESHOLD = 3
BREAKER_RESET_S = 10.0
#: The fleet never drains itself below this many replicas.
MIN_REPLICAS = 1


class NoReplicaError(RuntimeError):
    """No routable replica (all dead, tripped or stale)."""


class _Replica:
    __slots__ = ("rid", "engine", "breaker", "last_seen", "draining")

    def __init__(self, rid: str, engine: ServingEngine,
                 breaker: CircuitBreaker, now: float):
        self.rid = rid
        self.engine = engine
        self.breaker = breaker
        self.last_seen = now
        self.draining = False


class ReplicaFleet:
    """Least-loaded router + failover over registered serving replicas."""

    def __init__(
        self,
        *,
        spawn: Optional[Callable[[], ServingEngine]] = None,
        spawn_prefill: Optional[Callable[[], ServingEngine]] = None,
    ):
        # Optional factories for scale-out (in-process replicas share the
        # compiled-program memo, so spawning is slot-pool cost only).
        # ``spawn`` grows the decode-capable pool; ``spawn_prefill`` grows
        # the prefill pool of a disaggregated fleet — the two pools scale
        # on independent signals (latency/occupancy vs prompt backlog).
        self.spawn = spawn
        self.spawn_prefill = spawn_prefill
        self._replicas: Dict[str, _Replica] = {}
        self._counter = 0
        # uid -> rid of the replica currently responsible for it.
        self._assigned: Dict[str, str] = {}
        # Original Request per uid, retained until completion — the
        # resubmission capital: a dead replica's unfinished ids are
        # re-dispatched from here, not reconstructed from its wreckage.
        self._requests: Dict[str, Request] = {}
        self.results: Dict[str, RequestResult] = {}
        self.cancelled: set = set()
        # Ledger the drill gates on.
        self.deaths = 0
        self.resubmitted = 0
        self.retired = 0
        self.pages_streamed = 0
        self.page_bytes_streamed = 0
        # Steps that raised (not the replica.death seam): each is a breaker
        # failure.
        self.step_failures = 0

    # -- registry -------------------------------------------------------------

    def add_replica(
        self, engine: ServingEngine, rid: Optional[str] = None
    ) -> str:
        if rid is None:
            rid = f"replica-{self._counter}"
        self._counter += 1
        self._replicas[rid] = _Replica(
            rid, engine,
            CircuitBreaker(
                failure_threshold=BREAKER_THRESHOLD,
                reset_after_s=BREAKER_RESET_S,
                name=f"serve:{rid}",
            ),
            time.monotonic(),
        )
        logger.info("fleet: replica %s registered (%d total)",
                    rid, len(self._replicas))
        return rid

    def replica_ids(self) -> List[str]:
        return sorted(self._replicas)

    def _newest_stamp(self) -> float:
        return max(
            (r.last_seen for r in self._replicas.values()), default=0.0
        )

    def routable(self, rid: str) -> bool:
        replica = self._replicas.get(rid)
        if replica is None or replica.draining:
            return False
        if not replica.breaker.allow():
            return False
        # Staleness is relative to the freshest replica, not wall time —
        # an idle fleet (nobody stepping) keeps everyone routable.
        return (
            self._newest_stamp() - replica.last_seen <= STALE_AFTER_S
        )

    # -- routing --------------------------------------------------------------

    @staticmethod
    def _load(replica: _Replica) -> int:
        engine = replica.engine
        return (
            len(engine._queue) + len(engine._live_slots())
            + len(engine._page_queue)
        )

    def submit(self, request: Request) -> str:
        """Dispatch to the least-loaded prefill-capable routable replica;
        returns its rid.  Raises :class:`NoReplicaError` when nothing is
        routable and ``ValueError`` (from the engine) for
        never-admissible requests."""
        candidates = [
            r for rid, r in sorted(self._replicas.items())
            if self.routable(rid) and r.engine.role != "decode"
        ]
        if not candidates:
            raise NoReplicaError(
                f"no routable prefill-capable replica among "
                f"{self.replica_ids()}"
            )
        replica = min(candidates, key=self._load)
        replica.engine.submit(request)
        self._assigned[request.uid] = replica.rid
        self._requests[request.uid] = request
        return replica.rid

    # -- the fleet tick -------------------------------------------------------

    def step(self) -> int:
        """One fleet tick: probe + advance every replica, harvest results.
        Returns the number of live slots decoded fleet-wide."""
        decoded = 0
        for rid in list(self._replicas):
            replica = self._replicas.get(rid)
            if replica is None:
                continue
            try:
                # The death probe: a fired error here IS the crash.
                faults.fire("replica.death", replica=rid)
                decoded += replica.engine.step()
            except faults.FaultInjected:
                self.kill(rid, reason="faultline")
                continue
            except Exception as e:  # noqa: BLE001 - an organic step crash
                logger.exception("replica %s step failed", rid)
                self.step_failures += 1
                replica.breaker.record_failure()
                if not replica.breaker.allow():
                    self.kill(rid, reason=f"step: {e}")
                continue
            replica.breaker.record_success()
            replica.last_seen = time.monotonic()
            self._harvest(replica)
        self._stream_pages()
        return decoded

    # -- disaggregated page transport -----------------------------------------

    def _decode_target(self) -> Optional[_Replica]:
        """Least-loaded routable decode-capable replica, or None."""
        candidates = [
            r for rid, r in sorted(self._replicas.items())
            if self.routable(rid) and r.engine.role != "prefill"
        ]
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda r: len(r.engine._live_slots())
            + len(r.engine._page_queue),
        )

    def _stream_pages(self) -> int:
        """Move finished pages from prefill outboxes to decode replicas.
        Ownership (``_assigned``) follows the page, so a decode-replica
        death resubmits the request from the retained original — the
        page itself is never the source of truth."""
        moved = 0
        for replica in list(self._replicas.values()):
            outbox = replica.engine.outbox
            while outbox:
                target = self._decode_target()
                if target is None:
                    break  # nothing decode-capable right now; retry later
                page = outbox[0]
                target.engine.insert_page(page)  # a refusal keeps the page
                outbox.popleft()
                self._assigned[page.request.uid] = target.rid
                self.pages_streamed += 1
                self.page_bytes_streamed += page.nbytes
                moved += 1
        return moved

    def _harvest(self, replica: _Replica):
        for uid, result in replica.engine.results.items():
            if uid not in self.results:
                self.results[uid] = result

    # -- death / failover -----------------------------------------------------

    def unfinished(self, rid: str) -> List[str]:
        """uids assigned to ``rid`` with no harvested result (queued or
        mid-decode — both are the dead replica's unpaid debt)."""
        return [
            uid for uid, assigned in self._assigned.items()
            if assigned == rid
            and uid not in self.results
            and uid not in self.cancelled
        ]

    def kill(self, rid: str, reason: str = "killed"):
        """Remove a replica NOW and resubmit its unfinished requests onto
        survivors by request id — zero lost."""
        replica = self._replicas.pop(rid, None)
        if replica is None:
            return
        # Salvage what already finished before the crash landed.
        self._harvest(replica)
        debts = self.unfinished(rid)
        self.deaths += 1
        logger.warning(
            "fleet: replica %s dead (%s); resubmitting %d in-flight "
            "request(s) onto %s",
            rid, reason, len(debts), self.replica_ids(),
        )
        requeued = 0
        for uid in debts:
            request = self._requests.get(uid)
            if request is None:
                continue
            try:
                self.submit(request)
                requeued += 1
            except NoReplicaError:
                # Last replica died: keep the debt booked; the uid stays
                # unfinished and a later add_replica can pick it up via
                # resubmit_orphans().
                logger.error(
                    "fleet: request %s orphaned (no survivors)", uid
                )
        self.resubmitted += requeued
        telemetry.event(
            "replica.death", replica=rid, reason=reason,
            resubmitted=requeued, survivors=len(self._replicas),
        )

    def resubmit_orphans(self) -> int:
        """Re-dispatch uids whose replica no longer exists (a total-loss
        window followed by a fresh replica)."""
        orphans = [
            uid for uid, rid in self._assigned.items()
            if rid not in self._replicas
            and uid not in self.results
            and uid not in self.cancelled
        ]
        count = 0
        for uid in orphans:
            request = self._requests.get(uid)
            if request is None:
                continue
            try:
                self.submit(request)
                count += 1
            except NoReplicaError:
                break
        self.resubmitted += count
        return count

    # -- cancel ---------------------------------------------------------------

    def cancel(self, uid: str) -> bool:
        """Cancel a still-queued request (True).  A request already
        holding a slot finishes its decode (False) — mid-flight slots are
        not torn out from under the compiled step."""
        if uid in self.results or uid in self.cancelled:
            return uid in self.cancelled
        rid = self._assigned.get(uid)
        replica = self._replicas.get(rid) if rid else None
        if replica is None:
            return False
        queue = replica.engine._queue
        for entry in list(queue):
            if entry[0].uid == uid:
                queue.remove(entry)
                self.cancelled.add(uid)
                return True
        return False

    # -- drain / scale --------------------------------------------------------

    def drain(self, rid: str, max_steps: int = 4096):
        """Drain one replica: stop admitting, move its queue to survivors,
        let its live slots finish, then drop it from the registry."""
        replica = self._replicas.get(rid)
        if replica is None:
            return
        if len(self._replicas) <= MIN_REPLICAS:
            raise NoReplicaError(
                f"cannot drain {rid}: fleet at min_replicas={MIN_REPLICAS}"
            )
        # Flush any finished pages out before the replica stops routing.
        self._stream_pages()
        replica.draining = True
        # Requeue its waiting requests on the survivors.
        queue = replica.engine._queue
        while queue:
            request, _ = queue.popleft()
            self.submit(request)
        # Hand its undelivered pages to another decode-capable replica
        # (a draining replica is unroutable, so _decode_target skips it).
        pages = replica.engine._page_queue
        while pages:
            target = self._decode_target()
            if target is None:
                replica.draining = False
                raise NoReplicaError(
                    f"cannot drain {rid}: no decode-capable survivor for "
                    f"its {len(pages)} pending page(s)"
                )
            page = pages[0]
            target.engine.insert_page(page)
            pages.popleft()
            self._assigned[page.request.uid] = target.rid
        # Let live slots run dry — the whole fleet keeps stepping, so the
        # drain is invisible to every other replica's traffic.
        for _ in range(max_steps):
            if not replica.engine._live_slots():
                break
            self.step()
        else:
            raise RuntimeError(f"drain of {rid} did not converge")
        self._harvest(replica)
        self._replicas.pop(rid, None)
        self.retired += 1
        logger.info("fleet: replica %s drained and retired", rid)

    def maybe_scale(self, policy) -> Optional[str]:
        """One ``ServeScalePolicy`` (``master/auto_scaler.py``) evaluation
        over the fleet's own aggregate (the in-process analogue of the
        reference auto-scaler's ``observe_serving``): hot → spawn a
        replica (when a ``spawn`` factory is wired), comfortably idle →
        drain-then-retire the least-loaded one.  Returns "out", "in" or None.

        Two refinements over the raw thresholds: a p95 backed by fewer
        than ``policy.min_samples`` completed requests is IGNORED (a
        quantile over two latencies is noise, and acting on it flaps the
        fleet — occupancy, which is always well-sampled, still acts); and
        a disaggregated fleet's prefill pool scales on its own signal —
        prompt backlog per prefill replica against
        ``policy.prefill_backlog_high`` — independent of the decode
        pool's latency/occupancy, because a prefill bottleneck shows up
        as queueing long before it moves decode p95."""
        stats = self.stats()
        if stats["replicas"] < 1 or stats["qps"] < policy.min_qps:
            return None
        p95_known = stats["p95_n"] >= policy.min_samples
        n_prefill = stats["prefill_replicas"]
        if n_prefill and self.spawn_prefill is not None:
            backlog = stats["prefill_backlog"] / n_prefill
            if backlog > policy.prefill_backlog_high:
                self.add_replica(self.spawn_prefill())
                return "out"
        if (
            (p95_known and stats["p95_s"] > policy.slo_p95_s)
            or stats["occupancy"] > policy.occupancy_high
        ):
            if self.spawn is not None:
                self.add_replica(self.spawn())
                return "out"
            return None
        if (
            p95_known
            and stats["p95_s"] < 0.5 * policy.slo_p95_s
            and stats["occupancy"] < policy.occupancy_low
            and len(self._replicas) > MIN_REPLICAS
        ):
            # Retire from the decode-capable pool when one exists —
            # idle occupancy is a decode-side signal.
            pool = [
                r for r in self._replicas.values()
                if r.engine.role != "prefill"
            ] or list(self._replicas.values())
            victim = min(pool, key=self._load)
            self.drain(victim.rid)
            return "in"
        return None

    # -- stats ----------------------------------------------------------------

    def queue_depth(self) -> int:
        return sum(
            len(r.engine._queue) for r in self._replicas.values()
        )

    def pending(self) -> int:
        """Requests in the system: assigned but not finished/cancelled."""
        return sum(
            1 for uid in self._assigned
            if uid not in self.results and uid not in self.cancelled
        )

    def service_rate(self) -> float:
        """Aggregate completion rate (req/s) from the replicas' stats —
        the denominator of the front door's predicted-wait shed test."""
        return sum(
            r.engine.stats()["qps"] for r in self._replicas.values()
        )

    def stats(self) -> Dict[str, float]:
        per = [r.engine.stats() for r in self._replicas.values()]
        n = len(per)
        # The fleet p95 is the WORST replica's; its sample count rides
        # along so the scale policy can judge whether that p95 means
        # anything.
        worst = max(
            per, key=lambda s: s["p95_s"],
            default={"p95_s": 0.0, "p95_n": 0.0},
        )
        prefill = [
            r for r in self._replicas.values()
            if r.engine.role == "prefill"
        ]
        spec_prop = sum(s["spec_proposed"] for s in per)
        spec_acc = sum(s["spec_accepted"] for s in per)
        return {
            "replicas": float(n),
            "qps": sum(s["qps"] for s in per),
            "p95_s": worst["p95_s"],
            "p95_n": worst["p95_n"],
            "decode_step_p95_s": max(
                (s["decode_step_p95_s"] for s in per),
                default=0.0,
            ),
            "occupancy": (
                sum(s["occupancy"] for s in per) / n if n else 0.0
            ),
            "queue_depth": float(self.queue_depth()),
            "pending": float(self.pending()),
            "requests": sum(s["requests"] for s in per),
            "deaths": float(self.deaths),
            "step_failures": float(self.step_failures),
            "resubmitted": float(self.resubmitted),
            "retired": float(self.retired),
            "prefill_replicas": float(len(prefill)),
            "decode_replicas": float(n - len(prefill)),
            "prefill_backlog": float(sum(
                len(r.engine._queue) for r in prefill
            )),
            "pages_streamed": float(self.pages_streamed),
            "page_bytes_streamed": float(self.page_bytes_streamed),
            "spec_proposed": spec_prop,
            "spec_accepted": spec_acc,
            "spec_accept_rate": (
                spec_acc / spec_prop if spec_prop else 0.0
            ),
        }

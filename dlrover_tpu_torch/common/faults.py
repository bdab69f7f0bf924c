"""Faultline: process-local deterministic fault-injection registry.

Failure is a first-class, testable input: production code declares *seams*
(named points where the real world can fail — an RPC send, a storage write,
a backend init) by calling :func:`fire`, and a *fault plan* decides which
invocations actually fail.  With no plan configured the whole fabric
collapses to one module-global ``None`` check per call — the same
shared-null trick ``common/telemetry.py`` uses for disabled spans — so the
hot step loop pays nothing.

Plan syntax (env ``DLROVER_TPU_FAULTS`` or :func:`configure`)::

    seam:kind[@schedule][;seam:kind[@schedule]]...

    storage.write:error@3            # raise on the 3rd firing of the seam
    rpc.report:delay=2.0@5,7         # sleep 2s on firings 5 and 7
    coworker.fetch:error@every:4     # every 4th firing
    rpc.get:error@p=0.25             # seeded coin-flip per firing
    backend.init:error               # every firing

Kinds: ``error`` raises :class:`FaultInjected`; ``delay=<seconds>`` sleeps.
Schedules are keyed on the seam's 1-based *hit counter* and the
probabilistic form draws from a per-seam ``random.Random`` seeded from
``(DLROVER_TPU_FAULTS_SEED, crc32(seam))`` — never ``hash()``, which is
randomized per process — so the same plan + seed fires the same faults in
the same order on every run.

Every fired fault is booked as a ``fault`` telemetry event (with the delay
as its duration), so the master's goodput ledger can attribute lost time to
injected failures instead of blaming the job.

Known seams (see PROFILE.md "Faultline" for the incident each models):
``rpc.report``, ``rpc.get``, ``storage.write``, ``storage.read``,
``saver.persist``, ``saver.flush``, ``backend.init``, ``coworker.fetch``,
``preempt.notice``, ``rdzv.join``, ``sdc.flip``, ``serve.admit``,
``tpu.api``, ``relayout.apply``, ``serve.rpc``, ``serve.swap``,
``replica.death``, ``http.serve``, ``embed.fetch``, ``embed.reshard``.
"""

from __future__ import annotations

import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common import telemetry

ENV_PLAN = "DLROVER_TPU_FAULTS"
ENV_SEED = "DLROVER_TPU_FAULTS_SEED"

KNOWN_SEAMS = (
    "rpc.report",
    "rpc.get",
    "storage.write",
    "storage.read",
    "saver.persist",
    "saver.flush",
    "backend.init",
    "coworker.fetch",
    # Elastic-resize seams: a scripted preemption notice (the agent's
    # monitor treats a fired error here as "this host just got its
    # preemption warning"), a transient rendezvous-join failure, and the
    # breakpoint shm->storage flush a draining host races its grace window.
    "preempt.notice",
    "rdzv.join",
    # Silent-data-corruption seam: a fired error here tells the trainer to
    # flip one mantissa bit in its post-update state (state_digest.py's
    # flipper) — modeling a chip that computes wrong numbers while every
    # liveness monitor stays green.
    "sdc.flip",
    # Serving admission seam: fires on every ServingEngine.submit, under
    # the engine's RetryPolicy (error kinds are retried with backoff;
    # delay kinds stall admission — modeling a slow/flaky front door).
    "serve.admit",
    # Cloud control-plane seam: every GCE metadata / TPU REST call in
    # master/tpu_api.py (token fetch, node create/delete/poll).  A fired
    # error surfaces as the same CloudError/degrade path a flaky API
    # produces, so launcher retry logic is drillable without GCP.
    "tpu.api",
    # Live-resize seam: fires at the top of every ElasticTrainer
    # re-layout attempt (apply_world_change), under its RetryPolicy —
    # error kinds are retried, and on exhaustion the trainer degrades to
    # checkpoint restore, booked as resizes_by_reason["relayout_failed"].
    # Delay kinds stretch the relayout window the resize ledger measures.
    "relayout.apply",
    # Serving front-door seam: fires on every submit/poll/cancel the RPC
    # front door handles — error kinds model a flaky client link (the
    # caller's RetryPolicy re-issues), delay kinds model a slow ingress
    # that eats into per-request deadlines.
    "serve.rpc",
    # Weight hot-swap seam: fires inside ServingEngine.swap_weights after
    # the new params land on device; a fired error tells the engine to
    # corrupt one mantissa bit of the swapped tree (state_digest's
    # flipper) — modeling a torn/corrupt weight push that only the digest
    # check can see.  The engine must detect it and roll back.
    "serve.swap",
    # Replica-death seam: fires on the fleet's per-replica health probe; a
    # fired error IS the scripted replica crash — the fleet must requeue
    # that replica's in-flight requests onto survivors with zero lost.
    "replica.death",
    # HTTP observability plane seam (master/http_plane.py): fires on the
    # scrape server's bind and on every GET — an error kind answers the
    # scraper 503 exactly like a wedged master, delay kinds model slow
    # scrapes holding handler threads.
    "http.serve",
    # Embedding-plane fetch seam (embedding/sharded.py): fires once per
    # owner a sharded lookup / gradient push exchanges rows with — an
    # error kind models a peer host that dropped the batch's row exchange,
    # delay kinds model a straggling parameter host.
    "embed.fetch",
    # Embedding-plane reshard seam: fires at the top of every bucket-map
    # re-fold (world resize); an error kind aborts the row migration
    # before any owner mutates, so the retrying caller re-enters with the
    # old fold intact.
    "embed.reshard",
)


class FaultInjected(RuntimeError):
    """An injected (not organic) failure.

    Carries the seam and hit index so retry layers and logs can tell a
    scripted fault from a real incident.  ``common/retry.py`` treats it as
    always-retryable: faults exist to exercise recovery paths, and a fault
    classified fatal would make every ``error`` plan a job-killer.
    """

    def __init__(self, seam: str, hit: int):
        super().__init__(f"injected fault at {seam} (hit {hit})")
        self.seam = seam
        self.hit = hit


class FaultRule:
    """One parsed ``seam:kind@schedule`` clause."""

    __slots__ = ("seam", "kind", "delay_s", "hits", "every", "prob")

    def __init__(
        self,
        seam: str,
        kind: str,
        delay_s: float = 0.0,
        hits: Tuple[int, ...] = (),
        every: int = 0,
        prob: float = -1.0,
    ):
        self.seam = seam
        self.kind = kind
        self.delay_s = delay_s
        self.hits = frozenset(hits)
        self.every = every
        self.prob = prob

    def should_fire(self, hit: int, rng: random.Random) -> bool:
        if self.hits:
            return hit in self.hits
        if self.every > 0:
            return hit % self.every == 0
        if self.prob >= 0.0:
            return rng.random() < self.prob
        return True  # no schedule: every firing


def parse_plan(plan: str) -> List[FaultRule]:
    """Parse a fault-plan string; raises ``ValueError`` on malformed input
    (a silently-dropped clause would make a chaos run vacuously green)."""
    rules: List[FaultRule] = []
    for clause in plan.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        seam, _, rest = clause.partition(":")
        seam = seam.strip()
        if not seam or not rest:
            raise ValueError(f"malformed fault clause {clause!r}")
        if seam not in KNOWN_SEAMS:
            logger.warning("fault plan names unknown seam %r "
                           "(known: %s)", seam, ", ".join(KNOWN_SEAMS))
        kind_part, _, sched = rest.partition("@")
        kind_part = kind_part.strip()
        delay_s = 0.0
        if kind_part == "error":
            kind = "error"
        elif kind_part.startswith("delay="):
            kind = "delay"
            delay_s = float(kind_part[len("delay="):])
        else:
            raise ValueError(
                f"unknown fault kind {kind_part!r} in {clause!r} "
                "(want 'error' or 'delay=<seconds>')"
            )
        hits: Tuple[int, ...] = ()
        every = 0
        prob = -1.0
        sched = sched.strip()
        if sched and sched != "*":
            if sched.startswith("every:"):
                every = int(sched[len("every:"):])
                if every <= 0:
                    raise ValueError(f"non-positive every in {clause!r}")
            elif sched.startswith("p="):
                prob = float(sched[len("p="):])
                if not 0.0 <= prob <= 1.0:
                    raise ValueError(f"probability out of range in {clause!r}")
            else:
                hits = tuple(int(h) for h in sched.split(","))
                if any(h <= 0 for h in hits):
                    raise ValueError(f"hit indices are 1-based in {clause!r}")
        rules.append(FaultRule(seam, kind, delay_s, hits, every, prob))
    return rules


def _seam_seed(seed: int, seam: str) -> int:
    # crc32, not hash(): str hashing is salted per process and would make
    # "same seed, same schedule" a lie across restarts.
    return (seed << 32) ^ zlib.crc32(seam.encode())


class FaultPlan:
    """Active plan: per-seam hit counters, seeded RNGs, fired-fault log."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 sleep_fn=time.sleep):
        self.seed = seed
        self._sleep = sleep_fn
        self._lock = threading.Lock()
        self._rules: Dict[str, List[FaultRule]] = {}
        for rule in rules:
            self._rules.setdefault(rule.seam, []).append(rule)
        self._hits: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {
            seam: random.Random(_seam_seed(seed, seam)) for seam in self._rules
        }
        # Every fired fault: (seam, kind, hit) — the deterministic record
        # tests and goodput_bench compare across runs.
        self.fired: List[Tuple[str, str, int]] = []

    def fire(self, seam: str, **attrs):
        rules = self._rules.get(seam)
        if rules is None:
            return
        with self._lock:
            hit = self._hits.get(seam, 0) + 1
            self._hits[seam] = hit
            rng = self._rngs[seam]
            todo = [r for r in rules if r.should_fire(hit, rng)]
            if todo:
                self.fired.extend((r.seam, r.kind, hit) for r in todo)
        if not todo:
            return
        for rule in todo:
            logger.warning(
                "FAULTLINE: firing %s at %s (hit %d)%s",
                rule.kind, seam, hit,
                f" delay={rule.delay_s}s" if rule.kind == "delay" else "",
            )
            telemetry.event(
                "fault", duration_s=rule.delay_s,
                seam=seam, kind=rule.kind, hit=hit, injected=True, **attrs,
            )
            if rule.kind == "delay":
                self._sleep(rule.delay_s)
            else:
                raise FaultInjected(seam, hit)

    def hit_count(self, seam: str) -> int:
        with self._lock:
            return self._hits.get(seam, 0)


# The whole disabled-path cost: one global load + None check per fire().
_PLAN: Optional[FaultPlan] = None


def fire(seam: str, **attrs):
    """Declare a fault seam.  No-op (no allocation beyond the call itself)
    unless a plan names ``seam``."""
    plan = _PLAN
    if plan is None:
        return
    plan.fire(seam, **attrs)


def active() -> Optional[FaultPlan]:
    return _PLAN


def configure(plan: str, seed: int = 0) -> Optional[FaultPlan]:
    """Install a plan string (empty → disable).  Returns the active plan."""
    global _PLAN
    rules = parse_plan(plan) if plan else []
    _PLAN = FaultPlan(rules, seed=seed) if rules else None
    if _PLAN is not None:
        logger.info("FAULTLINE armed: plan=%r seed=%d", plan, seed)
    return _PLAN


def reset():
    global _PLAN
    _PLAN = None


def configure_from_env() -> Optional[FaultPlan]:
    plan = os.environ.get(ENV_PLAN, "").strip()
    if not plan:
        return _PLAN
    try:
        seed = int(os.environ.get(ENV_SEED, "0") or 0)
    except ValueError:
        seed = 0
    return configure(plan, seed)


configure_from_env()

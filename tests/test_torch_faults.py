"""Port parity: the fault, retry and telemetry planes on the CPU.

``dlrover_tpu_torch.common.{faults,retry,telemetry,log}`` are copies of the
JAX package's modules held to the same behaviour, after
``tests/test_faultline.py`` (plan grammar, schedules, retry units, the
circuit breaker) and the recorder cases of ``tests/test_telemetry.py``
(spans, events, the bounded ring, the Chrome trace): the same plan and
seed fire on exactly the same hits in both packages over the same seam
calls, and ``RetryPolicy`` gives the same delays under the same seed.  The
master's servicer side of the telemetry plane is not ported.
"""

import os
import random
import threading
import time

import pytest

from dlrover_tpu.common import faults as jfaults
from dlrover_tpu.common import retry as jretry
from dlrover_tpu.common import telemetry as jtelemetry
from dlrover_tpu_torch.common import faults, log, retry, telemetry

PLANS = [
    "storage.write:error@3",
    "rpc.report:delay=0.0@5,7;storage.read:error@every:4",
    "serve.admit:error@p=0.25;embed.fetch:error@p=0.6",
    "backend.init:error",
    "storage.write:error@2;storage.write:delay=0.0@every:3",
]
SEAMS = ("storage.write", "storage.read", "rpc.report", "serve.admit",
         "embed.fetch", "backend.init", "saver.persist")


@pytest.fixture(autouse=True)
def _no_plan():
    for mod in (faults, jfaults):
        mod.reset()
    yield
    for mod in (faults, jfaults):
        mod.reset()


def _drive(mod, plan, seed, calls):
    """Fire the seams ``calls`` times each in a fixed interleaving under
    ``plan``; returns ``(raised hits, fired log)``."""
    mod.configure(plan, seed=seed)
    mod.active()._sleep = lambda s: None
    raised = []
    for i in range(calls):
        for seam in SEAMS:
            try:
                mod.fire(seam, i=i)
            except mod.FaultInjected as e:
                raised.append((e.seam, e.hit))
    fired = list(mod.active().fired)
    mod.reset()
    return raised, fired


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("plan", PLANS)
def test_same_plan_and_seed_fire_the_same_hits(plan, seed):
    want = _drive(jfaults, plan, seed, 40)
    got = _drive(faults, plan, seed, 40)
    assert got == want
    assert got[1], "the plan fired nothing: a vacuous comparison"


def test_probabilistic_schedule_depends_on_the_seed_only():
    plan = "serve.admit:error@p=0.5"
    a = _drive(faults, plan, 3, 64)
    b = _drive(faults, plan, 3, 64)
    c = _drive(faults, plan, 4, 64)
    assert a == b and a != c


@pytest.mark.parametrize("plan", [
    "storage.write:error@3;rpc.report:delay=2.0@5,7;"
    "coworker.fetch:error@every:4;rpc.get:error@p=0.25;backend.init:error",
    "serve.admit:error@1,2;embed.reshard:delay=0.5@every:2",
])
def test_plan_grammar_parses_as_the_reference_does(plan):
    def rules(mod):
        return [(r.seam, r.kind, r.delay_s, r.hits, r.every, r.prob)
                for r in mod.parse_plan(plan)]

    assert rules(faults) == rules(jfaults)
    assert faults.KNOWN_SEAMS == jfaults.KNOWN_SEAMS
    assert (faults.ENV_PLAN, faults.ENV_SEED) == (
        "DLROVER_TPU_FAULTS", "DLROVER_TPU_FAULTS_SEED")


@pytest.mark.parametrize("bad", [
    "storage.write", ":error", "storage.write:boom", "storage.write:error@0",
    "storage.write:error@every:0", "storage.write:error@p=1.5",
])
def test_plan_grammar_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jfaults.parse_plan(bad)
    with pytest.raises(ValueError):
        faults.parse_plan(bad)


def test_disabled_path_is_a_no_op_and_env_configures(monkeypatch):
    assert faults.active() is None
    for _ in range(100):
        faults.fire("storage.write")
    monkeypatch.setenv("DLROVER_TPU_FAULTS", "storage.write:error@2")
    monkeypatch.setenv("DLROVER_TPU_FAULTS_SEED", "5")
    plan = faults.configure_from_env()
    assert plan is not None and plan.seed == 5
    faults.fire("storage.write")
    with pytest.raises(faults.FaultInjected):
        faults.fire("storage.write")
    assert plan.fired == [("storage.write", "error", 2)]


def test_fired_fault_is_booked_as_a_telemetry_event():
    rec = telemetry.recorder()
    rec.configure(enabled=True)
    rec.drain()
    faults.configure("serve.admit:delay=0.0@2")
    faults.active()._sleep = lambda s: None
    for _ in range(3):
        faults.fire("serve.admit", request=4)
    booked = [e for e in rec.drain() if e[0] == "fault"]
    assert len(booked) == 1
    name, kind, _, duration, attrs = booked[0]
    assert attrs["seam"] == "serve.admit" and attrs["hit"] == 2
    assert attrs["injected"] and attrs["request"] == 4


# -- retry --------------------------------------------------------------------


def _delays(mod, seed, failures, **kw):
    seen = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= failures:
            raise ConnectionError("blip")
        return "ok"

    policy = mod.RetryPolicy(
        max_attempts=failures + 1, rng=random.Random(seed),
        sleep=lambda s: None, on_retry=lambda a, e, d: seen.append((a, d)),
        **kw)
    assert policy.call(flaky) == "ok"
    return seen


@pytest.mark.parametrize("seed", [0, 1, 99])
@pytest.mark.parametrize("kw", [
    dict(), dict(base_delay_s=0.1, max_delay_s=0.4),
    dict(jitter=False, base_delay_s=0.25, max_delay_s=3.0),
])
def test_retry_policy_gives_the_same_delays_under_the_same_seed(seed, kw):
    got = _delays(retry, seed, 6, **kw)
    assert got == _delays(jretry, seed, 6, **kw)
    assert [a for a, _ in got] == [1, 2, 3, 4, 5, 6]
    policy = retry.RetryPolicy(**kw)
    for attempt, delay in got:
        assert 0.0 <= delay <= policy.backoff_s(attempt)


def test_retry_exhaustion_deadline_and_classification():
    policy = retry.RetryPolicy(max_attempts=3, sleep=lambda s: None,
                               jitter=False, name="t")
    with pytest.raises(retry.RetryError) as err:
        policy.call(lambda: (_ for _ in ()).throw(ConnectionError("x")))
    assert err.value.attempts == 3
    assert isinstance(err.value.last_error, ConnectionError)
    fatal = retry.RetryPolicy(retryable=(ConnectionError,),
                              fatal=(KeyError,), sleep=lambda s: None)
    with pytest.raises(KeyError):
        fatal.call(lambda: {}["k"])
    with pytest.raises(ValueError):
        fatal.call(lambda: int("nope"))
    # An injected fault is retryable whatever the policy lists.
    hits = {"n": 0}

    def injected():
        hits["n"] += 1
        if hits["n"] < 3:
            raise faults.FaultInjected("serve.admit", hits["n"])
        return hits["n"]

    assert fatal.call(injected) == 3
    deadline = retry.RetryPolicy(max_attempts=100, deadline_s=0.05,
                                 base_delay_s=0.02, jitter=False)
    t0 = time.monotonic()
    with pytest.raises(retry.RetryError):
        deadline.call(lambda: (_ for _ in ()).throw(OSError("x")))
    assert time.monotonic() - t0 < 2.0
    aborted = retry.RetryPolicy(sleep=lambda s: True)
    with pytest.raises(retry.RetryAborted):
        aborted.call(lambda: (_ for _ in ()).throw(OSError("x")))


def test_circuit_breaker_cycles_as_the_reference_does():
    def run(mod):
        clock = {"t": 0.0}
        breaker = mod.CircuitBreaker(failure_threshold=2, reset_after_s=5.0,
                                     clock=lambda: clock["t"])
        states = []
        for _ in range(2):
            with pytest.raises(ZeroDivisionError):
                breaker.call(lambda: 1 / 0)
            states.append(breaker.state)
        with pytest.raises(mod.CircuitOpenError):
            breaker.call(lambda: "x")
        clock["t"] = 6.0
        states.append(breaker.state)
        states.append(breaker.call(lambda: "probe"))
        states.append(breaker.state)
        return states

    assert run(retry) == run(jretry) == [
        "closed", "open", "half-open", "probe", "closed"]


# -- telemetry ------------------------------------------------------------------


def _recorders(**kw):
    kw.setdefault("enabled", True)
    kw.setdefault("ring_size", 256)
    return (telemetry.TelemetryRecorder(**kw),
            jtelemetry.TelemetryRecorder(**kw))


def test_spans_and_events_record_as_the_reference_does():
    port, ref = _recorders(source="trainer")
    for rec in (port, ref):
        with rec.span("outer", step=7) as outer:
            with rec.span("inner"):
                pass
            outer.attrs["tokens"] = 128
        rec.event("mark", phase="x")
        rec.event("timed", duration_s=0.25, phase="y")
        with pytest.raises(RuntimeError):
            with rec.span("boom"):
                raise RuntimeError("x")
        with pytest.raises(ValueError):
            rec.event("bad", name="shadow")
        with pytest.raises(TypeError):
            rec.event("bad", duration_s="1s")
    got, want = port.drain(), ref.drain()
    assert [(n, k, a) for n, k, _, _, a in got] == [
        (n, k, a) for n, k, _, _, a in want]
    names = [e[0] for e in got]
    assert names == ["inner", "outer", "mark", "timed", "boom"]
    assert got[1][4] == {"step": 7, "tokens": 128, "src": "trainer"}
    assert got[3][1] == "span" and got[3][3] == 0.25
    assert got[4][4]["error"] == "RuntimeError"
    assert port.drain() == []


def test_ring_is_bounded_under_threaded_churn_and_resizes():
    rec = telemetry.TelemetryRecorder(enabled=True, ring_size=64)

    def churn():
        for i in range(500):
            rec.event("e", i=i)

    threads = [threading.Thread(target=churn) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(rec) == 64 and rec.dropped == 2000 - 64
    newest = rec.peek()[-16:]
    rec.configure(ring_size=8)  # the floor of 16, as in the reference
    assert rec.ring_size == 16 and rec.peek() == newest


def test_disabled_recorder_and_env_knobs(monkeypatch):
    off = telemetry.TelemetryRecorder(enabled=False)
    assert off.span("x") is off.span("y")
    off.event("x")
    assert len(off) == 0
    monkeypatch.setenv("DLROVER_TPU_TELEMETRY", "off")
    monkeypatch.setenv("DLROVER_TPU_TELEMETRY_RING", "32")
    env = telemetry.TelemetryRecorder()
    assert not env.enabled and env.ring_size == 32
    assert (telemetry.ENV_ENABLE, telemetry.ENV_RING) == (
        jtelemetry.ENV_ENABLE, jtelemetry.ENV_RING)


def test_chrome_trace_equals_the_references():
    port, ref = _recorders(source="trainer")
    for rec in (port, ref):
        rec.event("rdzv", duration_s=0.5, src="agent", node=1)
        rec.event("fault", seam="storage.write")
    # Same wire events (clocks copied) -> the same trace.
    events = port.drain()
    ref.drain()
    by_node = {0: events, 3: events[:1]}
    assert telemetry.events_to_chrome_trace(by_node) == \
        jtelemetry.events_to_chrome_trace(by_node)


def test_log_is_the_ports_own_logger():
    assert log.default_logger.name == "dlrover_tpu_torch"
    assert log.default_logger.handlers and not log.default_logger.propagate
    assert os.environ.get("DLROVER_TPU_LOG_LEVEL", "INFO").upper() in (
        "DEBUG", "INFO", "WARNING", "ERROR")

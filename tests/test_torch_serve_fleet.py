"""Port parity: the serving fleet, its front door, disaggregated prefill and
live weight hot-swap (``serving/{fleet,frontend,hotswap}.py``, the
engine's roles and ``swap_weights``) against the JAX serving plane.

The model is a 2-layer config at the serving tests' small size (d_model
64, vocab 64) in fp32 with xla attention, the JAX parameters carried into
the port; every request is greedy.  Each fleet scenario is one script run
twice, on the JAX package's classes and on the port's, under the same
fault plans: the records it returns (routing assignments, deaths,
resubmissions, drains, scale decisions, front-door verdicts, page counts
and bytes, and every request's tokens) must be equal, exactly.  Hot swap:
the port's host digest of carried weights equals the JAX ``host_digest``
and the JAX jitted digest, the device digest equals the host digest, a
live swap leaves slots, queue and KV pool as they were and then streams
as a fresh engine on the new weights, and the ``serve.swap`` seam rolls
back.  Every test seeds its own generators.
"""

import glob
import json
import os
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.common import faults as jfaults
from dlrover_tpu.master import messages as jmsg
from dlrover_tpu.master.auto_scaler import ServeScalePolicy as JPolicy
from dlrover_tpu.models.transformer import TransformerConfig as JConfig
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.rl.generation import SamplingParams as JSampling
from dlrover_tpu.serving import NoReplicaError as JNoReplica
from dlrover_tpu.serving import ReplicaFleet as JFleet
from dlrover_tpu.serving import Request as JRequest
from dlrover_tpu.serving import ServeFrontend as JFrontend
from dlrover_tpu.serving import ServingEngine as JEngine
from dlrover_tpu.serving import hotswap as jhotswap
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.master import messages as msg
from dlrover_tpu_torch.master.auto_scaler import ServeScalePolicy
from dlrover_tpu_torch.models import init_params
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import TransformerConfig
from dlrover_tpu_torch.rl.generation import SamplingParams
from dlrover_tpu_torch.serving import (
    NoReplicaError,
    ReplicaFleet,
    Request,
    ServeFrontend,
    ServingEngine,
    hotswap,
)

VOCAB, SEQ = 64, 32
MODEL = dict(vocab_size=VOCAB, d_model=64, num_heads=4, num_layers=2,
             d_ff=128, max_seq_len=SEQ)
BUCKETS = (8, 16)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """A job tag and socket directory of the test's own; no fault plan
    leaks, and the checkpoint arenas the test made are removed."""
    job = f"tsf{os.getpid()}_{tmp_path.name}"
    monkeypatch.setenv("DLROVER_TPU_JOB", job)
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    for path in glob.glob(f"/dev/shm/dlrover_tpu_ckpt_{job}_*"):
        os.unlink(path)


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(**MODEL, dtype=jnp.float32)
    tcfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = nn.meta.unbox(JModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    state = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, state


def _sides(setup):
    """The JAX package's classes and the port's, each with an engine
    factory: what a scenario script runs on."""
    jcfg, params, tcfg, state = setup

    def jax_engine(slots=2, seed=0, role="mixed"):
        return JEngine(jcfg, params, slots=slots, buckets=BUCKETS,
                       seed=seed, role=role)

    def port_engine(slots=2, seed=0, role="mixed"):
        return ServingEngine(tcfg, state, slots=slots, buckets=BUCKETS,
                             seed=seed, role=role, device="cpu")

    return {
        "jax": types.SimpleNamespace(
            Fleet=JFleet, NoReplica=JNoReplica, Request=JRequest,
            Sampling=JSampling, faults=jfaults, msg=jmsg,
            Frontend=JFrontend, Policy=JPolicy, engine=jax_engine),
        "port": types.SimpleNamespace(
            Fleet=ReplicaFleet, NoReplica=NoReplicaError, Request=Request,
            Sampling=SamplingParams, faults=faults, msg=msg,
            Frontend=ServeFrontend, Policy=ServeScalePolicy,
            engine=port_engine),
    }


def _req(ns, uid, n=5, new=4):
    prompt = (np.arange(n, dtype=np.int64) % (VOCAB - 1)) + 1 + len(uid)
    prompt = prompt % (VOCAB - 1) + 1
    return ns.Request(uid=uid, prompt=prompt, sampling=ns.Sampling(
        temperature=0.0, max_new_tokens=new))


def _run(fleet, budget=400):
    for _ in range(budget):
        if fleet.pending() == 0:
            return True
        fleet.step()
    return fleet.pending() == 0


def _tokens(results):
    return {u: [int(t) for t in r.tokens] for u, r in sorted(results.items())}


# -- fleet scenarios (each returns a record of plain values) ------------------


def _death(ns):
    fleet = ns.Fleet()
    fleet.add_replica(ns.engine())
    fleet.add_replica(ns.engine(seed=1))
    assigned = [fleet.submit(_req(ns, f"r{i}", n=3 + i, new=6))
                for i in range(6)]
    # Hit 4 is step 2's probe of replica-1: it dies holding live slots
    # and queued requests.
    ns.faults.configure("replica.death:error@4", seed=0)
    done = _run(fleet)
    return dict(assigned=assigned, done=done, deaths=fleet.deaths,
                resubmitted=fleet.resubmitted, ids=fleet.replica_ids(),
                tokens=_tokens(fleet.results),
                fired=list(ns.faults.active().fired))


def _orphans(ns):
    fleet = ns.Fleet()
    fleet.add_replica(ns.engine())
    fleet.submit(_req(ns, "a"))
    fleet.submit(_req(ns, "b", n=7))
    ns.faults.configure("replica.death:error@1", seed=0)
    fleet.step()  # total loss: no survivor to resubmit onto
    ns.faults.reset()
    lost = dict(ids=fleet.replica_ids(), deaths=fleet.deaths,
                pending=fleet.pending(), results=len(fleet.results))
    fleet.add_replica(ns.engine(seed=2))
    return dict(lost=lost, orphans=fleet.resubmit_orphans(),
                done=_run(fleet), tokens=_tokens(fleet.results))


def _drain(ns):
    fleet = ns.Fleet()
    fleet.add_replica(ns.engine())
    fleet.add_replica(ns.engine(seed=1))
    for i in range(6):
        fleet.submit(_req(ns, f"r{i}", n=4 + i, new=5))
    fleet.step()
    fleet.drain("replica-0")
    record = dict(retired=fleet.retired, ids=fleet.replica_ids())
    record["done"] = _run(fleet)
    try:
        fleet.drain("replica-1")
        record["min_replicas"] = "drained"
    except ns.NoReplica:
        record["min_replicas"] = "refused"
    record["tokens"] = _tokens(fleet.results)
    return record


def _cancel(ns):
    fleet = ns.Fleet()
    fleet.add_replica(ns.engine(slots=1))
    fleet.submit(_req(ns, "live"))
    fleet.submit(_req(ns, "queued"))
    fleet.step()
    record = dict(queued=fleet.cancel("queued"), live=fleet.cancel("live"))
    record["done"] = _run(fleet)
    record["tokens"] = _tokens(fleet.results)
    record["cancelled"] = sorted(fleet.cancelled)
    return record


def _scale(ns):
    """``maybe_scale`` under stubbed statistics: out and in on latency and
    occupancy, a p95 over too few samples ignored, the prefill pool on its
    own backlog; then one decision on the fleet's real statistics."""
    decisions = []
    fleet = ns.Fleet(spawn=lambda: ns.engine(seed=9))
    fleet.add_replica(ns.engine())
    policy = ns.Policy(slo_p95_s=1.0, min_qps=0.0, min_samples=8)
    colocated = dict(prefill_replicas=0.0, prefill_backlog=0.0)
    for stats in (
            dict(replicas=1.0, qps=5.0, p95_s=2.0, occupancy=0.2,
                 p95_n=2.0),                     # unconfident breach
            dict(replicas=1.0, qps=5.0, p95_s=2.0, occupancy=0.95,
                 p95_n=2.0),                     # hot slots: out
            dict(replicas=2.0, qps=5.0, p95_s=0.1, occupancy=0.05,
                 p95_n=2.0),                     # unconfident idle
            dict(replicas=2.0, qps=5.0, p95_s=0.1, occupancy=0.05,
                 p95_n=50.0)):                   # confident idle: in
        fleet.stats = lambda s=stats: dict(s, **colocated)
        decisions.append((fleet.maybe_scale(policy), len(fleet._replicas)))
    del fleet.stats
    for i in range(3):
        fleet.submit(_req(ns, f"r{i}", new=3))
    done = _run(fleet)
    decisions.append((fleet.maybe_scale(ns.Policy(min_qps=0.0)),
                      len(fleet._replicas)))
    disagg = ns.Fleet(spawn=lambda: ns.engine(seed=9),
                      spawn_prefill=lambda: ns.engine(role="prefill",
                                                      seed=10))
    disagg.add_replica(ns.engine(role="prefill"))
    disagg.add_replica(ns.engine(role="decode"))
    disagg.stats = lambda: dict(
        replicas=2.0, qps=5.0, p95_s=0.1, occupancy=0.2, p95_n=50.0,
        prefill_replicas=1.0, prefill_backlog=9.0)
    decisions.append((disagg.maybe_scale(ns.Policy(
        min_qps=0.0, prefill_backlog_high=4.0)), len(disagg._replicas)))
    return dict(decisions=decisions, done=done, retired=fleet.retired,
                roles=sorted(r.engine.role for r in disagg._replicas.values()))


def _disagg(ns):
    colocated = ns.engine()
    want = colocated.run([_req(ns, f"r{i}", n=3 + 2 * i, new=5)
                          for i in range(4)])
    fleet = ns.Fleet()
    pre, dec = ns.engine(role="prefill"), ns.engine(role="decode")
    fleet.add_replica(pre)
    fleet.add_replica(dec)
    assigned = [fleet.submit(_req(ns, f"r{i}", n=3 + 2 * i, new=5))
                for i in range(4)]
    done = _run(fleet)
    stats = fleet.stats()
    return dict(assigned=assigned, done=done,
                equal_colocated=_tokens(fleet.results) == _tokens(want),
                tokens=_tokens(fleet.results),
                pages=stats["pages_streamed"],
                page_bytes=stats["page_bytes_streamed"],
                pages_in=dec.stats()["pages_in"],
                pages_out=pre.stats()["pages_out"])


def _frontend(ns):
    m = ns.msg

    def submit(uid, n=5, new=4, deadline_s=30.0):
        prompt = tuple(int(t) for t in (np.arange(n) % (VOCAB - 1)) + 1)
        ticket = front.submit(m.ServeSubmit(uid=uid, prompt=prompt,
                                            max_new_tokens=new,
                                            deadline_s=deadline_s))
        return (ticket.accepted, ticket.reason.split(":")[0])

    record = {}
    front = ns.Frontend(ns.Fleet())
    record["no_fleet"] = submit("nf")
    fleet = ns.Fleet()
    fleet.add_replica(ns.engine())
    front = ns.Frontend(fleet, max_pending=3)
    record["x"] = submit("x")
    record["x_pending"] = front.poll(m.ServePoll(uid="x")).state
    record["invalid"] = submit("big", n=SEQ + 8)
    _run(fleet)
    done = front.poll(m.ServePoll(uid="x"))
    record["x_done"] = (done.state, list(done.tokens))
    record["x_cancel_after"] = front.cancel(m.ServeCancel(uid="x")).state
    record["unknown"] = front.poll(m.ServePoll(uid="nope")).state
    # The bounded queue: 3 in the system, the 4th is refused.
    record["fill"] = [submit(f"q{i}") for i in range(4)]
    record["q3"] = front.poll(m.ServePoll(uid="q3")).state
    fleet.step()
    record["cancel_queued"] = front.cancel(m.ServeCancel(uid="q2")).state
    _run(fleet)
    # Shedding: a measured rate and a backlog, and a deadline no wait
    # can meet.
    front.max_pending = 64
    record["backlog"] = [submit(f"bk{i}") for i in range(4)]
    record["tight"] = submit("tight", deadline_s=1e-9)
    record["tight_state"] = front.poll(m.ServePoll(uid="tight")).state
    _run(fleet)
    # The serve.rpc seam fails exactly the one planned RPC.
    ns.faults.configure("serve.rpc:error@2", seed=0)
    rpc = [submit("rpc0")]
    try:
        front.poll(m.ServePoll(uid="rpc0"))
        rpc.append("no fault")
    except ns.faults.FaultInjected:
        rpc.append("fault")
    rpc.append(front.poll(m.ServePoll(uid="rpc0")).state)
    record["rpc"] = rpc
    record["fired"] = list(ns.faults.active().fired)
    ns.faults.reset()
    _run(fleet)
    record["counts"] = (front.submitted, front.shed_count,
                        front.rejected_full)
    record["tokens"] = _tokens(fleet.results)
    return record


SCENARIOS = {"death": _death, "orphans": _orphans, "drain": _drain,
             "cancel": _cancel, "scale": _scale, "disagg": _disagg,
             "frontend": _frontend}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_scenario_matches_the_jax_fleet(setup, scenario):
    """One scripted scenario on the JAX fleet and the port's: equal
    records, and the record shows what the scenario is for."""
    sides = _sides(setup)
    records = {}
    for side in ("jax", "port"):
        sides[side].faults.reset()
        records[side] = SCENARIOS[scenario](sides[side])
        sides[side].faults.reset()
    got, want = records["port"], records["jax"]
    if scenario == "disagg":
        # The JAX page also carries each layer's int32 cache cursor, which
        # the port's pool has no use for.
        cursors = 4 * setup[2].num_layers * want["pages"]
        assert want.pop("page_bytes") == got["page_bytes"] + cursors
        got = {k: v for k, v in got.items() if k != "page_bytes"} | {
            "page_bytes_port": got["page_bytes"]}
    assert {k: v for k, v in got.items() if k != "page_bytes_port"} == want
    if "done" in got:
        assert got["done"]
    if scenario == "death":
        assert got["deaths"] == 1 and got["resubmitted"] >= 1
        assert len(got["tokens"]) == 6  # zero lost
        assert got["ids"] == ["replica-0"]
    elif scenario == "orphans":
        assert got["lost"]["pending"] == 2 and got["orphans"] == 2
        assert sorted(got["tokens"]) == ["a", "b"]
    elif scenario == "drain":
        assert got["retired"] == 1 and got["min_replicas"] == "refused"
        assert len(got["tokens"]) == 6
    elif scenario == "cancel":
        assert got["queued"] and not got["live"]
        assert list(got["tokens"]) == ["live"]
    elif scenario == "scale":
        assert [d for d, _ in got["decisions"]] == [
            None, "out", None, "in", None, "out"]
        assert got["roles"] == ["decode", "prefill", "prefill"]
    elif scenario == "disagg":
        cfg = setup[2]
        row_bytes = 2 * cfg.num_layers * SEQ * cfg.num_heads * (
            cfg.d_model // cfg.num_heads) * 4
        assert got["equal_colocated"]
        assert got["pages"] == got["pages_in"] == got["pages_out"] == 4
        assert got["page_bytes_port"] == 4 * row_bytes
    elif scenario == "frontend":
        assert got["no_fleet"] == (False, "no_fleet")
        assert got["invalid"] == (False, "invalid")
        assert got["x_done"][0] == "done" and len(got["x_done"][1]) == 4
        assert got["fill"][-1] == (False, "queue_full")
        assert got["tight"] == (False, "shed")
        assert got["rpc"][1:] == ["fault", "pending"]
        assert got["fired"] == [("serve.rpc", "error", 2)]


def test_disaggregated_pages_carry_the_draft_row(setup):
    """A prefill replica whose decode pool speculates ships the draft's
    row in each page (page bytes = target row + draft row); the decode
    replica's spec streams equal the colocated engine's."""
    _, _, tcfg, state = setup
    from dlrover_tpu_torch.serving import make_draft

    draft_cfg, draft, damped = make_draft(tcfg, state, 1, 0.05)

    def engine(role):
        return ServingEngine(tcfg, damped, slots=2, buckets=BUCKETS,
                             role=role, draft_config=draft_cfg,
                             draft_params=draft, spec_tokens=3,
                             device="cpu")

    ns = _sides(setup)["port"]
    requests = [_req(ns, f"r{i}", n=4 + i, new=6) for i in range(3)]
    want = ServingEngine(tcfg, damped, slots=2, buckets=BUCKETS,
                         device="cpu").run(requests)
    fleet = ReplicaFleet()
    pre, dec = engine("prefill"), engine("decode")
    assert pre.spec is None and pre.draft_cache is None
    fleet.add_replica(pre)
    fleet.add_replica(dec)
    for r in requests:
        fleet.submit(r)
    assert _run(fleet)
    assert _tokens(fleet.results) == _tokens(want)
    hd = tcfg.d_model // tcfg.num_heads
    row = 2 * tcfg.num_layers * SEQ * tcfg.num_heads * hd * 4
    draft_row = 2 * 1 * SEQ * tcfg.num_heads * hd * 4
    assert fleet.page_bytes_streamed == 3 * (row + draft_row)
    assert dec.stats()["spec_proposed"] > 0


def test_role_guards(setup):
    ns = _sides(setup)["port"]
    dec = ns.engine(role="decode")
    with pytest.raises(ValueError, match="decode"):
        dec.submit(_req(ns, "a"))
    pre = ns.engine(role="prefill")
    pre.submit(_req(ns, "a"))
    assert pre.step() == 0 and len(pre.outbox) == 1
    page = pre.outbox[0]
    assert page.nbytes == sum(t.numel() * t.element_size() for t in page.row)
    assert all(t.device.type == "cpu" for t in page.row)
    with pytest.raises(ValueError, match="prefill"):
        pre.insert_page(page)
    with pytest.raises(ValueError, match="role"):
        ns.engine(role="router")
    _, _, tcfg, state = setup
    # tp=2 in a world of one process: the logical 2 folded onto it.
    folded = ServingEngine(tcfg, state, tp=2, device="cpu")
    assert (folded.tp.logical_tp, folded.tp.physical_tp) == (2, 1)
    class Reports:
        def __init__(self):
            self.events = []

        def report_event(self, event, detail=""):
            self.events.append((event, json.loads(detail)))

    reports = Reports()
    reporting = ServingEngine(tcfg, state, client=reports, device="cpu")
    seconds = reporting.aot_compile()
    assert reports.events == [("compile", {
        "seconds": round(seconds, 6), "restart": False,
        "cached": seconds == 0.0, "phase": "serve_aot"})]
    with pytest.raises(ValueError, match="tp > 1"):
        pre.fold_tp(2)
    assert pre.kv_device_bytes() == 2 * 2 * 2 * SEQ * 64 * 4


# -- hot swap -----------------------------------------------------------------


def test_digests_equal_the_jax_host_digest(setup):
    """The port's host digest of carried weights is the JAX
    ``host_digest`` of the JAX leaves and the JAX jitted digest; the
    device digest (``digest_leaves``, the stacked leaves folded as
    groups) equals it; one flipped bit moves both sides alike."""
    from dlrover_tpu.trainer.state_digest import _digest_tree

    jcfg, params, tcfg, state = setup
    _, jleaves = jhotswap.leaf_paths(params)
    want = jhotswap.host_digest([np.asarray(x) for x in jleaves])
    assert want == int(np.asarray(jax.jit(_digest_tree)(params)))
    assert hotswap.host_digest(state) == want
    engine = ServingEngine(tcfg, state, slots=1, buckets=BUCKETS,
                           device="cpu")
    assert int(hotswap.device_digest(engine.model)) == want
    names = [name for name, _ in hotswap.leaf_paths(state)]
    assert [jax.tree_util.keystr(p).replace("']['", ".")[2:-2]
            for p in (path for path, _ in
                      jax.tree_util.tree_flatten_with_path(params)[0])
            ] == names
    hotswap.flip_param_bit(engine.model)
    flipped = jhotswap.flip_param_bit(params)
    assert int(hotswap.device_digest(engine.model)) == int(
        np.asarray(jax.jit(_digest_tree)(flipped))) != want


def _save(ckpt_dir, step, state):
    saver = AsyncCheckpointSaver(ckpt_dir, host_index=0, num_hosts=1)
    saver.start()
    engine = CheckpointEngine(ckpt_dir, host_index=0, num_hosts=1,
                              agree_step_fn=lambda c: c, device="cpu")
    assert engine.save_to_storage(step, {"params": state})
    assert engine.wait_saver(timeout=60)
    return engine, saver


def test_swap_weights_live_then_rollback(setup, tmp_path):
    """A live swap between two steps: version 1, the live slot, the queue
    and the KV pool untouched, the model object the same; after it the
    engine streams as a fresh engine on the new weights.  Under a
    ``serve.swap`` plan the flipped bit is caught and the swap rolled
    back: version still 1, streams still the new weights'."""
    _, _, tcfg, state = setup
    new_state = init_params(tcfg, seed=1, device="cpu")
    ckpt_dir = str(tmp_path / "ckpt")
    ckpt, saver = _save(ckpt_dir, 5, new_state)
    ns = _sides(setup)["port"]
    try:
        engine = ns.engine()
        engine.submit(_req(ns, "live", new=6))
        engine.submit(_req(ns, "a", n=6))
        engine.submit(_req(ns, "queued", n=7))
        engine.step()
        live, queue = engine._live_slots(), list(engine._queue)
        pool_ptrs = [t.data_ptr() for t in engine.cache]
        model = engine.model
        report = engine.swap_weights(ckpt_dir)
        assert report["ok"] and not report["rolled_back"]
        assert report["step"] == 5 and report["version"] == 1
        assert engine._live_slots() == live and list(engine._queue) == queue
        assert [t.data_ptr() for t in engine.cache] == pool_ptrs
        assert engine.model is model
        for name, t in engine.model.state_dict().items():
            assert torch.equal(t, new_state[name]), name
        assert report["digest"] == f"{hotswap.host_digest(new_state):08x}"
        assert sorted(engine.drain()) == ["a", "live", "queued"]
        fresh = ServingEngine(tcfg, new_state, slots=2, buckets=BUCKETS,
                              device="cpu")
        after = [_req(ns, f"n{i}", n=3 + i, new=5) for i in range(3)]
        want = _tokens(fresh.run(after))
        got = engine.run(after)
        assert _tokens({u: got[u] for u in want}) == want

        faults.configure("serve.swap:error@1", seed=0)
        report = engine.swap_weights(ckpt_dir)
        faults.reset()
        assert not report["ok"] and report["rolled_back"]
        assert report["version"] == 1
        for name, t in engine.model.state_dict().items():
            assert torch.equal(t, new_state[name]), name
        again = [_req(ns, f"m{i}", n=3 + i, new=5) for i in range(3)]
        uids = [r.uid for r in again]
        got, want = engine.run(again), fresh.run(again)
        assert _tokens({u: got[u] for u in uids}) == \
            _tokens({u: want[u] for u in uids})
    finally:
        ckpt._shm.close(unlink=True)
        saver.stop()


def test_swap_refuses_drift_missing_leaves_and_no_step(setup, tmp_path):
    _, _, tcfg, state = setup
    arrays = {("['params']", f"['{n}']"): t for n, t in state.items()}
    sources = hotswap.map_checkpoint_to_params(arrays, state)
    assert list(sources) == list(state)
    assert all(sources[n] is state[n] for n in state)
    bare = {(f"['{n}']",): t for n, t in state.items()}
    assert list(hotswap.map_checkpoint_to_params(bare, state)) == list(state)
    missing = dict(arrays)
    gone = ("['params']", "['embed.embedding']")
    missing.pop(gone)
    with pytest.raises(ValueError, match="no tensor"):
        hotswap.map_checkpoint_to_params(missing, state)
    for drift in (lambda t: t.reshape(-1), lambda t: t.to(torch.bfloat16)):
        drifted = dict(arrays)
        drifted[gone] = drift(arrays[gone])
        with pytest.raises(ValueError, match="drifted"):
            hotswap.map_checkpoint_to_params(drifted, state)
    engine = ServingEngine(tcfg, state, slots=1, buckets=BUCKETS,
                           device="cpu")
    with pytest.raises(RuntimeError, match="no verifiable"):
        engine.swap_weights(str(tmp_path / "empty"))
    assert engine.weights_version == 0

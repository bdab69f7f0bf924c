"""The port's diagnosis chain, its wiring into the job master, the master's
state store and the brain's history against the reference's.

Each case is ``tests/test_diagnosis.py``'s (the same names, inputs and
assertions), run as a scenario on both packages under one fake clock; the
two records must agree exactly (actions, reasons, severities, rounds,
counts), floats within ``FLOAT_RTOL`` (1e-12 relative).  Beyond the
reference's cases: every operator of the default chain in one pass, and
the master executing what the chain prescribes (a world restart, a
quarantine).
"""

import ast
import os
import types

import pytest

from dlrover_tpu.common import faults as j_faults
from dlrover_tpu.master import brain as j_brain
from dlrover_tpu.master import diagnosis as j_diag
from dlrover_tpu.master import job_master as j_jm
from dlrover_tpu.master import memory_ledger as j_mem
from dlrover_tpu.master import messages as j_msg
from dlrover_tpu.master import metrics as j_metrics
from dlrover_tpu.master import node_manager as j_nm
from dlrover_tpu.master import rdzv_manager as j_rdzv
from dlrover_tpu.master import speed_monitor as j_sm
from dlrover_tpu.master import state_store as j_ss
from dlrover_tpu.master import timeline as j_tl
from dlrover_tpu_torch.common import faults as t_faults
from dlrover_tpu_torch.master import brain as t_brain
from dlrover_tpu_torch.master import diagnosis as t_diag
from dlrover_tpu_torch.master import job_master as t_jm
from dlrover_tpu_torch.master import memory_ledger as t_mem
from dlrover_tpu_torch.master import messages as t_msg
from dlrover_tpu_torch.master import metrics as t_metrics
from dlrover_tpu_torch.master import node_manager as t_nm
from dlrover_tpu_torch.master import rdzv_manager as t_rdzv
from dlrover_tpu_torch.master import speed_monitor as t_sm
from dlrover_tpu_torch.master import state_store as t_ss
from dlrover_tpu_torch.master import timeline as t_tl
from test_torch_master_parity import T0, FakeClock, assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = types.SimpleNamespace(
    brain=j_brain, diag=j_diag, faults=j_faults, jm=j_jm, mem=j_mem,
    msg=j_msg, metrics=j_metrics, nm=j_nm, rdzv=j_rdzv, sm=j_sm, ss=j_ss,
    tl=j_tl)
PORT = types.SimpleNamespace(
    brain=t_brain, diag=t_diag, faults=t_faults, jm=t_jm, mem=t_mem,
    msg=t_msg, metrics=t_metrics, nm=t_nm, rdzv=t_rdzv, sm=t_sm, ss=t_ss,
    tl=t_tl)


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    for ns in (REF, PORT):
        for mod in (ns.brain, ns.diag, ns.metrics, ns.nm, ns.rdzv, ns.sm):
            monkeypatch.setattr(mod, "time", c)
    return c


def run_both(scenario, clock, *args):
    clock.now = T0
    want = scenario(REF, clock, *args)
    clock.now = T0
    got = scenario(PORT, clock, *args)
    assert want, "the scenario recorded nothing"
    assert_same(got, want)
    return got


def _ctx(ns, **kw):
    defaults = dict(
        speed_monitor=ns.sm.SpeedMonitor(),
        metrics=ns.metrics.MetricsCollector(),
        node_manager=ns.nm.NodeManager(num_nodes=2),
        hang_threshold=1.0,
    )
    defaults.update(kw)
    return ns.diag.DiagnosisContext(**defaults)


# -- tests/test_diagnosis.py -------------------------------------------------


def hang_scenario(ns, clock):
    ctx = _ctx(ns)
    op = ns.diag.TrainingHangOperator()
    obs = [op.observe(ctx)]  # step 0: still initializing
    ctx.speed_monitor.collect_global_step(3, clock.time() - 50)
    obs.append(op.observe(ctx))
    ctx.speed_monitor.collect_global_step(4, clock.time())
    obs.append(op.observe(ctx))
    return obs


def test_hang_operator_fires_only_after_threshold(clock):
    obs = run_both(hang_scenario, clock)
    assert obs[0] == [] and obs[2] == []
    assert obs[1][0].action == t_diag.ActionType.RESTART_WORLD


def stall_scenario(ns, clock):
    ctx = _ctx(ns, resource_stale_s=10.0)
    ctx.metrics.collect(0, 10.0, 1.0, timestamp=clock.time() - 100)
    ctx.node_manager._nodes[1].relaunch_count = 2  # budget 3 -> suspect
    return ns.diag.InferenceChain(
        [ns.diag.ResourceStallOperator(), ns.diag.NodeFlappingOperator()]
    ).infer(ctx)


def test_resource_stall_and_flapping_report(clock):
    actions = run_both(stall_scenario, clock)
    kinds = {(a.action, a.node_id) for a in actions}
    assert (t_diag.ActionType.REPORT, 0) in kinds
    assert (t_diag.ActionType.REPORT, 1) in kinds


def cooldown_scenario(ns, clock):
    mgr = ns.diag.DiagnosisManager(cooldown_s=60.0)
    ctx = _ctx(ns)
    ctx.speed_monitor.collect_global_step(3, clock.time() - 50)
    first = mgr.run(ctx)
    second = mgr.run(ctx)  # still hung, but inside cooldown
    clock.advance(61.0)
    third = mgr.run(ctx)  # past the cooldown: fires again
    return [first, second, third]


def test_manager_cooldown_gates_remediation(clock):
    first, second, third = run_both(cooldown_scenario, clock)
    assert [a.action for a in first] == [t_diag.ActionType.RESTART_WORLD]
    assert second == [] and len(third) == 1


def roundtrip_scenario(ns, clock, tmp_path):
    path = str(tmp_path / f"{ns.jm.__name__}.json")
    master = ns.jm.JobMaster(num_nodes=2, min_nodes=1, state_path=path)
    try:
        rdzv = master.rdzv_managers["elastic-training"]
        for rank in (0, 1):
            rdzv.join_rendezvous(rank, 1)
        rdzv.update_rdzv_params(2, 2, waiting_timeout=0.1)
        rdzv.get_comm_world(0)  # seals round 1
        master.task_manager.create_dataset(
            ns.msg.DatasetShardParams(
                dataset_name="d", dataset_size=40, shard_size=10
            )
        )
        task = master.task_manager.get_task("d", node_id=0)
        master.task_manager.report_task("d", task.task_id, success=True)
        master.node_manager.ensure_node(1).relaunch_count = 2
        master.kv_store.put("coord", b"host:1234")
        master.speed_monitor.collect_global_step(17, clock.time())
        master._state_store.save(master)
    finally:
        master.stop()

    fresh = ns.jm.JobMaster(num_nodes=2, min_nodes=1, state_path=path)
    try:
        fresh.start()
        remaining = 0
        while True:
            t = fresh.task_manager.get_task("d", node_id=0)
            if t.empty:
                break
            remaining += 1
            fresh.task_manager.report_task("d", t.task_id, success=True)
        return {
            "round": fresh.rdzv_managers["elastic-training"]._rdzv_round,
            "remaining": remaining,
            "relaunch_count": fresh.node_manager.ensure_node(1).relaunch_count,
            "coord": fresh.kv_store.get("coord"),
            "global_step": fresh.speed_monitor.global_step,
            "optimizer": fresh.auto_scaler.optimizer is not None,
        }
    finally:
        fresh.stop()


def test_master_state_roundtrip(clock, tmp_path):
    got = run_both(roundtrip_scenario, clock, tmp_path)
    assert got["round"] >= 1 and got["remaining"] == 3
    assert got["relaunch_count"] == 2 and got["coord"] == b"host:1234"
    assert got["global_step"] == 17 and got["optimizer"]


def read_fault_scenario(ns, clock, tmp_path):
    path = str(tmp_path / f"{ns.jm.__name__}.json")
    master = ns.jm.JobMaster(num_nodes=1, min_nodes=1, state_path=path)
    try:
        master.speed_monitor.collect_global_step(9, clock.time())
        master._state_store.save(master)
    finally:
        master.stop()
    store = ns.ss.MasterStateStore(path)
    ns.faults.configure("storage.read:error@1", seed=2)
    try:
        first = store.load()
        fired = ("storage.read", "error", 1) in ns.faults.active().fired
        state = store.load()
        return {"first": first, "fired": fired,
                "global_step": state["global_step"]}
    finally:
        ns.faults.reset()


def test_state_load_under_storage_read_fault_starts_fresh(clock, tmp_path):
    got = run_both(read_fault_scenario, clock, tmp_path)
    assert got == {"first": None, "fired": True, "global_step": 9}


def fresh_scenario(ns, clock, tmp_path):
    master = ns.jm.JobMaster(
        num_nodes=1, state_path=str(tmp_path / "none.json"))
    try:
        master.start()
        return {"global_step": master.speed_monitor.global_step}
    finally:
        master.stop()


def test_master_restart_without_state_file_is_fresh(clock, tmp_path):
    assert run_both(fresh_scenario, clock, tmp_path) == {"global_step": 0}


def brain_scenario(ns, clock, tmp_path):
    path = str(tmp_path / f"{ns.brain.__name__}.json")
    brain = ns.brain.BrainService(path)
    obs = [brain.optimize(model_params=10**9, max_nodes=8)]
    for rec in (("gpt1b-a", 10**9, 8, 64, 8000, 0.6),
                ("gpt1b-b", 10**9, 4, 32, 6000, 0.95),
                ("tiny", 10**6, 1, 8, 100, 0.99)):
        name, params, nodes, batch, tps, goodput = rec
        brain.persist_metrics(ns.brain.JobRecord(
            name, model_params=params, num_nodes=nodes,
            global_batch_size=batch, tokens_per_sec=tps, goodput=goodput))
    obs.append(brain.optimize(model_params=1.2 * 10**9, max_nodes=8))
    fresh = ns.brain.BrainService(path)
    obs.append(fresh.get_job_metrics("gpt1b-a"))
    return obs


def test_brain_optimize_from_history(clock, tmp_path):
    default, plan, history = run_both(brain_scenario, clock, tmp_path)
    assert default.num_nodes == 8 and default.confidence == 0.0
    assert plan.num_nodes == 4 and plan.global_batch_size == 32
    assert plan.confidence > 0 and len(history) == 1


# -- the whole chain and its remediation -------------------------------------


def chain_scenario(ns, clock):
    """The default chain with every operator armed: a hang, a node that
    stopped reporting (upgraded to a relaunch), flapping, a straggler, a
    NaN and two spikes, an SDC minority streak and an HBM floor breach;
    then 8 slower steps (a step-time regression against the frozen
    baseline); then a third pass (the latches hold)."""
    sm = ns.sm.SpeedMonitor()
    metrics = ns.metrics.MetricsCollector()
    nm = ns.nm.NodeManager(num_nodes=3)
    timeline = ns.tl.JobTimeline()
    memory = ns.mem.MemoryLedger()

    def steps(first, last, fast, slow):
        for step in range(first, last + 1):
            for node in range(3):
                timeline.record(node, "step", kind="span",
                                duration_s=slow if node == 2 else fast,
                                attrs={"step": step})

    steps(1, 8, 0.1, 0.5)
    sm.collect_global_step(5, clock.time() - 400)
    metrics.collect(1, 10.0, 1.0, timestamp=clock.time() - 500)
    nm._nodes[0].relaunch_count = 2
    sm.record_anomaly(4, "nan@4:loss")
    sm.record_anomaly(5, "loss_spike@5:z=9")
    sm.record_anomaly(6, "grad_explosion@6:x")
    for step in range(2, 26, 2):
        for node in range(3):
            sm.record_digest(node, step, "bad" if node == 1 else "ok",
                             check_every=2)
    memory.record(2, bytes_in_use=970.0, peak_bytes=970.0,
                  limit_bytes=1000.0, headroom_frac=0.03,
                  pool_params_b=900.0)
    ctx = ns.diag.DiagnosisContext(
        speed_monitor=sm, metrics=metrics, node_manager=nm,
        hang_threshold=300.0, timeline=timeline, memory=memory)
    chain = ns.diag.InferenceChain()
    passes = [chain.infer(ctx)]
    steps(9, 16, 1.0, 1.0)
    passes.append(chain.infer(ctx))
    passes.append(chain.infer(ctx))
    return {"passes": passes,
            "names": [op.name for op in chain.operators],
            "regressions": timeline.counter("perf_regressions")}


def test_default_chain_every_operator(clock):
    got = run_both(chain_scenario, clock)
    first, second, third = got["passes"]
    assert len(got["names"]) == 8
    assert {t_diag.ActionType.RESTART_WORLD, t_diag.ActionType.RELAUNCH_NODE,
            t_diag.ActionType.QUARANTINE,
            t_diag.ActionType.REPORT} <= {a.action for a in first}
    assert got["regressions"] == 1
    assert any("regressed" in a.reason for a in second)
    # Latched operators (NaN, HBM, regression) stay quiet after firing.
    assert not any("regressed" in a.reason or "non-finite" in a.reason
                   or "HBM" in a.reason for a in third)


def remediation_scenario(ns, clock):
    """The master's ``_run_diagnosis``: a hang restarts the world (both
    rendezvous invalidated, the speed window reset); a persistent SDC
    minority quarantines the node (banned, evicted, the scaler told)."""
    master = ns.jm.JobMaster(num_nodes=3, hang_threshold=30.0,
                             heartbeat_timeout=3600.0)
    try:
        nm = master.node_manager
        rdzv = master.rdzv_managers["elastic-training"]
        for node in (0, 1, 2):
            nm.report_event(node, "started")
            rdzv.join_rendezvous(node, 1)
        rdzv.get_comm_world(0)
        master.memory_ledger.record(1, bytes_in_use=1.0, headroom_frac=0.5)
        master.speed_monitor.collect_global_step(3, clock.time() - 40)
        obs = {"cooldown": master.diagnosis.cooldown_s}
        master._run_diagnosis()
        obs["after_hang"] = {n: (m._rdzv_round, m._world_broken)
                             for n, m in master.rdzv_managers.items()}
        for step in range(2, 14, 2):
            for node in (0, 1, 2):
                master.speed_monitor.record_digest(
                    node, step, "bad" if node == 1 else "ok", check_every=2)
        clock.advance(31.0)
        master.speed_monitor.collect_global_step(20, clock.time())
        master._run_diagnosis()
        obs["quarantined"] = nm.quarantined()
        obs["statuses"] = nm.statuses()
        obs["banned"] = sorted(rdzv._banned)
        obs["memory_nodes"] = sorted(master.memory_ledger.per_node())
        obs["sdc"] = master.speed_monitor.sdc_ledger()
        obs["target"] = master.auto_scaler.target
        obs["reports"] = master.diagnosis.reports
        return obs
    finally:
        master.stop()


def test_master_executes_the_chain(clock):
    got = run_both(remediation_scenario, clock)
    assert got["cooldown"] == 30.0
    assert got["after_hang"]["elastic-training"] == (1, True)
    assert list(got["quarantined"]) == [1] and got["banned"] == [1]
    assert got["memory_nodes"] == []


def test_hang_threshold_outlasts_the_chip_runs_restart():
    """``chip_smoke.py``'s ``elastic_run`` builds its master with
    ``hang_threshold`` from its spec (about 2.5x the slowest restart gap
    measured on the card): it must stay at least twice that gap, or the
    chain would restart the world in the middle of the agent's own
    restart."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    try:
                        consts[target.id] = ast.literal_eval(node.value)
                    except (ValueError, TypeError, SyntaxError):
                        pass
    threshold = consts["ELASTIC_HANG_THRESHOLD"]
    gap = consts["ELASTIC_SLOWEST_RESTART_S"]
    assert threshold >= 2 * gap
    # The operator itself: no progress for the slowest gap is no hang.
    sm = t_sm.SpeedMonitor()
    ctx = t_diag.DiagnosisContext(speed_monitor=sm, metrics=None,
                                  node_manager=None,
                                  hang_threshold=threshold)
    import time

    sm.collect_global_step(10, time.time() - gap)
    assert t_diag.TrainingHangOperator().observe(ctx) == []


def restart_gap_scenario(ns, clock):
    """A job older than the hang threshold (90 s of steps), then a crash:
    the running speed is reset, and the restarted trainer replays steps it
    had reached before (no advance) 25 s later.  Then 61 s more without
    an advance."""
    sm = ns.sm.SpeedMonitor()
    ctx = _ctx(ns, speed_monitor=sm, hang_threshold=60.0)
    op = ns.diag.TrainingHangOperator()
    for step in range(1, 11):
        clock.advance(9.0)
        sm.collect_global_step(step, clock.time())
    sm.reset_running_speed()  # the failure report of the crash
    clock.advance(25.0)
    sm.collect_global_step(9, clock.time())  # replayed: not an advance
    obs = {"gap": op.observe(ctx)}
    clock.advance(36.0)
    obs["past"] = op.observe(ctx)
    return obs


def test_restart_gap_is_not_a_hang_in_an_old_job(clock):
    """ROADMAP Queue 3 item 18: after a reset of the running speed the
    reference measures "no progress" from the job's start, so in a job
    older than ``hang_threshold`` every restart reads as a hang and the
    chain restarts the world in the middle of it.  The port measures from
    the reset; a real stall past the threshold still fires."""
    clock.now = T0
    ref = restart_gap_scenario(REF, clock)
    clock.now = T0
    port = restart_gap_scenario(PORT, clock)
    assert [a.action for a in ref["gap"]] == [
        j_diag.ActionType.RESTART_WORLD]
    assert "115s" in ref["gap"][0].reason  # the job's age, not the gap
    assert port["gap"] == []
    assert [a.action for a in port["past"]] == [
        t_diag.ActionType.RESTART_WORLD]
    assert "61s" in port["past"][0].reason

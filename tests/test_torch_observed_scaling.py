"""The port's running-job optimizer, its scaler wiring and the cloud
launcher against the reference's.

Each case is ``tests/test_observed_scaling.py``'s (the same names, inputs
and assertions), run as a scenario on both packages; the two records must
agree exactly (plans, reasons, launcher calls, VM states, node statuses),
floats within ``FLOAT_RTOL`` (1e-12 relative).  The optimizer's cases run
under one fake clock patched into both packages' ``brain`` and
``speed_monitor``; the launcher's cases run its creator thread on the real
clock and record only what the thread's timing cannot move.
"""

import time
import types

import pytest

from dlrover_tpu.master import auto_scaler as j_as
from dlrover_tpu.master import brain as j_brain
from dlrover_tpu.master import cloud_launcher as j_cloud
from dlrover_tpu.master import job_master as j_jm
from dlrover_tpu.master import node_manager as j_nm
from dlrover_tpu.master import speed_monitor as j_sm
from dlrover_tpu_torch.master import auto_scaler as t_as
from dlrover_tpu_torch.master import brain as t_brain
from dlrover_tpu_torch.master import cloud_launcher as t_cloud
from dlrover_tpu_torch.master import job_master as t_jm
from dlrover_tpu_torch.master import node_manager as t_nm
from dlrover_tpu_torch.master import speed_monitor as t_sm
from test_torch_master_parity import T0, FakeClock, assert_same

REF = types.SimpleNamespace(
    scaler=j_as, brain=j_brain, cloud=j_cloud, jm=j_jm, nm=j_nm, sm=j_sm)
PORT = types.SimpleNamespace(
    scaler=t_as, brain=t_brain, cloud=t_cloud, jm=t_jm, nm=t_nm, sm=t_sm)


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    for ns in (REF, PORT):
        for mod in (ns.brain, ns.sm):
            monkeypatch.setattr(mod, "time", c)
    return c


def run_both(scenario, clock=None):
    if clock is not None:
        clock.now = T0
    want = scenario(REF)
    if clock is not None:
        clock.now = T0
    got = scenario(PORT)
    assert want, "the scenario recorded nothing"
    assert_same(got, want)
    return got


def _feed(ns, opt, nodes, speeds):
    for s in speeds:
        opt.observe(ns.brain.Observation(num_nodes=nodes, speed=s))


# -- RunningJobOptimizer (pure policy) ----------------------------------------


def test_optimizer_explores_up_after_stable_readings(clock):
    def scenario(ns):
        opt = ns.brain.RunningJobOptimizer(patience=3)
        _feed(ns, opt, 2, [10.0, 10.5, 10.2])
        return [opt.recommend(current_nodes=2, min_nodes=1, max_nodes=4,
                              node_unit=1)]

    [plan] = run_both(scenario, clock)
    assert plan.num_nodes == 3 and "exploring" in plan.reason


def test_optimizer_retreats_when_uplift_too_small(clock):
    def scenario(ns):
        opt = ns.brain.RunningJobOptimizer(uplift_threshold=1.1, patience=3)
        _feed(ns, opt, 2, [10.0, 10.0, 10.0])
        _feed(ns, opt, 3, [10.4, 10.5, 10.4])
        return [opt.recommend(current_nodes=3, min_nodes=1, max_nodes=4)]

    [plan] = run_both(scenario, clock)
    assert plan.num_nodes == 2 and "wasted" in plan.reason


def test_optimizer_retreat_gated_on_samples(clock):
    def scenario(ns):
        opt = ns.brain.RunningJobOptimizer(uplift_threshold=1.1, patience=3)
        _feed(ns, opt, 2, [10.0, 10.0, 10.0])
        _feed(ns, opt, 3, [6.0])
        return [opt.recommend(current_nodes=3, min_nodes=1, max_nodes=4)]

    [plan] = run_both(scenario, clock)
    assert plan.num_nodes == 3


def test_optimizer_keeps_config_when_uplift_real(clock):
    def scenario(ns):
        opt = ns.brain.RunningJobOptimizer(uplift_threshold=1.1, patience=3)
        _feed(ns, opt, 2, [10.0, 10.0, 10.0])
        _feed(ns, opt, 3, [14.5, 14.8, 14.6])
        _feed(ns, opt, 4, [19.0, 19.5, 19.2])
        return [opt.recommend(current_nodes=4, min_nodes=1, max_nodes=4)]

    [plan] = run_both(scenario, clock)
    assert plan.num_nodes == 4


def test_optimizer_flags_sustained_degradation(clock):
    def scenario(ns):
        opt = ns.brain.RunningJobOptimizer(degrade_threshold=0.7, patience=2)
        _feed(ns, opt, 4, [20.0, 20.0, 20.0])
        _feed(ns, opt, 4, [5.0, 5.0])
        plans = [opt.recommend(4, 1, 4)]
        _feed(ns, opt, 4, [19.5])
        plans.append(opt.recommend(4, 1, 4))
        return plans

    first, second = run_both(scenario, clock)
    assert first.num_nodes == 4 and "degraded" in first.reason
    assert "degraded" not in second.reason


def test_optimizer_reexplores_stale_size(clock):
    def scenario(ns):
        opt = ns.brain.RunningJobOptimizer(patience=3, stale_after_s=100.0)
        old = clock.time() - 500.0
        opt.observe(ns.brain.Observation(num_nodes=3, speed=4.0,
                                         timestamp=old))
        _feed(ns, opt, 2, [10.0, 10.1, 10.0])
        return [opt.recommend(current_nodes=2, min_nodes=1, max_nodes=4)]

    [plan] = run_both(scenario, clock)
    assert plan.num_nodes == 3 and "stale" in plan.reason


def test_optimizer_fresh_measured_size_not_reexplored(clock):
    def scenario(ns):
        opt = ns.brain.RunningJobOptimizer(patience=3, stale_after_s=100.0)
        _feed(ns, opt, 3, [4.0, 4.1, 4.0])
        _feed(ns, opt, 2, [10.0, 10.1, 10.0])
        return [opt.recommend(current_nodes=2, min_nodes=1, max_nodes=4)]

    [plan] = run_both(scenario, clock)
    assert plan.num_nodes == 2


# -- JobAutoScaler integration: plans from observation, no set_target --------


class RecordingLauncher:
    def __init__(self):
        self.launched, self.deleted = [], []

    def launch(self, node_id):
        self.launched.append(node_id)

    def delete(self, node_id):
        self.deleted.append(node_id)


def test_scaler_retires_node_from_observation_only(clock):
    def scenario(ns):
        launcher = RecordingLauncher()
        nm = ns.nm.NodeManager(num_nodes=3, launcher=launcher)
        for n in range(3):
            nm.report_event(n, "started")
        sm = ns.sm.SpeedMonitor()
        opt = ns.brain.RunningJobOptimizer(uplift_threshold=1.1)
        scaler = ns.scaler.JobAutoScaler(
            nm, sm, min_nodes=1, max_nodes=3, cooldown_s=0.0,
            optimizer=opt, optimize_interval_s=0.0,
        )
        _feed(ns, opt, 2, [10.0, 10.0, 10.0])
        _feed(ns, opt, 3, [10.3, 10.3])
        now = clock.time()
        for i in range(6):
            sm.collect_global_step(i + 1, timestamp=now + i, tokens=100)
        plan = scaler.step()
        return {"plan": plan, "deleted": launcher.deleted,
                "target": scaler.target}

    got = run_both(scenario, clock)
    assert got["plan"].delete == [2] and got["deleted"] == [2]
    assert got["target"] == 2


def test_scaler_dead_node_repair_needs_no_target(clock):
    def scenario(ns):
        launcher = RecordingLauncher()
        nm = ns.nm.NodeManager(num_nodes=2, launcher=launcher)
        for n in range(2):
            nm.report_event(n, "started")
        scaler = ns.scaler.JobAutoScaler(
            nm, ns.sm.SpeedMonitor(), min_nodes=1, max_nodes=2,
            cooldown_s=0.0, optimizer=ns.brain.RunningJobOptimizer(),
            optimize_interval_s=3600.0,
        )
        nm._nodes[1].status = ns.nm.NodeStatus.DEAD
        return {"plan": scaler.step(), "launched": launcher.launched}

    got = run_both(scenario, clock)
    assert got["plan"].launch == [1] and got["launched"] == [1]


# -- Cloud launcher against the fake TPU-VM API ------------------------------


def _drain(launcher, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not launcher._queue.empty() and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.1)  # let the in-flight create finish


def _vms(client):
    return {name: {k: v for k, v in inst.items() if k != "created_at"}
            for name, inst in sorted(client.instances.items())}


def test_cloud_launch_join_retire_cycle():
    def scenario(ns):
        client = ns.cloud.FakeTpuVmClient()
        launcher = ns.cloud.CloudNodeLauncher(
            client, job_name="job", master_addr="10.0.0.2:50051")
        master = ns.jm.JobMaster(num_nodes=2, launcher=launcher,
                                 auto_scale=True, min_nodes=1,
                                 heartbeat_timeout=3600.0)
        try:
            nm = master.node_manager
            master.bootstrap_nodes()
            _drain(launcher)
            obs = {"creates": sorted(client.create_calls),
                   "states": launcher.reconcile(), "vms": _vms(client)}
            elastic = list(master.rdzv_managers.values())[0]
            for n in range(2):
                nm.report_event(n, "started")
                elastic.join_rendezvous(n, 1)
            obs["world"] = sorted(elastic.get_comm_world(0)[2])
            master.auto_scaler.set_target(1, reason="test")
            obs["plan"] = master.auto_scaler.step()
            obs["deletes"] = client.delete_calls
            obs["alive"] = sorted(elastic._alive_nodes)
            return obs
        finally:
            master.stop()
            launcher.shutdown()

    got = run_both(scenario)
    assert got["creates"] == ["job-worker-0", "job-worker-1"]
    assert got["states"] == {0: "READY", 1: "READY"}
    assert got["vms"]["job-worker-0"]["metadata"]["dlrover-node-id"] == "0"
    assert got["world"] == [0, 1] and got["plan"].delete == [1]
    assert got["deletes"] == ["job-worker-1"] and 1 not in got["alive"]


def test_cloud_preemption_reconciles_to_node_death_and_relaunch():
    def scenario(ns):
        client = ns.cloud.FakeTpuVmClient()
        launcher = ns.cloud.CloudNodeLauncher(client, job_name="job")
        master = ns.jm.JobMaster(num_nodes=2, launcher=launcher,
                                 auto_scale=True, heartbeat_timeout=3600.0)
        try:
            nm = master.node_manager
            master.bootstrap_nodes()
            _drain(launcher)
            for n in range(2):
                nm.report_event(n, "started")
            client.preempt("job-worker-1")
            master._reconcile_cloud()
            _drain(launcher)
            return {"creates": client.create_calls.count("job-worker-1"),
                    "state": client.get_node("job-worker-1")["state"],
                    "statuses": nm.statuses()}
        finally:
            master.stop()
            launcher.shutdown()

    got = run_both(scenario)
    assert got["creates"] >= 2 and got["state"] in ("CREATING", "READY")


def test_pending_node_preempted_before_startup_is_failed():
    def scenario(ns):
        client = ns.cloud.FakeTpuVmClient()
        launcher = ns.cloud.CloudNodeLauncher(client, job_name="job")
        launcher.LANDED_SETTLE_S = 0.0
        master = ns.jm.JobMaster(num_nodes=1, launcher=launcher,
                                 auto_scale=True, heartbeat_timeout=3600.0)
        try:
            master.bootstrap_nodes()
            _drain(launcher)
            obs = {"current": launcher.vm_is_current(0),
                   "before": master.node_manager.statuses()}
            client.preempt("job-worker-0")
            master._reconcile_cloud()
            obs["one_tick"] = master.node_manager.statuses()
            master._reconcile_cloud()
            _drain(launcher)
            obs["creates"] = client.create_calls.count("job-worker-0")
            obs["state"] = client.get_node("job-worker-0")["state"]
            before = dict(master.node_manager.statuses())
            master._reconcile_cloud()
            obs["steady"] = master.node_manager.statuses() == before
            obs["relaunches"] = master.node_manager.ensure_node(
                0).relaunch_count
            return obs
        finally:
            master.stop()
            launcher.shutdown()

    got = run_both(scenario)
    assert got["current"] and got["one_tick"] == {0: "pending"}
    assert got["creates"] >= 2 and got["steady"]


def test_stale_dead_vm_of_relaunching_node_is_ignored():
    def scenario(ns):
        client = ns.cloud.FakeTpuVmClient()
        launcher = ns.cloud.CloudNodeLauncher(client, job_name="job")
        master = ns.jm.JobMaster(num_nodes=1, launcher=launcher,
                                 auto_scale=True, heartbeat_timeout=3600.0)
        try:
            master.bootstrap_nodes()
            _drain(launcher)
            client.preempt("job-worker-0")
            with launcher._wanted_mu:
                launcher._generation[0] += 1
            before = master.node_manager.ensure_node(0).relaunch_count
            for _ in range(3):
                master._reconcile_cloud()
            return {"current": launcher.vm_is_current(0),
                    "relaunches": [before, master.node_manager.ensure_node(
                        0).relaunch_count]}
        finally:
            master.stop()
            launcher.shutdown()

    got = run_both(scenario)
    assert not got["current"] and got["relaunches"][0] == got["relaunches"][1]


def test_cloud_create_retry_then_gives_up_into_hook():
    def scenario(ns):
        client = ns.cloud.FakeTpuVmClient()
        failed = []
        launcher = ns.cloud.CloudNodeLauncher(
            client, job_name="job",
            node_failed_hook=lambda nid, why: failed.append((nid, why)),
        )
        launcher.RETRY_BACKOFF_S = 0.01
        try:
            client.fail_next(2)
            launcher.launch(0)
            _drain(launcher)
            obs = {"state": client.get_node("job-worker-0")["state"],
                   "failed_early": list(failed)}
            client.fail_next(10)
            launcher.launch(1)
            deadline = time.monotonic() + 5
            while not failed and time.monotonic() < deadline:
                time.sleep(0.02)
            obs["failed"] = failed
            return obs
        finally:
            launcher.shutdown()

    got = run_both(scenario)
    assert got["state"] == "READY" and not got["failed_early"]
    assert got["failed"][0][0] == 1
    assert "RESOURCE_EXHAUSTED" in got["failed"][0][1]


def test_master_control_loop_scales_from_observation():
    def scenario(ns):
        launcher = RecordingLauncher()
        master = ns.jm.JobMaster(
            num_nodes=3, min_nodes=1, launcher=launcher,
            heartbeat_timeout=3600.0, optimize_interval_s=0.2,
        )
        master.CONTROL_LOOP_INTERVAL = 0.1
        obs = {"optimizer": master.auto_scaler.optimizer is not None}
        master.auto_scaler.cooldown_s = 0.0
        try:
            for n in range(3):
                master.node_manager.report_event(n, "started")
            _feed(ns, master.auto_scaler.optimizer, 2, [10.0, 10.0, 10.0])
            master.start()
            now = time.time()
            deadline = time.monotonic() + 10
            step = 0
            while time.monotonic() < deadline and not launcher.deleted:
                step += 1
                master.speed_monitor.collect_global_step(
                    step, timestamp=now + step, tokens=100
                )
                time.sleep(0.05)
            obs["deleted"] = launcher.deleted
            obs["target"] = master.auto_scaler.target
            obs["reasons"] = [p.reason for p in master.auto_scaler.plans]
            return obs
        finally:
            master.stop()

    got = run_both(scenario)
    assert got["optimizer"] and got["deleted"] == [2]
    assert got["target"] == 2 and got["reasons"] == ["live 3 > target 2"]


def test_persistent_stockout_fails_job_instead_of_wedging():
    def scenario(ns):
        client = ns.cloud.FakeTpuVmClient()
        client.fail_next(10**6)
        launcher = ns.cloud.CloudNodeLauncher(client, job_name="job")
        launcher.RETRY_BACKOFF_S = 0.01
        master = ns.jm.JobMaster(num_nodes=1, launcher=launcher,
                                 max_relaunches=2, heartbeat_timeout=3600.0)
        try:
            obs = {"hooked": launcher.node_failed_hook is not None}
            master.bootstrap_nodes()
            deadline = time.monotonic() + 10
            while not master.node_manager.job_failed and (
                time.monotonic() < deadline
            ):
                time.sleep(0.05)
            obs["failed"] = master.node_manager.job_failed
            obs["reason"] = master.node_manager.job_failure_reason
            return obs
        finally:
            master.stop()
            launcher.shutdown()

    got = run_both(scenario)
    assert got["hooked"] and got["failed"]
    assert "restarts" in got["reason"] or "exceeded" in got["reason"]

"""The port's master ledgers and servicer against the reference's.

Each scenario drives one master module of a package with the same
scripted inputs (joins and leaves, failures at each level, shard requests
across nodes, recoveries and timeouts, step reports, telemetry events)
under one fake clock patched into both packages' modules, and records
what the module answers.  The two records must agree: exactly for state
(rounds, worlds, ranks, shard ranges, actions, phases, counts), within
1e-12 relative for floats (throughput, goodput, ratios).

The servicer's parity sends one sequence of envelopes through the
reference's ``MasterServicer.report/get`` in process and through the
port's over its TCP transport, and compares the responses as
``dataclasses.asdict``.
"""

import dataclasses
import enum
import json
import math
import socket
import types

import pytest

from dlrover_tpu.master import calibration as j_cal
from dlrover_tpu.master import job_master as j_jm
from dlrover_tpu.master import kv_store as j_kv
from dlrover_tpu.master import memory_ledger as j_mem
from dlrover_tpu.master import messages as j_msg
from dlrover_tpu.master import metrics as j_metrics
from dlrover_tpu.master import node_manager as j_nm
from dlrover_tpu.master import rdzv_manager as j_rdzv
from dlrover_tpu.master import speed_monitor as j_sm
from dlrover_tpu.master import sync_service as j_sync
from dlrover_tpu.master import task_manager as j_tm
from dlrover_tpu.master import timeline as j_tl
from dlrover_tpu_torch.master import calibration as t_cal
from dlrover_tpu_torch.master import job_master as t_jm
from dlrover_tpu_torch.master import kv_store as t_kv
from dlrover_tpu_torch.master import memory_ledger as t_mem
from dlrover_tpu_torch.master import messages as t_msg
from dlrover_tpu_torch.master import metrics as t_metrics
from dlrover_tpu_torch.master import node_manager as t_nm
from dlrover_tpu_torch.master import rdzv_manager as t_rdzv
from dlrover_tpu_torch.master import speed_monitor as t_sm
from dlrover_tpu_torch.master import sync_service as t_sync
from dlrover_tpu_torch.master import task_manager as t_tm
from dlrover_tpu_torch.master import timeline as t_tl
from dlrover_tpu_torch.master.servicer import GET, REPORT, recv_frame, send_frame

REF = types.SimpleNamespace(
    cal=j_cal, jm=j_jm, kv=j_kv, mem=j_mem, msg=j_msg, metrics=j_metrics,
    nm=j_nm, rdzv=j_rdzv, sm=j_sm, sync=j_sync, tm=j_tm, tl=j_tl)
PORT = types.SimpleNamespace(
    cal=t_cal, jm=t_jm, kv=t_kv, mem=t_mem, msg=t_msg, metrics=t_metrics,
    nm=t_nm, rdzv=t_rdzv, sm=t_sm, sync=t_sync, tm=t_tm, tl=t_tl)
FLOAT_RTOL = 1e-12
T0 = 1_700_000_000.0


class FakeClock:
    """``time.time``/``time.monotonic`` of every patched module."""

    def __init__(self):
        self.now = T0

    def time(self):
        return self.now

    def monotonic(self):
        return self.now - T0 + 1000.0

    def sleep(self, seconds):
        self.now += seconds

    def advance(self, seconds):
        self.now += seconds


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    for ns in (REF, PORT):
        for mod in (ns.kv, ns.metrics, ns.rdzv, ns.nm, ns.tm, ns.sm):
            monkeypatch.setattr(mod, "time", c)
    return c


def _plain(x):
    """Dataclasses as dicts, enums as their values, tuples as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def assert_same(got, want, path="$"):
    got, want = _plain(got), _plain(want)
    if isinstance(want, float) and isinstance(got, (int, float)) and not (
            isinstance(got, bool)):
        assert math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=0.0) or (
            got == want), f"{path}: {got!r} != {want!r}"
    elif isinstance(want, dict):
        assert isinstance(got, dict), f"{path}: {got!r} is not a dict"
        assert set(got) == set(want), f"{path}: keys {set(got) ^ set(want)}"
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (
            f"{path}: {got!r} != {want!r}")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want and type(got) is type(want), (
            f"{path}: {got!r} != {want!r}")


def run_both(scenario, clock):
    """``scenario(ns, clock)`` on each package from the same clock."""
    clock.now = T0
    want = scenario(REF, clock)
    clock.now = T0
    got = scenario(PORT, clock)
    assert want, "the scenario recorded nothing"
    assert_same(got, want)
    return got


# -- rendezvous ----------------------------------------------------------------


def rdzv_scenario(ns, clock):
    obs = []
    m = ns.rdzv.ElasticTrainingRendezvousManager()
    m.update_rdzv_params(min_nodes=2, max_nodes=4, waiting_timeout=5.0,
                         node_unit=2)
    for rank in (0, 1, 2):
        obs.append(("join", rank, m.join_rendezvous(rank, 8)))
    obs.append(("forming", m.get_comm_world(0), m.num_nodes_waiting()))
    clock.advance(6.0)  # the window lapses: 3 waiting -> a world of 2
    obs.append(("lapsed", [m.get_comm_world(r) for r in (0, 1, 2)],
                m.num_nodes_waiting(), m.world_changed(0), m.world_changed(1)))
    obs.append(("scale_up_join", m.join_rendezvous(3, 8),
                m.num_nodes_waiting(), m.world_changed(1)))
    m.remove_alive_node(1)  # a member dies: the world breaks
    obs.append(("broken", m.world_changed(1), m.get_comm_world(0)))
    m.join_rendezvous(0, 8)
    obs.append(("rejoined", m.get_comm_world(0), m.num_nodes_waiting()))
    clock.advance(6.0)
    obs.append(("resealed", [m.get_comm_world(r) for r in (0, 2, 3)],
                m.world_changed(1), m.world_changed(2)))
    m.ban_node(3)
    obs.append(("banned", m.join_rendezvous(3, 8), m.num_nodes_waiting(),
                m.world_changed(2)))
    m.invalidate_world()
    for rank in (0, 1, 2, 4, 5):
        m.join_rendezvous(rank, 4)  # max 4 reached: seals at once
    obs.append(("full", [m.get_comm_world(r) for r in (0, 1, 2, 4, 5)],
                m.num_nodes_waiting()))

    n = ns.rdzv.NetworkCheckRendezvousManager()
    n.update_rdzv_params(5, 5, 60.0, 1)
    for rank in range(5):
        n.join_rendezvous(rank, 4)
    obs.append(("pairs", [n.get_comm_world(r) for r in range(5)]))
    for rank, (ok, t) in enumerate([(True, 1.0), (True, 1.2), (False, 0.9),
                                    (True, 4.0), (False, 1.1)]):
        n.report_network_status(rank, ok, t)
    obs.append(("faults", n.check_fault_node(), n.get_stragglers(),
                n._group_nodes(1)))
    for rank in range(5):
        n.join_rendezvous(rank, 4)
    obs.append(("bisect", [n.get_comm_world(r) for r in range(5)]))
    n.report_network_status(2, True, 1.0)
    obs.append(("after", n.check_fault_node(), n.get_stragglers()))
    return obs


def test_rendezvous_ledgers_match(clock):
    run_both(rdzv_scenario, clock)


# -- nodes -----------------------------------------------------------------------


def node_scenario(ns, clock):
    obs, calls, moves = [], [], []

    class Launcher:
        def launch(self, node_id):
            calls.append(("launch", node_id))

        def delete(self, node_id):
            calls.append(("delete", node_id))

    nm = ns.nm.NodeManager(num_nodes=3, launcher=Launcher(),
                           max_relaunches=2, heartbeat_timeout=10.0,
                           pools={"aux": 2})
    nm.add_callback(lambda n, old, new: moves.append((n, old, new)))
    nm.report_event(0, "started")
    nm.report_heartbeat(1, clock.time())
    nm.report_event(2, "started")
    obs.append(("statuses", nm.statuses(), nm.statuses(pool="aux")))
    for level, code in (("process", 137), ("process", 1), ("node", 1)):
        obs.append(("failure", level, nm.report_failure(1, "x", code, level)))
    obs.append(("budget", nm.relaunchable(1), nm.job_failed))
    clock.advance(11.0)
    nm.report_heartbeat(2, clock.time())
    obs.append(("dead", nm.check_heartbeats(), nm.statuses()))
    obs.append(("launch", nm.launch_node(0), nm.launch_node(1),
                nm.launch_node(10_000, bootstrap=True)))
    new_id = nm.migrate(10_000)
    obs.append(("migrate", new_id, nm.statuses(pool="aux")))
    nm.report_event(new_id, "started")
    obs.append(("migrated", nm.statuses(pool="aux"), nm.pool_of(new_id),
                nm.pool_of(20_000)))
    nm.quarantine(2, "sdc")
    obs.append(("quarantine", nm.is_quarantined(2), nm.quarantined(),
                nm.relaunchable(2), nm.force_relaunch(2),
                nm.launch_node(2)))
    obs.append(("force", nm.force_relaunch(0), nm.force_relaunch(0),
                nm.force_relaunch(0)))
    nm.retire_node(1)
    nm.report_event(0, "succeeded")
    obs.append(("end", nm.statuses(), nm.snapshot(), nm.all_succeeded(),
                nm.job_failed, nm.job_failure_reason))
    obs.append(("job", nm.report_failure(0, "fatal", 1, "job"),
                nm.job_failed, nm.job_failure_reason))
    obs.append(("calls", calls, moves))
    return obs


def test_node_ledgers_match(clock):
    run_both(node_scenario, clock)


# -- shards ----------------------------------------------------------------------


def task_scenario(ns, clock):
    obs = []
    P = ns.msg.DatasetShardParams
    tm = ns.tm.TaskManager()
    tm.create_dataset(P("table", 100, 30))
    tm.create_dataset(P("shuffled", 50, 10, num_epochs=2, shuffle=True))
    tm.create_dataset(P("text", 40, 8, storage_type="text", shuffle=True))
    tm.create_dataset(P("huge", 1000, 10, max_shard_count=8))
    tm.create_dataset(P("table", 7, 7))  # a second create is a no-op
    for name in ("table", "shuffled", "text", "huge"):
        got = [tm.get_task(name, node) for node in (0, 1, 2, 0, 1)]
        obs.append(("tasks", name, got))
        obs.append(("report", tm.report_task(name, got[0].task_id, True),
                    tm.report_task(name, got[1].task_id, False),
                    tm.report_task(name, 999, True)))
    tm.recover_tasks(1)
    obs.append(("recovered", [tm.get_task("table", 2) for _ in range(2)]))
    clock.advance(1801.0)
    obs.append(("progress", tm.worker_progressing(window=600.0)))
    tm.reassign_timeout_tasks()
    obs.append(("timed_out", [tm.get_task("shuffled", 3) for _ in range(3)],
                tm.worker_progressing(window=600.0)))
    ckpt = tm.checkpoint("text")
    obs.append(("ckpt", ckpt.dataset_name, json.loads(ckpt.content)))
    tm.restore(ckpt)
    obs.append(("restored", [tm.get_task("text", 0) for _ in range(3)]))
    drained = {}
    for name in ("table", "shuffled", "text", "huge"):
        seen = []
        while True:
            task = tm.get_task(name, 0)
            if task.empty:
                break
            seen.append((task.start, task.end, task.epoch,
                         task.record_indices))
            tm.report_task(name, task.task_id, True)
        drained[name] = seen
    obs.append(("drained", drained, tm.finished("table"),
                tm.finished("huge"), tm.get_task("missing", 0)))
    return obs


def test_task_ledgers_match(clock):
    run_both(task_scenario, clock)


# -- speed, goodput, the serve/embed/moe/SDC/resize/compile/fault ledgers --------


def speed_scenario(ns, clock):
    obs = []
    sm = ns.sm.SpeedMonitor()
    for step in range(1, 9):
        clock.advance(0.37 * step)
        sm.collect_global_step(step, clock.time(), tokens=4096)
        sm.record_loss(step, 3.0 - 0.1 * step)
    sm.collect_global_step(5, clock.time())  # stale: ignored
    obs.append(("speed", sm.running_speed(), sm.token_throughput(),
                sm.goodput(), sm.global_step, sm.no_progress_for(),
                sm.recent_losses(3)))
    sm.record_anomaly(7, "nan@7:loss=nan")
    sm.record_compile(12.5)
    sm.record_compile(3.25, restart=True)
    sm.record_compile(0.0, cached=True)
    sm.record_fault("rpc.report", "delay", 0.2)
    sm.record_fault("storage.write", "error")
    sm.reset_running_speed()
    clock.advance(20.0)
    sm.begin_resize(reason="preempt:1")
    sm.begin_resize(reason="preempt:2")
    clock.advance(4.0)
    obs.append(("open", sm.resize_ledger()))
    sm.collect_global_step(9, clock.time(), tokens=4096)
    sm.record_relayout(1.5)
    sm.record_relayout(2.5, ok=False)
    for node, (qps, p95) in enumerate([(10.0, 0.2), (12.0, 0.4)]):
        sm.record_serve(node, qps=qps, p50_s=p95 / 2, p95_s=p95,
                        occupancy=0.5, slots=8, requests=100, tokens=900,
                        p95_n=40, unknown_attr=1)
    sm.record_swap(0, version=3, ok=True, seconds=0.8)
    sm.record_swap(1, version=2, ok=False, rolled_back=True, seconds=0.3)
    sm.evict_serve(1)
    sm.record_embed(0, world=4, rows_owned=100, rows_owned_max=120,
                    lookups=5000, hit_rate=0.75, rows_per_s=1e6)
    sm.record_moe(0, step=9, entropy=1.2, drop_fraction=0.01, experts=4,
                  top_k=2, load=json.dumps([0.25, 0.2, 0.3, 0.25]))
    sm.record_moe(1, step=9, entropy=1.0, drop_fraction=0.03, experts=4,
                  top_k=2, load=[0.1, 0.4, 0.3, 0.2])
    for step in (2, 4, 6, 8, 10):
        sm.record_digest(0, step, f"d{step}", check_every=2)
        sm.record_digest(1, step, f"d{step}")
        sm.record_digest(2, step, "bad" if step >= 4 else f"d{step}")
    sm.record_sdc_quarantine(2)
    clock.advance(3.0)
    obs.append(("ledgers", sm.recent_anomalies(), sm.compile_ledger(),
                sm.fault_ledger(), sm.resize_ledger(), sm.serve_ledger(),
                sm.embed_ledger(), sm.moe_ledger(), sm.sdc_ledger(),
                sm.goodput(), sm.running_speed(), sm.serve_state(),
                sm.embed_state(), sm.resize_state()))
    fresh = ns.sm.SpeedMonitor()
    fresh.restore_serve_state(sm.serve_state())
    fresh.restore_embed_state(sm.embed_state())
    fresh.restore_resize_state(sm.resize_state())
    obs.append(("restored", fresh.serve_ledger(), fresh.embed_ledger(),
                fresh.resize_ledger()))
    return obs


def test_speed_and_goodput_ledgers_match(clock):
    run_both(speed_scenario, clock)


# -- kv store, sync service, metrics ---------------------------------------------


def store_scenario(ns, clock):
    obs = []
    kv = ns.kv.KVStore()
    kv.put("rdzv/a", b"1")
    kv.put("rdzv/b", b"2")
    obs.append(("kv", kv.get("rdzv/a"), kv.get("nope"), kv.add("n"),
                kv.add("n", 5), kv.wait("rdzv/b", 0.0), kv.wait("x", 0.0),
                kv.delete("rdzv/a"), kv.delete("rdzv/a")))
    kv.clear_prefix("rdzv/")
    obs.append(("kv_after", kv.snapshot()))

    sync = ns.sync.SyncService()
    obs.append(("sync", sync.join_sync("init", 0, 3),
                sync.join_sync("init", 1, 3), sync.sync_finished("init"),
                sync.join_sync("ckpt", 0, 2)))
    sync.remove_node(2)  # init shrinks to 2: complete
    obs.append(("shrunk", sync.sync_finished("init"),
                sync.sync_finished("ckpt"), sync.join_sync("init", 5, 3)))
    obs.append(("version", sync.update_local_version(0, 3, expected=2),
                sync.update_local_version(1, 2, expected=2),
                sync.get_global_version(),
                sync.update_local_version(1, 5, expected=2)))
    sync.remove_node(1)
    obs.append(("version_after", sync.update_local_version(0, 7),
                sync.get_global_version()))

    mc = ns.metrics.MetricsCollector()
    for i in range(150):
        clock.advance(2.0)
        for node in (0, 1):
            mc.collect(node, 10.0 + i + node, 2.0 + node, 1.5 * node,
                       0.1 * node, timestamp=clock.time() - node * 100,
                       device_mem_max_gb=0.5, device_util_max=0.2 * node)
    mc.collect(2, 50.0, 1.0)
    obs.append(("metrics", mc.nodes(), mc.latest(0), mc.latest(1),
                mc.mean_cpu(window_s=60.0), mc.stale_nodes(30.0)))
    mc.evict(1)
    obs.append(("evicted", mc.nodes(), mc.latest(1)))
    return obs


def test_kv_sync_and_metrics_match(clock):
    run_both(store_scenario, clock)


# -- the timeline and its exposition ---------------------------------------------


def timeline_scenario(ns, clock):
    obs = []
    tl = ns.tl.JobTimeline()
    for node in (0, 1, 2):
        events = []
        for step in range(1, 7):
            dur = 0.1 + 0.01 * step + (0.3 if node == 2 else 0.0)
            events.append(("step", "span", T0 + step, dur, {"step": step}))
        events.append(("checkpoint", "span", T0 + 7, 0.5, {"step": 6}))
        events.append(("compile", "event", T0 + 1, 3.0, {"cached": False}))
        events.append(("bogus",))  # malformed: skipped
        tl.add_events(node, events)
    tl.add_events(1, [("restart", "event", T0 + 8, 0.0, {"restart_count": 1}),
                      ("rendezvous", "span", T0 + 9, 1.5, {"round": 2})])
    tl.record(0, "preempt_notice", attrs={"grace_s": 30.0})
    tl.bump("retries")
    tl.bump("telemetry_dropped", 4)
    obs.append(("stats", tl.step_stats(), dict(tl.slowest_per_step()),
                tl.step_skew(1.5), tl.step_time_series(3),
                tl.steps_observed(), tl.spans(1, "rendezvous"),
                tl.restart_count(1), tl.counter("retries"),
                tl.counter("telemetry_dropped"), tl.nodes(),
                tl.events(0), tl.to_chrome_trace()))
    sm = ns.sm.SpeedMonitor()
    for step in range(1, 5):
        clock.advance(1.0)
        sm.collect_global_step(step, clock.time(), tokens=1000)
    sm.record_compile(2.0, restart=True)
    sm.record_serve(0, qps=5.0, p50_s=0.1, p95_s=0.3, occupancy=0.4,
                    slots=4, p95_n=20)
    nm = ns.nm.NodeManager(num_nodes=3)
    nm.report_event(0, "started")
    cal = ns.cal.CalibrationLedger()
    cal.observe("k", "compute", 1.2, 1.0)
    cal.observe("k", "collective", 0.5, 0.4)
    cal.observe_overlap("k", 0.3)
    mem = ns.mem.MemoryLedger()
    mem.record(0, source="trainer", cache_key="k", timestamp=T0,
               bytes_in_use=8e9, peak_bytes=9e9, limit_bytes=80e9,
               headroom_frac=0.9, pool_params_b=3e9, pool_opt_state_b=2e8)
    mc = ns.metrics.MetricsCollector()
    mc.collect(0, 20.0, 3.0, 7.5, 0.6, timestamp=clock.time(),
               device_mem_max_gb=7.5, device_util_max=0.6)
    obs.append(("metrics", tl.render_metrics(
        speed_monitor=sm, node_manager=nm, calibration=cal, memory=mem,
        metrics=mc)))
    tl.evict_node(2)
    obs.append(("evicted", tl.nodes(), tl.step_stats(),
                tl.render_metrics()))
    return obs


def test_timeline_matches(clock):
    run_both(timeline_scenario, clock)


# -- the servicer, in process against over TCP ------------------------------------


def _envelopes(ns):
    """(method, Envelope) in order: every handler of both RPCs, once at
    least, the failure path and the telemetry routes included."""
    m = ns

    def env(node, payload):
        return m.Envelope(node_id=node, payload=payload)

    wire = [
        ("step", "span", T0 + 1, 0.25, {"step": 1}),
        ("fault", "event", T0 + 1, 0.2, {"seam": "rpc.get", "kind": "delay"}),
        ("serve.swap", "span", T0 + 2, 0.5,
         {"version": 2, "ok": True, "rolled_back": False}),
        ("serve", "event", T0 + 2, 0.0, {"qps": 3.0, "p95_s": 0.2}),
        ("moe", "event", T0 + 2, 0.0,
         {"step": 1, "entropy": 1.0, "experts": 2, "load": "[0.5, 0.5]"}),
        ("embed", "event", T0 + 2, 0.0, {"world": 2, "hit_rate": 0.5}),
        ("retry", "event", T0 + 3, 0.0, {"policy": "x"}),
        ("worker_start", "event", T0 + 3, 0.0, {"restart": 0}),
        ("memory", "event", T0 + 3, 0.0,
         {"cache_key": "k", "measured_b": 2e9, "modeled_b": 1.5e9,
          "bytes_in_use": 2e9, "pool_params_b": 1e9}),
        ("calibration", "event", T0 + 3, 0.0,
         {"cache_key": "k", "measured_compute": 0.9, "modeled_compute": 1.0,
          "measured_collective": 0.2, "modeled_collective": 0.1,
          "overlap": 0.25, "kernel_flash_fwd_kernel": 2}),
        ("serve", "event", T0 + 4, 0.0, {"qps": "bad", "p95_s": 0.1}),
    ]
    return [
        (REPORT, env(0, m.JoinRendezvous(0, 4))),
        (GET, env(0, m.CommWorldRequest(0))),
        (REPORT, env(1, m.JoinRendezvous(1, 4, node_unit=1))),
        (GET, env(1, m.CommWorldRequest(1))),
        (GET, env(0, m.WaitingNodesRequest())),
        (GET, env(0, m.WorldChangedRequest(1))),
        (REPORT, env(0, m.NetworkStatus(0, True, 1.0))),
        (GET, env(0, m.NetworkCheckResultRequest(0))),
        (REPORT, env(0, m.DatasetShardParams("d", 100, 25))),
        (GET, env(0, m.TaskRequest("d"))),
        (GET, env(1, m.TaskRequest("d", node_id=1))),
        (REPORT, env(0, m.TaskResult(0, "d"))),
        (GET, env(0, m.ShardCheckpointRequest("d"))),
        (REPORT, env(0, m.KVPut("a", b"x"))),
        (GET, env(0, m.KVGet("a"))),
        (GET, env(0, m.KVAdd("n", 2))),
        (REPORT, env(0, m.StepReport(1, T0 + 10, tokens=100, loss=2.5,
                                     anomalies=("nan@1:loss=nan",)))),
        (REPORT, env(0, m.StepReport(2, T0 + 11, tokens=100, loss=2.4))),
        (REPORT, env(0, m.HeartBeat(0, T0 + 11))),
        (REPORT, env(0, m.NodeEventReport(0, "started"))),
        (REPORT, env(0, m.NodeEventReport(
            0, "compile", json.dumps({"seconds": 4.0, "restart": True})))),
        (REPORT, env(0, m.NodeEventReport(0, "compile", "{not json"))),
        (REPORT, env(0, m.NodeEventReport(
            0, "relayout", json.dumps({"relayout_s": 0.7})))),
        (REPORT, env(0, m.ResourceStats(0, 40.0, 3.0, 7.0, 0.5, 7.0, 0.5))),
        (REPORT, env(0, m.TelemetryEvents(0, tuple(wire), dropped=2))),
        (REPORT, env(1, m.DigestReport(1, 2, "abc", check_every=2))),
        (REPORT, env(0, m.DigestReport(0, 2, "abc"))),
        (GET, env(0, m.SyncJoin("b", 0, 2))),
        (GET, env(1, m.SyncJoin("b", 1, 2))),
        (GET, env(0, m.SyncQuery("b"))),
        (GET, env(0, m.ClusterVersion(0, 3, expected=1))),
        (GET, env(0, m.ClusterVersion(0))),
        (GET, env(0, m.ParalConfigRequest(0))),
        (GET, env(0, m.TimelineRequest(0))),
        (REPORT, env(1, m.NodeFailure(1, "boom", 17, 0, "process"))),
        (REPORT, env(1, m.NodeFailure(1, "host", 1, 0, "node"))),
        (REPORT, env(1, m.PreemptionNotice(1, 20.0, "maintenance"))),
        (GET, env(0, m.JobStatusRequest())),
        (GET, env(0, m.ServePoll("u"))),  # no front door: a failure
        (GET, env(0, m.KVPut("a", b"y"))),  # a report sent as a get
        (REPORT, env(0, m.ShardCheckpoint("d", json.dumps(
            {"todo": [[0, 25, 0, None]], "epoch": 1, "completed": 0})))),
        (GET, env(2, m.TaskRequest("d"))),
    ]


def _tcp(port, method, envelope):
    import pickle

    with socket.create_connection(("localhost", port), timeout=30) as sock:
        send_frame(sock, pickle.dumps((method, envelope)))
        return t_msg.safe_loads(recv_frame(sock))


def _masters_state(m):
    return {
        "calibration": m.calibration.state(),
        "memory": {k: {f: v for f, v in s.items() if f != "timestamp"}
                   for k, s in m.memory_ledger.per_node().items()},
        "metrics": m.servicer.timeline.render_metrics(
            speed_monitor=m.speed_monitor, node_manager=m.node_manager,
            calibration=m.calibration, memory=m.memory_ledger,
            metrics=m.metrics),
        "timeline": m.timeline.events(),
        "statuses": m.node_manager.statuses(),
        "sdc": m.speed_monitor.sdc_ledger(),
        "counters": {c: m.timeline.counter(c)
                     for c in ("retries", "worker_starts",
                               "telemetry_dropped")},
    }


def test_servicer_responses_match_over_tcp(clock):
    clock.now = T0
    ref = j_jm.JobMaster(port=0, num_nodes=2, auto_scale=False)
    want = [ref.servicer.report(e) if method == REPORT else
            ref.servicer.get(e) for method, e in _envelopes(j_msg)]
    want_state = _masters_state(ref)

    clock.now = T0
    port = t_jm.JobMaster(port=0, num_nodes=2, auto_scale=False)
    port.prepare()  # the server alone: no control loop ticks the clock
    try:
        got = [_tcp(port.port, method, e)
               for method, e in _envelopes(t_msg)]
        got_state = _masters_state(port)
    finally:
        port.stop()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        # A refusal names the payload's class, which lives in each
        # package's own messages module.
        message = g.message.replace("dlrover_tpu_torch.", "dlrover_tpu.")
        assert_same(dataclasses.asdict(g) | {"message": message},
                    dataclasses.asdict(w), f"$[{i}]")
    # The servicer routed the telemetry into the same ledgers.
    assert_same(got_state, want_state)
    assert got_state["calibration"]["counts"]
    assert got_state["memory"][0]["pool_params_b"] == 1e9


def test_repair_loop_leaves_finished_nodes_alone():
    """The port's one divergence from the reference's ledgers: a worker
    whose trainer reported success is done, not missing.  The reference's
    repair loop relaunches it (a finished job's node goes back to
    PENDING on the next control-loop tick, and ``job_phase`` leaves
    "succeeded"); the port's leaves it, and still relaunches a retired
    node for a scale-up."""
    from dlrover_tpu.master.auto_scaler import JobAutoScaler as JScaler
    from dlrover_tpu_torch.master.auto_scaler import JobAutoScaler as TScaler

    plans = {}
    for name, ns, scaler_cls in (("ref", REF, JScaler),
                                 ("port", PORT, TScaler)):
        nm = ns.nm.NodeManager(num_nodes=2)
        scaler = scaler_cls(nm, ns.sm.SpeedMonitor(), min_nodes=2,
                            max_nodes=2, cooldown_s=0.0)
        for node in (0, 1):
            nm.report_event(node, "started")
        nm.report_event(0, "succeeded")
        one = scaler.decide().launch
        nm.report_event(1, "succeeded")
        both = scaler.decide().launch
        nm.report_event(0, "started")
        nm.retire_node(1)
        retired = scaler.decide().launch
        plans[name] = (one, both, retired)
    assert plans["ref"] == ([0], [0, 1], [1])
    assert plans["port"] == ([], [], [1])

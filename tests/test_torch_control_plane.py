"""The port's master and agent client over its standard-library transport:
``tests/test_control_plane.py``'s cases against ``dlrover_tpu_torch``,
the restricted unpickler, the grpc-free imports, and the options of the
master, the launcher, the agent and the scaler that the port once refused
(each case now holds the option accepted and wired).

The cases mirror the reference's one for one (the same names, inputs and
assertions).
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import pytest

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.master import messages as msg
from dlrover_tpu_torch.master.job_master import JobMaster
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import GET, recv_frame, send_frame
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def master():
    m = JobMaster(port=0, num_nodes=2)
    m.start()
    yield m
    m.stop()


@pytest.fixture()
def client(master):
    c = MasterClient(f"localhost:{master.port}", node_id=0)
    yield c
    c.close()


# -- the reference's cases ---------------------------------------------------


def test_rendezvous_two_nodes(master, client):
    client2 = MasterClient(f"localhost:{master.port}", node_id=1)
    assert client.join_rendezvous(0, 4) == 0
    state = client.get_comm_world(0)
    assert state.world == {}  # still forming: only 1 of 2 nodes
    client2.join_rendezvous(1, 4)
    state = client.get_comm_world(0)
    assert state.world == {0: 4, 1: 4}
    assert state.round == 1
    state2 = client2.get_comm_world(1)
    assert state2.world == {0: 4, 1: 4}
    client2.close()


def test_dynamic_sharding_and_recovery(master, client):
    client.create_dataset(
        msg.DatasetShardParams(
            dataset_name="train", dataset_size=100, shard_size=30
        )
    )
    seen = []
    t1 = client.get_task("train")
    t2 = client.get_task("train")
    seen += [(t1.start, t1.end), (t2.start, t2.end)]
    client.report_task("train", t1.task_id, success=True)
    # node 0 dies with t2 in flight -> shard requeues
    master.task_manager.recover_tasks(0)
    t3 = client.get_task("train")
    assert (t3.start, t3.end) == (t2.start, t2.end)
    # drain the rest
    tasks = []
    while True:
        t = client.get_task("train")
        if t.empty:
            break
        tasks.append(t)
        client.report_task("train", t.task_id)
    client.report_task("train", t3.task_id)
    covered = sorted(seen + [(t.start, t.end) for t in tasks])
    assert covered[0][0] == 0 and covered[-1][1] == 100


def test_shard_checkpoint_roundtrip(master, client):
    client.create_dataset(
        msg.DatasetShardParams(
            dataset_name="ckpt_ds", dataset_size=60, shard_size=20
        )
    )
    t = client.get_task("ckpt_ds")  # one in flight
    ckpt = client.get_shard_checkpoint("ckpt_ds")
    assert "todo" in ckpt.content
    client.restore_shard_checkpoint(ckpt)
    # after restore, the in-flight shard is pending again
    starts = set()
    while True:
        task = client.get_task("ckpt_ds")
        if task.empty:
            break
        starts.add(task.start)
        client.report_task("ckpt_ds", task.task_id)
    assert t.start in starts


def test_kv_store_and_barrier(master, client):
    client.kv_put("rdzv/addr", b"10.0.0.1:1234")
    assert client.kv_get("rdzv/addr") == b"10.0.0.1:1234"
    assert client.kv_get("missing") is None
    assert client.kv_add("barrier/x") == 1
    assert client.kv_add("barrier/x") == 2


def test_step_reports_and_job_status(master, client):
    now = time.time()
    for i, step in enumerate([1, 2, 3, 4]):
        master.speed_monitor.collect_global_step(
            step, now + i * 1.0, tokens=1000
        )
    status = client.get_job_status()
    assert status.global_step == 4
    assert status.speed == pytest.approx(1.0, rel=0.2)


def test_failure_report_actions(master, client):
    action = client.report_failure("oom", exit_code=137, level="process")
    assert action == "restart"
    action = client.report_failure("host gone", exit_code=1, level="node")
    assert action == "relaunch"


def test_network_check_bisection():
    manager = NetworkCheckRendezvousManager()
    manager.update_rdzv_params(4, 4, 60.0, 1)
    for rank in range(4):
        manager.join_rendezvous(rank, 4)
    # round 0: pairs (0,1) (2,3)
    _, g0, w0 = manager.get_comm_world(0)
    _, g1, w1 = manager.get_comm_world(2)
    assert set(w0) == {0, 1} and set(w1) == {2, 3}
    assert g0 != g1
    # pair (2,3) fails its probe
    manager.report_network_status(0, True, 1.0)
    manager.report_network_status(1, True, 1.0)
    manager.report_network_status(2, False, 1.0)
    manager.report_network_status(3, False, 1.0)
    faults, reason = manager.check_fault_node()
    assert set(faults) == {2, 3}
    # round 1: each suspect paired with a healthy node to bisect
    groups = manager._group_nodes(1)
    for suspect in (2, 3):
        group = [g for g in groups if suspect in g][0]
        assert any(r in (0, 1) for r in group), group
    # after round 1, only node 3 still fails -> node 3 is the bad host
    manager.report_network_status(2, True, 1.0)
    manager.report_network_status(3, False, 1.0)
    faults, _ = manager.check_fault_node()
    assert faults == [3]


def test_straggler_detection():
    manager = NetworkCheckRendezvousManager()
    manager.update_rdzv_params(4, 4, 60.0, 1)
    for rank in range(4):
        manager.join_rendezvous(rank, 1)
        manager.get_comm_world(rank)
    times = {0: 1.0, 1: 1.1, 2: 0.9, 3: 5.0}
    for rank, t in times.items():
        manager.report_network_status(rank, True, t)
    assert manager.get_stragglers() == [3]


def test_rdzv_node_unit_rounding():
    """With node_unit=2, a 3-node waiting set seals a 2-node world."""
    manager = ElasticTrainingRendezvousManager()
    manager.update_rdzv_params(
        min_nodes=2, max_nodes=4, waiting_timeout=0.0, node_unit=2
    )
    for rank in range(3):
        manager.join_rendezvous(rank, 4)
    time.sleep(0.01)
    _, _, world = manager.get_comm_world(0)
    assert len(world) == 2


def test_speed_monitor_goodput():
    monitor = SpeedMonitor()
    t0 = time.time()
    monitor.collect_global_step(1, t0)
    monitor.collect_global_step(2, t0 + 1)
    assert monitor.no_progress_for() < 5
    assert 0.0 <= monitor.goodput() <= 1.0


def test_network_check_odd_healthy_pool_no_singleton():
    """Round>=1 grouping with an odd healthy pool must not strand the
    last node in a singleton/empty comm world."""
    mgr = NetworkCheckRendezvousManager()
    mgr._rdzv_nodes = {r: 1 for r in range(5)}
    for r in range(5):
        mgr._node_status[r] = True  # all healthy -> pool of 5, no suspects
    groups = mgr._group_nodes(check_round=1)
    covered = sorted(r for g in groups for r in g)
    assert covered == list(range(5))
    assert all(len(g) >= 2 for g in groups)


def test_sync_service_barrier_and_cluster_version(master, client):
    client2 = MasterClient(f"localhost:{master.port}", node_id=1)
    assert client.join_sync("init", need=2) is False
    assert client2.join_sync("init", need=2) is True
    # Late (re-)join of a finished barrier passes immediately.
    assert client.join_sync("init", need=2) is True
    assert client.sync_finished("init")

    # Cluster version: global = min over reporters, gated on the expected
    # reporter count (one early reporter must not advance it alone).
    assert client.report_cluster_version(3, expected=2) == 0
    assert client2.report_cluster_version(2, expected=2) == 2
    assert client.get_cluster_version() == 2
    # A dead node must not hold the version back or wedge barriers.
    client.join_sync("resize", need=2)
    master._handle_node_death(1)
    assert client.sync_finished("resize")
    assert client.report_cluster_version(3, expected=1) == 3
    client2.close()


def test_paral_config_update_and_versioning(master, client):
    base = client.get_paral_config()
    master.servicer.update_paral_config(
        msg.ParalConfig(global_batch_size=64, grad_accum=2)
    )
    updated = client.get_paral_config()
    assert updated.version == base.version + 1
    assert updated.global_batch_size == 64


def test_master_kill_restart_agents_rejoin_monotonic_round(tmp_path):
    """Kill the master (stop; only state_path survives), start a fresh
    one from the same state file, and have the agents re-join over the
    wire — the re-formed world's rendezvous round must be strictly
    greater than any round the dead master sealed."""
    path = str(tmp_path / "master_state.json")
    first = JobMaster(port=0, num_nodes=2, min_nodes=1, state_path=path)
    first.start()
    try:
        a0 = MasterClient(f"localhost:{first.port}", node_id=0)
        a1 = MasterClient(f"localhost:{first.port}", node_id=1)
        a0.join_rendezvous(0, 4)
        a1.join_rendezvous(1, 4)
        sealed = a0.get_comm_world(0)
        assert sealed.round == 1 and sealed.world == {0: 4, 1: 4}
        first._state_store.save(first)
        a0.close()
        a1.close()
    finally:
        first.stop()  # the kill: all in-memory state gone

    fresh = JobMaster(port=0, num_nodes=2, min_nodes=1, state_path=path)
    fresh.start()
    try:
        # Restore alone already keeps the counter monotonic...
        assert fresh.rdzv_managers["elastic-training"]._rdzv_round >= 1
        a0 = MasterClient(f"localhost:{fresh.port}", node_id=0)
        a1 = MasterClient(f"localhost:{fresh.port}", node_id=1)
        a0.join_rendezvous(0, 4)
        a1.join_rendezvous(1, 4)
        resealed = a0.get_comm_world(0)
        # ...and the agents' re-join seals a STRICTLY newer round.
        assert resealed.world == {0: 4, 1: 4}
        assert resealed.round > sealed.round
        a0.close()
        a1.close()
    finally:
        fresh.stop()


# -- the transport -----------------------------------------------------------


def _global_pickle(module: str, name: str) -> bytes:
    """A protocol-4 pickle that resolves ``module.name`` through
    STACK_GLOBAL and returns it."""
    def short(text):
        raw = text.encode()
        return b"\x8c" + bytes([len(raw)]) + raw

    return b"\x80\x04" + short(module) + short(name) + b"\x93."


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def test_restricted_unpickler_rejects_forbidden_and_dotted_globals():
    env = msg.Envelope(node_id=3, payload=msg.StepReport(7, 1.5, tokens=2))
    assert msg.safe_loads(pickle.dumps(env)) == env
    with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
        msg.safe_loads(pickle.dumps(_Evil()))
    with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
        msg.safe_loads(_global_pickle("subprocess", "Popen"))
    with pytest.raises(pickle.UnpicklingError, match="dotted"):
        msg.safe_loads(_global_pickle(msg.__name__, "Envelope.__init__"))
    # A top-level name of the module that is not a class is refused too.
    with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
        msg.safe_loads(_global_pickle(msg.__name__, "safe_loads"))


def _raw_exchange(port: int, data: bytes) -> msg.Response:
    with socket.create_connection(("localhost", port), timeout=10) as sock:
        send_frame(sock, data)
        return msg.safe_loads(recv_frame(sock))


def test_server_refuses_forbidden_payload_and_keeps_serving(master):
    refused = _raw_exchange(master.port, pickle.dumps((GET, _Evil())))
    assert not refused.success and "forbidden global" in refused.message
    not_envelope = _raw_exchange(master.port, pickle.dumps((GET, 3)))
    assert not not_envelope.success and "not an Envelope" in (
        not_envelope.message)
    bad_method = _raw_exchange(master.port, pickle.dumps(
        ("/x", msg.Envelope(payload=msg.JobStatusRequest()))))
    assert not bad_method.success and "no such method" in bad_method.message
    ok = _raw_exchange(master.port, pickle.dumps(
        (GET, msg.Envelope(payload=msg.JobStatusRequest()))))
    assert ok.success and isinstance(ok.payload, msg.JobStatus)
    # A rejection the master answered is fatal at the client, not retried.
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    with pytest.raises(RuntimeError, match="no handler"):
        client.get(msg.KVPut("k", b"v"))  # KVPut is a report, not a get


def test_master_gone_raises_connection_error():
    m = JobMaster(port=0, num_nodes=1)
    port = m.start()
    client = MasterClient(f"localhost:{port}", node_id=0, retries=2,
                          deadline_s=2.0)
    assert client.ping()
    assert client.get_job_status().global_step == 0
    m.stop()
    assert not client.ping()
    with pytest.raises(ConnectionError, match="master unreachable"):
        client.get_job_status()

    # A server that closes mid-answer: a ConnectionError, never an empty
    # answer.
    listener = socket.socket()
    listener.bind(("localhost", 0))
    listener.listen(4)
    half = MasterClient(f"localhost:{listener.getsockname()[1]}",
                        retries=1, deadline_s=1.0)
    import threading

    def serve_half():
        for _ in range(2):
            conn, _ = listener.accept()
            recv_frame(conn)
            conn.sendall(b"\x10\x00\x00\x00\x00\x00\x00\x00abc")
            conn.close()

    thread = threading.Thread(target=serve_half, daemon=True)
    thread.start()
    with pytest.raises(ConnectionError):
        half.get_job_status()
    listener.close()


def test_client_is_safe_across_threads(master):
    from concurrent.futures import ThreadPoolExecutor

    # One client shared by more threads than the host has cores, with the
    # interpreter switching threads often: a lost update would repeat or
    # skip a count.
    client = MasterClient(f"localhost:{master.port}", node_id=0)
    workers = 2 * (os.cpu_count() or 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(workers) as pool:
            got = list(pool.map(lambda _: client.kv_add("threads/x"),
                                range(200)))
    finally:
        sys.setswitchinterval(interval)
    assert sorted(got) == list(range(1, 201))


def test_control_plane_imports_without_grpc():
    code = (
        "import sys\n"
        "sys.modules['grpc'] = None\n"
        "import dlrover_tpu_torch.master.servicer\n"
        "import dlrover_tpu_torch.agent.master_client\n"
        "import dlrover_tpu_torch.master.job_master\n"
        "import dlrover_tpu_torch.run\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dlrover_tpu', 'grpc') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]


# -- the options once refused ------------------------------------------------
#
# The three tests keep the names of the refusals they replace, with the
# same ids; each case now holds its option accepted and wired.


class _CloudLauncher:
    def __init__(self):
        self.reconciles = 0

    def launch(self, node_id):
        pass

    def delete(self, node_id):
        pass

    def reconcile(self):
        self.reconciles += 1
        return {}


def _http_json(port, path):
    import json
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("kwargs", [
    dict(hang_threshold=30.0),
    dict(num_nodes=4, min_nodes=2),
    dict(num_nodes=4, min_nodes=2, brain_overrides={"degrade_threshold": 0.5}),
    dict(metrics_port=-1),
    dict(metrics_port=-1, healthz_hbm_floor=0.1),
    dict(pools={"coworker": 2}),
    dict(launcher=_CloudLauncher()),
], ids=["hang_threshold", "elastic_range", "brain", "metrics_port",
        "healthz", "coworker", "cloud"])
def test_job_master_refuses_the_remainder(kwargs):
    """Each option the port's master once refused is accepted and wired:
    the diagnosis chain's cooldown, the running-job optimizer over an
    elastic range (with the spec's thresholds), the HTTP plane on its port
    (and its ``/healthz`` floor), the coworker pool, and a launcher whose
    ``reconcile`` the control loop's tick calls."""
    from dlrover_tpu_torch.master.brain import RunningJobOptimizer

    if kwargs.get("metrics_port") == -1:
        kwargs = dict(kwargs, metrics_port=msg.free_port())
    m = JobMaster(port=0, **kwargs)
    m.start()
    try:
        if "hang_threshold" in kwargs:
            assert m.hang_threshold == 30.0
            assert m.diagnosis.cooldown_s == 30.0
        if "min_nodes" in kwargs:
            opt = m.auto_scaler.optimizer
            assert isinstance(opt, RunningJobOptimizer)
            assert opt.degrade_threshold == kwargs.get(
                "brain_overrides", {}).get("degrade_threshold", 0.7)
            rdzv = m.rdzv_managers["elastic-training"]._params
            assert (rdzv.min_nodes, rdzv.max_nodes) == (2, 4)
        if "metrics_port" in kwargs:
            health = _http_json(m.metrics_port, "/healthz")
            assert health["ok"] is True and health["hbm_headroom_frac"] == -1
            assert m.http_plane.healthz_hbm_floor == kwargs.get(
                "healthz_hbm_floor", 0.0)
        if "pools" in kwargs:
            assert sorted(m.node_manager.statuses(pool="coworker")) == [
                10_000, 10_001]
        if "launcher" in kwargs:
            m._reconcile_cloud()
            assert kwargs["launcher"].reconciles >= 1
    finally:
        m.stop()
    assert m.http_plane is None


@pytest.mark.parametrize("argv", [
    ["--job-spec", "job.toml", "--", "true"],
    ["--master-only", "--cloud", "--job-spec", "job.toml"],
    ["--network-check", "--", "true"],
    ["--nnodes", "1:2", "--", "true"],
], ids=["job_spec", "cloud", "network_check", "elastic_range"])
def test_run_refuses_the_remainder(argv, tmp_path):
    """Each launcher flag the port once refused parses and reaches the
    place that uses it."""
    from dlrover_tpu_torch import run

    spec = tmp_path / "job.toml"
    spec.write_text('job_name = "j"\n[nodes]\nmin = 1\nmax = 2\n'
                    '[trainer]\nmax_restarts = 7\n')
    args = run._parse_args([str(spec) if a == "job.toml" else a
                            for a in argv])
    if "--job-spec" in argv:
        assert args.spec.job_name == "j" and args.nnodes == "1:2"
        assert args.max_restarts == 7
    if "--cloud" in argv:
        assert args.cloud and args.master_only
    if "--network-check" in argv:
        assert args.network_check and args.node_check_device == "cuda"
    if "--nnodes" in argv:
        assert run._parse_nnodes(args.nnodes) == (1, 2)


def test_agent_and_scaler_refuse_the_remainder():
    """The agent takes ``network_check`` (its probes on the cards unless
    the config asks for the CPU) and the scaler an ``optimizer``."""
    from dlrover_tpu_torch.agent.training_agent import (
        ElasticAgent,
        ElasticLaunchConfig,
    )
    from dlrover_tpu_torch.master.auto_scaler import JobAutoScaler
    from dlrover_tpu_torch.master.brain import RunningJobOptimizer
    from dlrover_tpu_torch.master.node_manager import NodeManager

    agent = ElasticAgent(ElasticLaunchConfig(network_check=True), ["true"],
                         "localhost:1")
    assert agent.config.network_check
    assert agent.config.node_check_device == "cuda"
    opt = RunningJobOptimizer()
    scaler = JobAutoScaler(NodeManager(), SpeedMonitor(), optimizer=opt)
    assert scaler.optimizer is opt and scaler.optimize_interval_s == 300.0
    # Pools other than the coworker's are the node manager's own.
    m = JobMaster(port=0, num_nodes=1, pools={"embed": 1})
    assert m.node_manager.pool_of(10_000) == "embed"


def test_serve_front_door_over_the_wire():
    """``attach_serve_frontend`` makes submit/poll/cancel live RPCs on
    the master's transport and wires the fleet's retire hook."""
    from dlrover_tpu_torch.serving import ReplicaFleet, ServeFrontend

    m = JobMaster(port=0, num_nodes=1)
    port = m.start()
    try:
        fleet = ReplicaFleet()
        m.attach_serve_frontend(ServeFrontend(fleet))
        assert fleet.retire_hook == m._handle_replica_retired
        c = MasterClient(f"localhost:{port}", node_id=0)
        ticket = c.serve_submit(msg.ServeSubmit("u1", (1, 2, 3)))
        assert isinstance(ticket, msg.ServeTicket)
        assert (ticket.uid, ticket.accepted) == ("u1", False)
        assert ticket.reason == "no_fleet"
        assert c.serve_poll("u1").state == "no_fleet"  # the shed verdict
        assert c.serve_cancel("u1").uid == "u1"
    finally:
        m.stop()

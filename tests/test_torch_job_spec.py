"""The port's declarative job spec, its CLI precedence, the cluster master's
wiring, job phases and typed pools against the reference's.

Each case is ``tests/test_job_spec.py``'s (the same names, inputs and
assertions; its one slow end-to-end launch is mirrored by
``tests/test_torch_node_check.py``'s launcher run from a spec), run as a
scenario on both packages: parsed specs (``spec_to_dict``), the parsed
CLI namespace, master kwargs, phases, statuses and launcher calls must
agree exactly.  Beyond the reference's cases: a ``.yaml`` spec where the
``yaml`` package is missing raises a ``JobSpecError`` naming it (the
reference lets the ``ModuleNotFoundError`` through), and the one
spec-to-master-kwargs helper.  The cloud master's address comes from
``DLROVER_TPU_MASTER_HOST`` (127.0.0.1), so no test resolves a host name.
"""

import dataclasses
import sys
import time
import types

import pytest

from dlrover_tpu import run as j_run
from dlrover_tpu.common import job_spec as j_spec
from dlrover_tpu.master import cloud_launcher as j_cloud
from dlrover_tpu.master import job_master as j_jm
from dlrover_tpu.master import node_manager as j_nm
from dlrover_tpu_torch import run as t_run
from dlrover_tpu_torch.common import job_spec as t_spec
from dlrover_tpu_torch.master import cloud_launcher as t_cloud
from dlrover_tpu_torch.master import job_master as t_jm
from dlrover_tpu_torch.master import node_manager as t_nm
from test_torch_master_parity import assert_same

REF = types.SimpleNamespace(run=j_run, spec=j_spec, cloud=j_cloud, jm=j_jm,
                            nm=j_nm)
PORT = types.SimpleNamespace(run=t_run, spec=t_spec, cloud=t_cloud,
                             jm=t_jm, nm=t_nm)

TOML_SPEC = """
api_version = "dlrover-tpu/v1"
job_name = "llm-pretrain"

[nodes]
min = 2
max = 8
unit = 2

[accelerator]
type = "v5litepod-16"
preemptible = true

[master]
heartbeat_timeout = 45.0
hang_threshold = 600.0

[brain]
uplift_threshold = 1.2
stale_after_s = 1800.0

[checkpoint]
dir = "/ckpt"
every = 50

[trainer]
command = ["python", "train.py", "--steps", "100"]
max_restarts = 5
env = {DATA_DIR = "/data"}
"""


def run_both(scenario, *args):
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert want, "the scenario recorded nothing"
    assert_same(got, want)
    return got


def _args(ns, argv):
    """The parsed namespace as plain data (the spec as its dict)."""
    args = ns.run._parse_args(argv)
    out = {k: v for k, v in vars(args).items()
           if k not in ("spec", "node_check_device")}
    out["spec"] = None if args.spec is None else ns.spec.spec_to_dict(
        args.spec)
    return out


@pytest.fixture()
def spec_path(tmp_path):
    path = tmp_path / "job.toml"
    path.write_text(TOML_SPEC)
    return str(path)


def test_toml_spec_roundtrip(spec_path):
    spec = run_both(
        lambda ns: ns.spec.spec_to_dict(ns.spec.load_job_spec(spec_path)))
    assert spec["job_name"] == "llm-pretrain"
    assert (spec["nodes"]["min"], spec["nodes"]["max"],
            spec["nodes"]["unit"]) == (2, 8, 2)
    assert spec["accelerator"]["type"] == "v5litepod-16"
    assert spec["accelerator"]["preemptible"]
    assert spec["master"]["heartbeat_timeout"] == 45.0
    assert spec["brain"]["uplift_threshold"] == 1.2
    assert spec["checkpoint"]["dir"] == "/ckpt"
    assert spec["trainer"]["command"][:2] == ["python", "train.py"]
    assert spec["trainer"]["env"] == {"DATA_DIR": "/data"}
    assert spec["trainer"]["max_restarts"] == 5


def test_yaml_and_json_formats(tmp_path):
    yaml_path = tmp_path / "job.yaml"
    yaml_path.write_text(
        "api_version: dlrover-tpu/v1\n"
        "job_name: yjob\n"
        "nodes: {min: 1, max: 4}\n"
        "trainer: {command: [python, t.py]}\n"
    )
    json_path = tmp_path / "job.json"
    json_path.write_text(
        '{"api_version": "dlrover-tpu/v1", "job_name": "jjob",'
        ' "nodes": {"min": 1, "max": 2}}'
    )
    bad = tmp_path / "job.ini"
    bad.write_text("x")

    def scenario(ns):
        obs = [ns.spec.spec_to_dict(ns.spec.load_job_spec(str(p)))
               for p in (yaml_path, json_path)]
        with pytest.raises(ns.spec.JobSpecError,
                           match="unsupported spec format"):
            ns.spec.load_job_spec(str(bad))
        return obs

    pytest.importorskip("yaml", reason="the reference's YAML case reads "
                                       "with the yaml package")
    yspec, jspec = run_both(scenario)
    assert yspec["job_name"] == "yjob" and yspec["nodes"]["max"] == 4
    assert jspec["job_name"] == "jjob"


def test_yaml_spec_without_the_package_names_it(tmp_path, monkeypatch):
    """No ``yaml`` package (the card has none): a ``.yaml`` spec raises a
    ``JobSpecError`` that names it, and no other parser reads the file."""
    path = tmp_path / "job.yaml"
    path.write_text("job_name: yjob\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(t_spec.JobSpecError, match="'yaml' package"):
        t_spec.load_job_spec(str(path))
    with pytest.raises(t_spec.JobSpecError, match="'yaml' package"):
        t_run._parse_args(["--job-spec", str(path)])


def test_unknown_keys_and_versions_rejected():
    cases = [
        ({"nodes": {"mln": 2}}, "unknown key"),
        ({"nodez": {}}, "unknown top-level"),
        ({"api_version": "dlrover-tpu/v0"}, "api_version"),
        ({"nodes": {"min": 4, "max": 2}}, "min <= max"),
        ({"nodes": {"min": 1, "max": 4, "unit": 3}}, "unit"),
        ({"job_name": "j", "faults": {"plan": "storage.write:explode"}},
         "faults"),
    ]

    def scenario(ns):
        messages = []
        for data, pattern in cases:
            with pytest.raises(ns.spec.JobSpecError, match=pattern) as err:
                ns.spec.spec_from_dict(data)
            messages.append(str(err.value))
        return messages

    assert len(run_both(scenario)) == len(cases)


def test_cli_flags_override_spec(spec_path):
    def scenario(ns):
        return [_args(ns, ["--job-spec", spec_path]),
                _args(ns, ["--job-spec", spec_path, "--nnodes", "1:2",
                           "--max-restarts", "1", "--", "python",
                           "other.py"])]

    alone, flagged = run_both(scenario)
    assert alone["nnodes"] == "2:8" and alone["node_unit"] == 2
    assert alone["max_restarts"] == 5 and alone["checkpoint_dir"] == "/ckpt"
    assert alone["command"] == ["python", "train.py", "--steps", "100"]
    assert flagged["nnodes"] == "1:2" and flagged["max_restarts"] == 1
    assert flagged["node_unit"] == 2
    assert flagged["command"] == ["python", "other.py"]


def test_defaults_are_valid():
    spec = run_both(
        lambda ns: ns.spec.spec_to_dict(ns.spec.ElasticJobSpec().validate()))
    assert spec["nodes"]["max"] == 1


def test_env_values_coerced_to_strings(tmp_path):
    path = tmp_path / "j.toml"
    path.write_text(
        'api_version = "dlrover-tpu/v1"\njob_name = "j"\n'
        '[trainer]\nenv = {OMP_NUM_THREADS = 4, FAST = true, NAME = "x"}\n'
    )

    def scenario(ns):
        env = ns.spec.load_job_spec(str(path)).trainer.env
        with pytest.raises(ns.spec.JobSpecError,
                           match="env.BAD must be a scalar"):
            ns.spec.spec_from_dict({
                "job_name": "j", "trainer": {"env": {"BAD": [1, 2]}}
            })
        return env

    assert run_both(scenario) == {
        "OMP_NUM_THREADS": "4", "FAST": "1", "NAME": "x"}


def test_master_kwargs_from_spec_is_one_helper(spec_path):
    """The standalone master and the cluster master take their kwargs from
    one helper, equal to the reference's for the same spec."""
    kwargs = run_both(lambda ns: ns.run._master_kwargs_from_spec(
        ns.spec.load_job_spec(spec_path)))
    assert kwargs["hang_threshold"] == 600.0
    assert kwargs["brain_overrides"]["uplift_threshold"] == 1.2
    assert t_run._master_kwargs_from_spec(None) == {}


def test_master_only_cloud_wiring(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_MASTER_HOST", "127.0.0.1")
    path = tmp_path / "job.toml"
    path.write_text("""
api_version = "dlrover-tpu/v1"
job_name = "cloudjob"

[nodes]
min = 1
max = 2

[accelerator]
type = "v5litepod-16"
runtime_version = "rt-x"

[brain]
patience = 7
stale_after_s = 123.0
""")

    def scenario(ns):
        seen = {}

        def factory(spec, master_addr):
            seen["accel"] = spec.accelerator.type
            seen["addr"] = master_addr
            return ns.cloud.CloudNodeLauncher(
                ns.cloud.FakeTpuVmClient(), job_name=spec.job_name,
                master_addr=master_addr,
                accelerator_type=spec.accelerator.type,
                runtime_version=spec.accelerator.runtime_version,
            )

        args = ns.run._parse_args(
            ["--master-only", "--cloud", "--job-spec", str(path)])
        master, launcher = ns.run.build_cluster_master(
            args, launcher_factory=factory)
        try:
            opt = master.auto_scaler.optimizer
            obs = {"accel": seen["accel"],
                   "host": seen["addr"].rsplit(":", 1)[0],
                   "optimizer": [opt.patience, opt.stale_after_s]}
            master.start()
            master.bootstrap_nodes()
            deadline = time.monotonic() + 5
            client = launcher.client
            while time.monotonic() < deadline and len(client.instances) < 2:
                time.sleep(0.05)
            obs["instances"] = sorted(client.instances)
            node = client.get_node("cloudjob-worker-0")
            obs["meta_is_addr"] = (
                node["metadata"]["dlrover-master-addr"] == seen["addr"])
            obs["accelerator_type"] = node["accelerator_type"]
            return obs
        finally:
            master.stop()
            launcher.shutdown()

    got = run_both(scenario)
    assert got["accel"] == "v5litepod-16" and got["host"] == "127.0.0.1"
    assert got["optimizer"] == [7, 123.0]
    assert got["instances"] == ["cloudjob-worker-0", "cloudjob-worker-1"]
    assert got["meta_is_addr"] and got["accelerator_type"] == "v5litepod-16"


def test_job_phase_lifecycle_and_teardown():
    def scenario(ns):
        client = ns.cloud.FakeTpuVmClient()
        launcher = ns.cloud.CloudNodeLauncher(client, job_name="ph")
        master = ns.jm.JobMaster(num_nodes=2, launcher=launcher,
                                 heartbeat_timeout=3600.0)
        try:
            nm = master.node_manager
            phases = [master.job_phase()]
            master.bootstrap_nodes()
            phases.append(master.job_phase())
            nm.report_event(0, "started")
            phases.append(master.job_phase())
            nm.report_event(1, "started")
            nm.report_event(0, "succeeded")
            phases.append(master.job_phase())
            nm.report_event(1, "succeeded")
            phases.append(master.job_phase())
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and len(client.instances) < 2:
                time.sleep(0.05)
            master.teardown_nodes()
            return {"phases": phases,
                    "states": sorted(i["state"]
                                     for i in client.instances.values())}
        finally:
            master.stop()
            launcher.shutdown()

    got = run_both(scenario)
    assert got["phases"] == ["pending", "pending", "running", "running",
                             "succeeded"]
    assert got["states"] == ["TERMINATED", "TERMINATED"]


def test_job_phase_failed():
    def scenario(ns):
        master = ns.jm.JobMaster(num_nodes=1, max_relaunches=0,
                                 heartbeat_timeout=3600.0)
        try:
            master.node_manager.report_event(0, "started")
            master.node_manager.report_event(0, "failed", "boom")
            return [master.job_phase()]
        finally:
            master.stop()

    assert run_both(scenario) == ["failed"]


def test_typed_pools_and_migration():
    def scenario(ns):
        base = ns.nm.NodeManager.POOL_ID_STRIDE
        client = ns.cloud.FakeTpuVmClient()
        launcher = ns.cloud.CloudNodeLauncher(client, job_name="tp")
        master = ns.jm.JobMaster(
            num_nodes=2, min_nodes=1, launcher=launcher, auto_scale=True,
            heartbeat_timeout=3600.0, pools={"coworker": 2},
        )
        try:
            nm = master.node_manager
            obs = {"pools": [nm.pool_of(0), nm.pool_of(base)],
                   "coworkers": sorted(nm.statuses(pool="coworker"))}
            master.bootstrap_nodes()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and len(client.instances) < 4:
                time.sleep(0.05)
            obs["instances"] = sorted(client.instances)
            for n in (0, 1):
                nm.report_event(n, "started")
            master.auto_scaler.set_target(1, reason="test")
            obs["plan"] = master.auto_scaler.step()
            nm.report_event(base, "started")
            new_id = nm.migrate(base)
            obs["new_id"] = new_id
            obs["draining"] = nm.statuses()[base]
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and (
                f"tp-worker-{new_id}" not in client.instances
            ):
                time.sleep(0.05)
            nm.report_event(new_id, "started")
            obs["retired"] = nm.statuses()[base]
            obs["deleted_original"] = "tp-worker-10000" in client.delete_calls
            return obs
        finally:
            master.stop()
            launcher.shutdown()

    got = run_both(scenario)
    assert got["pools"] == ["worker", "coworker"]
    assert got["coworkers"] == [10_000, 10_001]
    assert len(got["instances"]) == 4 and got["plan"].delete == [1]
    assert got["new_id"] == 10_002 and got["draining"] == "preempting"
    assert got["retired"] == "succeeded" and got["deleted_original"]


def test_spec_coworker_pool_flows_to_master(tmp_path):
    path = tmp_path / "j.toml"
    path.write_text(
        'api_version = "dlrover-tpu/v1"\njob_name = "j"\n'
        "[nodes]\nmin = 1\nmax = 2\ncoworkers = 3\n"
    )

    def scenario(ns):
        kwargs = ns.run._master_kwargs_from_spec(
            ns.spec.load_job_spec(str(path)))
        master = ns.jm.JobMaster(num_nodes=2, min_nodes=1, **kwargs)
        try:
            return {"pools": kwargs["pools"],
                    "coworkers": sorted(master.node_manager.statuses(
                        pool="coworker"))}
        finally:
            master.stop()

    got = run_both(scenario)
    assert got["pools"] == {"coworker": 3}
    assert got["coworkers"] == [10_000, 10_001, 10_002]


def test_pool_node_heartbeat_death_repaired_under_scaler():
    def scenario(ns):
        base = ns.nm.NodeManager.POOL_ID_STRIDE
        master = ns.jm.JobMaster(
            num_nodes=2, min_nodes=1, auto_scale=True,
            heartbeat_timeout=0.5, pools={"coworker": 1},
        )
        try:
            nm = master.node_manager
            nm.report_event(base, "started")
            nm.ensure_node(base).last_heartbeat = time.time() - 10
            dead = nm.check_heartbeats()
            master._handle_node_death(base)
            return {"dead": dead, "status": nm.statuses()[base]}
        finally:
            master.stop()

    assert run_both(scenario) == {"dead": [10_000], "status": "pending"}


class _FlakyLauncher:
    def __init__(self):
        self.fail_next_launch = False
        self.launched, self.deleted = [], []

    def launch(self, node_id):
        if self.fail_next_launch:
            self.fail_next_launch = False
            raise RuntimeError("quota")
        self.launched.append(node_id)

    def delete(self, node_id):
        self.deleted.append(node_id)


def test_migration_survives_failed_old_node_and_failed_launch():
    def scenario(ns):
        launcher = _FlakyLauncher()
        nm = ns.nm.NodeManager(num_nodes=1, launcher=launcher,
                               pools={"coworker": 1})
        base = ns.nm.NodeManager.POOL_ID_STRIDE
        nm.report_event(base, "started")
        launcher.fail_next_launch = True
        obs = {"rollback": nm.migrate(base),
               "original": nm.statuses()[base],
               "migrations": len(nm._migrations)}
        new_id = nm.migrate(base)
        obs["new_id"] = new_id
        before = list(launcher.launched)
        nm.report_event(base, "failed", "preempted")
        obs["no_old_relaunch"] = launcher.launched == before
        nm.report_event(new_id, "started")
        obs["retired"] = base in launcher.deleted
        return obs

    got = run_both(scenario)
    assert got["rollback"] is None and got["original"] == "running"
    assert got["migrations"] == 0 and got["new_id"] is not None
    assert got["no_old_relaunch"] and got["retired"]


def test_pool_classifiers_agree_out_of_range():
    def scenario(ns):
        nm = ns.nm.NodeManager(num_nodes=1, pools={"coworker": 2})
        weird = 2 * ns.nm.NodeManager.POOL_ID_STRIDE + 5
        return [nm.pool_of(weird), nm.ensure_node(weird).node_type]

    assert run_both(scenario) == ["worker", "worker"]


def test_silent_death_mid_migration_not_relaunched_and_job_completes():
    def scenario(ns):
        launcher = _FlakyLauncher()
        nm = ns.nm.NodeManager(num_nodes=1, launcher=launcher,
                               pools={"coworker": 1}, heartbeat_timeout=0.5)
        base = ns.nm.NodeManager.POOL_ID_STRIDE
        nm.report_event(0, "started")
        nm.report_event(base, "started")
        new_id = nm.migrate(base)
        nm.ensure_node(base).last_heartbeat = time.time() - 10
        obs = {"dead": base in nm.check_heartbeats()}
        before = list(launcher.launched)
        obs["repair"] = nm.launch_node(base)
        obs["no_relaunch"] = launcher.launched == before
        nm.report_event(new_id, "started")
        nm.report_event(0, "succeeded")
        obs["all_succeeded"] = nm.all_succeeded()
        return obs

    got = run_both(scenario)
    assert got == {"dead": True, "repair": True, "no_relaunch": True,
                   "all_succeeded": True}


def test_migration_rollback_leaves_no_orphan():
    class Failing:
        def launch(self, node_id):
            raise RuntimeError("quota")

        def delete(self, node_id):
            pass

    def scenario(ns):
        nm = ns.nm.NodeManager(num_nodes=1, launcher=Failing(),
                               pools={"coworker": 1})
        base = ns.nm.NodeManager.POOL_ID_STRIDE
        nm.report_event(base, "started")
        obs = {"migrated": nm.migrate(base),
               "coworkers": sorted(nm.statuses(pool="coworker"))}
        nm.report_event(0, "succeeded")
        obs["all_succeeded"] = nm.all_succeeded()
        return obs

    assert run_both(scenario) == {"migrated": None, "coworkers": [10_000],
                                  "all_succeeded": True}


def _master_only_fakes(phases):
    calls = []
    seq = iter(phases)

    class FakeMaster:
        node_manager = type("NM", (), {"job_failure_reason": "boom"})()

        def start(self):
            return 4711

        def bootstrap_nodes(self):
            calls.append("bootstrap")

        def job_phase(self):
            item = next(seq)
            if isinstance(item, BaseException):
                raise item
            return item

        def teardown_nodes(self):
            calls.append("teardown")

        def stop(self):
            calls.append("stop")

    class FakeLauncher:
        def shutdown(self):
            calls.append("shutdown")

    return FakeMaster(), FakeLauncher(), calls


@pytest.mark.parametrize("phases,rc,torn_down", [
    (["succeeded"], 0, True),
    (["failed"], 1, True),
    ([KeyboardInterrupt()], 130, False),
    ([RuntimeError("master crashed")], None, False),
])
def test_master_only_tears_down_only_on_terminal_phase(
    monkeypatch, phases, rc, torn_down
):
    def scenario(ns):
        master, launcher, calls = _master_only_fakes(phases)
        monkeypatch.setattr(ns.run, "build_cluster_master",
                            lambda args: (master, launcher))
        args = types.SimpleNamespace(cloud=True)
        if rc is None:
            with pytest.raises(RuntimeError, match="master crashed"):
                ns.run._run_master_only(args)
            return {"rc": None, "calls": calls}
        return {"rc": ns.run._run_master_only(args), "calls": calls}

    got = run_both(scenario)
    calls = got["calls"]
    assert got["rc"] == rc and ("teardown" in calls) == torn_down
    assert "stop" in calls and "shutdown" in calls
    if torn_down:
        assert calls.index("teardown") < calls.index("stop")


def test_spec_dataclasses_match_the_reference():
    """Every section and field of the spec, with its default."""
    def scenario(ns):
        return {cls.__name__: [(f.name, repr(f.default)) for f in
                               dataclasses.fields(cls)]
                for cls in (ns.spec.ElasticJobSpec, *ns.spec._SECTIONS
                            .values())}

    assert "TrainerSpec" in run_both(scenario)

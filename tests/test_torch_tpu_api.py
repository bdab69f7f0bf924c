"""The port's Cloud TPU API client and the launcher above it against the
reference's, both driven against a local fake Cloud TPU API server.

Each case is ``tests/test_tpu_api.py``'s (the same names, inputs and
assertions), run on both packages, each against a fresh fake server
(``tests/test_tpu_api.FakeCloud`` and its handler: the real v2 JSON
shapes, error envelopes, pagination, metadata-server tokens).  The
records (node views, error statuses, tokens minted, reconcile states)
must agree exactly.  Every URL either client opens is checked to be
127.0.0.1: no test reaches a real cloud or metadata server.
"""

import contextlib
import threading
import time
import types
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from dlrover_tpu.master import cloud_launcher as j_cloud
from dlrover_tpu.master import tpu_api as j_api
from dlrover_tpu_torch.master import cloud_launcher as t_cloud
from dlrover_tpu_torch.master import tpu_api as t_api
from test_torch_master_parity import assert_same
from test_tpu_api import PROJECT, ZONE, FakeCloud, Handler

REF = types.SimpleNamespace(cloud=j_cloud, api=j_api)
PORT = types.SimpleNamespace(cloud=t_cloud, api=t_api)


@pytest.fixture(autouse=True)
def local_only(monkeypatch):
    """Refuse any URL whose host is not 127.0.0.1."""
    urlopen = urllib.request.urlopen

    def guarded(req, *args, **kwargs):
        url = req.full_url if isinstance(req, urllib.request.Request) \
            else str(req)
        host = urllib.parse.urlparse(url).hostname
        if host != "127.0.0.1":
            raise AssertionError(f"a test tried to open {url}")
        return urlopen(req, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", guarded)


@contextlib.contextmanager
def fake_cloud():
    cloud = FakeCloud()
    handler = type("H", (Handler,), {"cloud": cloud})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    cloud.url = f"http://127.0.0.1:{server.server_port}"
    try:
        yield cloud
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def _client(ns, cloud):
    return ns.api.TpuVmHttpClient(
        project=PROJECT, zone=ZONE,
        base_url=cloud.url + "/v2",
        metadata_host=cloud.url,
    )


def run_both(scenario):
    with fake_cloud() as cloud:
        want = scenario(REF, cloud)
    with fake_cloud() as cloud:
        got = scenario(PORT, cloud)
    assert want, "the scenario recorded nothing"
    assert_same(got, want)
    return got


def _status(err):
    return str(err).split(":", 1)[0]


def test_crud_roundtrip_with_real_json_shapes():
    def scenario(ns, cloud):
        client = _client(ns, cloud)
        client.create_node(
            "job-worker-0", "v5litepod-8", "tpu-ubuntu2204-base",
            {"dlrover-master-addr": "10.0.0.2:50051"},
        )
        obs = {"node": client.get_node("job-worker-0"),
               "missing": client.get_node("nope"),
               "listed": [n["name"] for n in client.list_nodes()]}
        client.delete_node("job-worker-0")
        obs["deleted"] = client.get_node("job-worker-0")
        with pytest.raises(ns.cloud.CloudError, match="NOT_FOUND") as err:
            client.delete_node("job-worker-0")
        obs["again"] = _status(err.value)
        return obs

    got = run_both(scenario)
    assert got["node"]["state"] == "READY"
    assert got["node"]["name"] == "job-worker-0"
    assert got["node"]["metadata"]["dlrover-master-addr"] == "10.0.0.2:50051"
    assert got["missing"] is None and got["listed"] == ["job-worker-0"]
    assert got["deleted"] is None and got["again"] == "NOT_FOUND"


def test_create_conflict_and_stockout_map_to_cloud_errors():
    def scenario(ns, cloud):
        client = _client(ns, cloud)
        client.create_node("n0", "v5litepod-8", "rt", {})
        statuses = []
        with pytest.raises(ns.cloud.CloudError, match="ALREADY_EXISTS") as e:
            client.create_node("n0", "v5litepod-8", "rt", {})
        statuses.append(_status(e.value))
        cloud.fail_creates = 1
        with pytest.raises(ns.cloud.CloudError,
                           match="RESOURCE_EXHAUSTED") as e:
            client.create_node("n1", "v5litepod-8", "rt", {})
        statuses.append(_status(e.value))
        return statuses

    assert run_both(scenario) == ["ALREADY_EXISTS", "RESOURCE_EXHAUSTED"]


def test_token_cached_until_expiry():
    def scenario(ns, cloud):
        client = _client(ns, cloud)
        client.create_node("n0", "v5litepod-8", "rt", {})
        client.get_node("n0")
        client.list_nodes()
        minted = [cloud.tokens_minted]
        client._token_expiry = 0.0  # force expiry
        client.get_node("n0")
        minted.append(cloud.tokens_minted)
        return minted

    assert run_both(scenario) == [1, 2]


def test_list_pagination():
    def scenario(ns, cloud):
        client = _client(ns, cloud)
        for i in range(5):
            client.create_node(f"n{i}", "v5litepod-8", "rt", {})
        cloud.page_size = 2  # forces 3 pages
        return sorted(n["name"] for n in client.list_nodes())

    assert run_both(scenario) == [f"n{i}" for i in range(5)]


def test_state_mapping_covers_repair_states():
    states = ["CREATING", "STARTING", "RESTARTING", "REIMAGING", "REPAIRING",
              "READY", "STOPPING", "STOPPED", "DELETING", "TERMINATED",
              "PREEMPTED", "SOMETHING_NEW", ""]

    def scenario(ns, cloud):
        return [ns.api.map_node_state(s) for s in states]

    got = run_both(scenario)
    mapped = dict(zip(states, got))
    assert mapped["REPAIRING"] == mapped["RESTARTING"] == "CREATING"
    assert mapped["PREEMPTED"] == "PREEMPTED"
    assert mapped["STOPPED"] == "TERMINATED"
    assert mapped["SOMETHING_NEW"] == "CREATING"


def _wait_ready(client, name):
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        node = client.get_node(name)
        if node and node["state"] == "READY":
            return node
        time.sleep(0.05)
    return client.get_node(name)


def test_launcher_drives_http_client_launch_preempt_relaunch():
    def scenario(ns, cloud):
        client = _client(ns, cloud)
        launcher = ns.cloud.CloudNodeLauncher(
            client, job_name="job", master_addr="10.0.0.2:50051",
        )
        launcher.RETRY_BACKOFF_S = 0.05
        try:
            launcher.launch(0)
            obs = {"first": _wait_ready(client, "job-worker-0")["state"]}
            with cloud.lock:
                cloud.nodes["job-worker-0"]["state"] = "PREEMPTED"
            obs["preempted"] = launcher.reconcile()
            launcher.launch(0)
            obs["relaunched"] = _wait_ready(client, "job-worker-0")["state"]
            obs["healthy"] = launcher.reconcile()
            return obs
        finally:
            launcher.shutdown()

    got = run_both(scenario)
    assert got["first"] == "READY" and got["preempted"] == {0: "PREEMPTED"}
    assert got["relaunched"] == "READY" and got["healthy"] == {0: "READY"}


def test_stockout_retries_then_succeeds_through_launcher():
    def scenario(ns, cloud):
        client = _client(ns, cloud)
        launcher = ns.cloud.CloudNodeLauncher(client, job_name="job")
        launcher.RETRY_BACKOFF_S = 0.05
        cloud.fail_creates = 2  # transient stockout, 3rd attempt lands
        try:
            launcher.launch(0)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if client.get_node("job-worker-0") is not None:
                    break
                time.sleep(0.05)
            return {"state": client.get_node("job-worker-0")["state"],
                    "fails_left": cloud.fail_creates}
        finally:
            launcher.shutdown()

    assert run_both(scenario) == {"state": "READY", "fails_left": 0}


def test_project_zone_resolution_requires_config(monkeypatch):
    monkeypatch.delenv("GCP_PROJECT", raising=False)
    monkeypatch.delenv("TPU_ZONE", raising=False)

    def scenario(ns, cloud):
        with pytest.raises(ns.cloud.CloudError,
                           match="INVALID_ARGUMENT") as err:
            ns.api.TpuVmHttpClient(metadata_host="http://127.0.0.1:1")
        return [_status(err.value)]

    assert run_both(scenario) == ["INVALID_ARGUMENT"]


def test_make_cloud_launcher_wires_client_and_launcher():
    """``make_cloud_launcher`` (the ``--master-only --cloud`` path) builds
    the HTTP client from explicit project/zone (no metadata lookup) and
    the launcher around it; nothing is created until a launch."""
    def scenario(ns, cloud):
        launcher = ns.api.make_cloud_launcher(
            "job", "127.0.0.1:5000", accelerator_type="v5litepod-16",
            runtime_version="rt-x", preemptible=True, project=PROJECT,
            zone=ZONE)
        try:
            client = launcher.client
            return {"client": type(client).__name__,
                    "project": [client.project, client.zone,
                                client.preemptible],
                    "launcher": [launcher.job_name, launcher.master_addr,
                                 launcher.accelerator_type,
                                 launcher.runtime_version]}
        finally:
            launcher.shutdown()

    got = run_both(scenario)
    assert got["client"] == "TpuVmHttpClient"
    assert got["project"] == [PROJECT, ZONE, True]

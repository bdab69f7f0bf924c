"""The port's HTTP scrape plane, its HBM gauges and the HBM-pressure
operator against the reference's.

The cases are ``tests/test_memory_plane.py``'s HBM-operator, gauge,
``/healthz`` and ``/memory`` cases and ``tests/test_device_profile.py``'s
HTTP-plane cases (the same names, inputs and assertions), each run on
both packages: actions and the ``/healthz`` and ``/memory`` documents must
agree exactly, the ``/metrics`` text and the ``/timeline`` trace byte for
byte.  Beyond them: ``JobMaster(metrics_port=)`` serving a trainer's
memory report over HTTP, both ``/healthz`` branches on one master, and
the plane stopped with the master.  Every server binds 127.0.0.1 and is
shut down inside its test.
"""

import json
import types
import urllib.error
import urllib.request

import pytest

from dlrover_tpu.common import faults as j_faults
from dlrover_tpu.master import calibration as j_cal
from dlrover_tpu.master import diagnosis as j_diag
from dlrover_tpu.master import http_plane as j_http
from dlrover_tpu.master import job_master as j_jm
from dlrover_tpu.master import memory_ledger as j_mem
from dlrover_tpu.master import messages as j_msg
from dlrover_tpu.master import metrics as j_metrics
from dlrover_tpu.master import node_manager as j_nm
from dlrover_tpu.master import servicer as j_srv
from dlrover_tpu.master import speed_monitor as j_sm
from dlrover_tpu.master import timeline as j_tl
from dlrover_tpu_torch.common import faults as t_faults
from dlrover_tpu_torch.master import calibration as t_cal
from dlrover_tpu_torch.master import diagnosis as t_diag
from dlrover_tpu_torch.master import http_plane as t_http
from dlrover_tpu_torch.master import job_master as t_jm
from dlrover_tpu_torch.master import memory_ledger as t_mem
from dlrover_tpu_torch.master import messages as t_msg
from dlrover_tpu_torch.master import metrics as t_metrics
from dlrover_tpu_torch.master import node_manager as t_nm
from dlrover_tpu_torch.master import servicer as t_srv
from dlrover_tpu_torch.master import speed_monitor as t_sm
from dlrover_tpu_torch.master import timeline as t_tl
from test_torch_master_parity import T0, FakeClock, assert_same

REF = types.SimpleNamespace(
    cal=j_cal, diag=j_diag, faults=j_faults, http=j_http, jm=j_jm,
    mem=j_mem, msg=j_msg, metrics=j_metrics, nm=j_nm, srv=j_srv, sm=j_sm,
    tl=j_tl)
PORT = types.SimpleNamespace(
    cal=t_cal, diag=t_diag, faults=t_faults, http=t_http, jm=t_jm,
    mem=t_mem, msg=t_msg, metrics=t_metrics, nm=t_nm, srv=t_srv, sm=t_sm,
    tl=t_tl)


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    for ns in (REF, PORT):
        for mod in (ns.mem, ns.metrics, ns.nm, ns.sm):
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


def _snapshot_attrs(headroom=0.5, in_use=500.0):
    return {
        "bytes_in_use": in_use, "peak_bytes": in_use,
        "limit_bytes": 1000.0, "headroom_frac": headroom,
        "pool_params_b": in_use,
    }


def _http_get(port, path, timeout=5.0):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=timeout
    ) as resp:
        return resp.status, resp.read()


# -- diagnosis (tests/test_memory_plane.py) ----------------------------------


def _ctx(ns, ledger):
    return ns.diag.DiagnosisContext(
        speed_monitor=None, metrics=None, node_manager=None, memory=ledger
    )


def test_hbm_pressure_operator_latches_and_rearms(clock):
    def scenario(ns):
        ledger = ns.mem.MemoryLedger()
        op = ns.diag.HBMPressureOperator()
        obs = [op.observe(_ctx(ns, None)), op.observe(_ctx(ns, ledger))]
        ledger.record(0, **_snapshot_attrs(headroom=0.5))
        ledger.record(1, **_snapshot_attrs(headroom=0.03))
        obs.append(op.observe(_ctx(ns, ledger)))
        obs.append(op.observe(_ctx(ns, ledger)))  # latched
        ledger.record(1, **_snapshot_attrs(headroom=0.4))
        obs.append(op.observe(_ctx(ns, ledger)))  # re-armed
        ledger.record(1, **_snapshot_attrs(headroom=0.02))
        obs.append(op.observe(_ctx(ns, ledger)))
        return obs

    obs = run_both(scenario, clock)
    assert obs[0] == obs[1] == obs[3] == obs[4] == []
    [action] = obs[2]
    assert action.action == t_diag.ActionType.REPORT and action.node_id == 1
    assert "headroom" in action.reason and len(obs[5]) == 1


def test_hbm_pressure_operator_ignores_unknown_headroom(clock):
    def scenario(ns):
        ledger = ns.mem.MemoryLedger()
        ledger.record(0, bytes_in_use=100.0, headroom_frac=-1.0)
        return [ns.diag.HBMPressureOperator().observe(_ctx(ns, ledger)),
                ledger.headroom_frac()]

    assert run_both(scenario, clock) == [[], -1.0]


# -- gauges + exposition lint ------------------------------------------------


def _rendered_everything(ns):
    timeline = ns.tl.JobTimeline()
    timeline.record(0, "step", kind="span", t_wall=T0, duration_s=0.1,
                    attrs={"step": 1})
    ledger = ns.mem.MemoryLedger()
    ledger.record(0, **_snapshot_attrs())
    calibration = ns.cal.CalibrationLedger()
    calibration.observe("ck", "memory", 800.0, 640.0)
    metrics = ns.metrics.MetricsCollector()
    metrics.collect(0, 10.0, 1.0, 2.0, 0.5,
                    device_mem_max_gb=1.5, device_util_max=0.9)
    return timeline.render_metrics(
        speed_monitor=ns.sm.SpeedMonitor(), calibration=calibration,
        memory=ledger, metrics=metrics,
    )


def test_hbm_gauges_render_with_pool_labels(clock):
    def scenario(ns):
        return [_rendered_everything(ns)]

    [text] = run_both(scenario, clock)
    assert "dlrover_hbm_bytes_in_use 500" in text
    assert 'dlrover_hbm_pool_bytes{pool="params"} 500' in text
    assert 'dlrover_hbm_pool_bytes{pool="kv_pool"} 0' in text
    assert "dlrover_hbm_headroom_frac 0.5" in text
    assert 'dlrover_host_device_mem_max_gb{node="0"} 1.5' in text
    assert 'dlrover_host_device_util_max{node="0"} 0.9' in text
    assert 'dlrover_calibration_ratio{phase="memory"}' in text


def test_every_rendered_metric_has_help_and_type(clock):
    def scenario(ns):
        helped, typed, sampled = set(), set(), set()
        for line in _rendered_everything(ns).splitlines():
            if line.startswith("# HELP "):
                helped.add(line.split()[2])
            elif line.startswith("# TYPE "):
                typed.add(line.split()[2])
            elif line.strip():
                sampled.add(line.split("{", 1)[0].split()[0])
        return [sorted(sampled), sorted(sampled - helped),
                sorted(sampled - typed)]

    sampled, unhelped, untyped = run_both(scenario, clock)
    assert sampled and unhelped == [] and untyped == []


# -- /healthz and /memory ----------------------------------------------------


def _plane(ns, hbm_floor=0.0, headroom=None):
    ledger = ns.mem.MemoryLedger()
    if headroom is not None:
        ledger.record(0, **_snapshot_attrs(headroom=headroom))
    servicer = ns.srv.MasterServicer(
        timeline=ns.tl.JobTimeline(), memory_ledger=ledger
    )
    return ns.http.MetricsHTTPServer(servicer, healthz_hbm_floor=hbm_floor)


def test_healthz_hbm_floor_default_off(clock):
    def scenario(ns):
        return _plane(ns, hbm_floor=0.0, headroom=0.01).healthz()

    health = run_both(scenario, clock)
    assert health["ok"] is True
    assert health["hbm_headroom_frac"] == pytest.approx(0.01)


def test_healthz_flips_below_hbm_floor(clock):
    def scenario(ns):
        return [_plane(ns, hbm_floor=0.05, headroom=h).healthz()
                for h in (0.01, 0.2, None)]

    low, high, unknown = run_both(scenario, clock)
    assert low["ok"] is False and high["ok"] is True
    assert unknown["ok"] is True and unknown["hbm_headroom_frac"] == -1.0


def test_memory_endpoint_payload(clock):
    def scenario(ns):
        return [_plane(ns, headroom=0.5).memory_json()]

    [body] = run_both(scenario, clock)
    payload = json.loads(body)
    assert payload["ledger"]["nodes"] == 1
    assert payload["nodes"]["0"]["bytes_in_use"] == 500.0


# -- the HTTP server (tests/test_device_profile.py) --------------------------


def test_http_plane_serves_metrics_timeline_healthz(clock):
    def scenario(ns):
        timeline = ns.tl.JobTimeline()
        timeline.record(0, "step", kind="span", t_wall=T0, duration_s=0.1,
                        attrs={"step": 1})
        nodes = ns.nm.NodeManager(num_nodes=2)
        ledger = ns.cal.CalibrationLedger()
        ledger.observe("k", "compute", 1.5, 1.0)
        servicer = ns.srv.MasterServicer(
            timeline=timeline, node_manager=nodes,
            speed_monitor=ns.sm.SpeedMonitor(), calibration=ledger,
        )
        plane = ns.http.MetricsHTTPServer(servicer, host="127.0.0.1",
                                          port=0)
        port = plane.start()
        try:
            obs = {"metrics": _http_get(port, "/metrics"),
                   "rpc_parity": _http_get(port, "/metrics")[1]
                   == servicer._get_metrics_text(None).encode(),
                   "timeline": _http_get(port, "/timeline"),
                   "healthz": json.loads(_http_get(port, "/healthz")[1])}
            nodes.quarantine(1, "sdc")
            obs["quarantined"] = json.loads(_http_get(port, "/healthz")[1])
            with pytest.raises(urllib.error.HTTPError) as err:
                _http_get(port, "/teapot")
            obs["teapot"] = err.value.code
            return obs
        finally:
            plane.stop()

    got = run_both(scenario, clock)
    assert got["metrics"][0] == 200 and got["rpc_parity"]
    assert b"dlrover_calibration_ratio" in got["metrics"][1]
    trace = json.loads(got["timeline"][1])
    assert any(e.get("name") == "step" for e in trace["traceEvents"])
    assert got["healthz"]["ok"] is True and got["healthz"]["quarantined"] == []
    assert got["quarantined"]["ok"] is False
    assert got["quarantined"]["quarantined"] == [1] and got["teapot"] == 404


def test_http_plane_seam_answers_503(clock):
    def scenario(ns):
        servicer = ns.srv.MasterServicer(timeline=ns.tl.JobTimeline())
        plane = ns.http.MetricsHTTPServer(servicer, host="127.0.0.1", port=0)
        port = plane.start()
        try:
            ns.faults.configure("http.serve:error")
            with pytest.raises(urllib.error.HTTPError) as err:
                _http_get(port, "/metrics")
            obs = [err.value.code]
            ns.faults.reset()
            obs.append(_http_get(port, "/metrics")[0])
            return obs
        finally:
            ns.faults.reset()
            plane.stop()

    assert run_both(scenario, clock) == [503, 200]


# -- the master's plane ------------------------------------------------------


def _memory_event(ns, node, headroom, step):
    """A trainer's ``memory`` report as its telemetry ships it."""
    return ns.msg.Envelope(node_id=node, payload=ns.msg.TelemetryEvents(
        node_id=node, events=[("memory", "event", T0 + step, 0.0, {
            "step": step, "bytes_in_use": 600.0, "peak_bytes": 700.0,
            "limit_bytes": 1000.0, "headroom_frac": headroom,
            "pool_params_b": 574.0, "pool_opt_state_b": 21.0})]))


def test_job_master_serves_the_plane_both_branches(clock):
    """``JobMaster(metrics_port=, healthz_hbm_floor=)`` starts the plane
    with the master and stops it with the master; ``/healthz`` reads -1
    headroom with ``hbm_ok`` before any memory report, and flips not-ok
    under the floor once a trainer's report lands; ``/memory`` lists the
    node's pools."""
    def scenario(ns):
        from dlrover_tpu_torch.master.messages import free_port

        master = ns.jm.JobMaster(num_nodes=1, metrics_port=free_port(),
                                 healthz_hbm_floor=0.999)
        master.start()
        port = master.metrics_port
        try:
            obs = {"before": json.loads(_http_get(port, "/healthz")[1])}
            master.servicer.report(_memory_event(ns, 0, 0.4, 4))
            obs["after"] = json.loads(_http_get(port, "/healthz")[1])
            obs["memory"] = json.loads(_http_get(port, "/memory")[1])
            text = _http_get(port, "/metrics")[1].decode()
            obs["gauges"] = sorted(
                line.split(" ")[0] for line in text.splitlines()
                if line.startswith(("dlrover_hbm", "dlrover_goodput")))
        finally:
            master.stop()
        obs["stopped"] = master.http_plane is None
        with pytest.raises(urllib.error.URLError):
            _http_get(port, "/healthz", timeout=1.0)
        return obs

    got = run_both(scenario, clock)
    before, after = got["before"], got["after"]
    assert before["hbm_headroom_frac"] == -1.0 and before["hbm_ok"] is True
    assert 0.0 <= after["hbm_headroom_frac"] < 0.999
    assert after["hbm_ok"] is False and after["ok"] is False
    assert after["quarantined"] == []
    assert got["memory"]["nodes"]["0"]["pool_params_b"] == 574.0
    assert 'dlrover_hbm_pool_bytes{pool="params"}' in got["gauges"]
    assert "dlrover_goodput" in got["gauges"] and got["stopped"]

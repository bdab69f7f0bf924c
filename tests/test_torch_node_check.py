"""The port's pre-flight node check on the CPU: its probes against the
reference's chain, the golden digest, the check rounds against a master,
and the launcher run from a job spec with ``--network-check``.

- The probe chain (``iters`` times ``x @ x`` renormalized by rsqrt(dim) in
  bf16) is held against the same chain run in JAX on the same numpy input
  (``probe_input``: a seeded CPU generator, rounded to bf16) within
  ``CHAIN_RTOL`` = 1e-2 of the reference's norm (bf16 carries 8 bits; the
  chain of 4 squarings at 512 measures 1.7e-3).
- The golden-replay check and the check rounds (``golden_replay_check``,
  ``run_network_check``) are held against the reference's with the
  probes' results fixed in both packages: the same verdicts, KV writes and
  reports.
- A probe on ``cuda`` without a card reports the node unhealthy and never
  reruns on the CPU.
- The launcher from a spec (the reference's slow end-to-end case, and the
  CPU rehearsal of ``chip_smoke.py``'s ``elastic_run``): a master built by
  the spec-to-kwargs helper with its HTTP plane, the agent's ``node_check``
  span, two check rounds, the master's verdict and the golden digest.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import types
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.agent import node_check as j_nc
from dlrover_tpu.agent import master_client as j_client
from dlrover_tpu.master import job_master as j_jm
from dlrover_tpu_torch.agent import master_client as t_client
from dlrover_tpu_torch.agent import node_check as t_nc
from dlrover_tpu_torch.master import job_master as t_jm
from dlrover_tpu_torch.master.messages import free_port
from test_torch_master_parity import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = types.SimpleNamespace(nc=j_nc, jm=j_jm, client=j_client)
PORT = types.SimpleNamespace(nc=t_nc, jm=t_jm, client=t_client)
CHAIN_RTOL = 1e-2


def _jax_chain(x_np, iters):
    """The reference's probe chain (``dlrover_tpu/agent/node_check.py``)."""
    dim = x_np.shape[0]

    @jax.jit
    def chain(x):
        for _ in range(iters):
            x = x @ x
            x = x * jax.lax.rsqrt(jnp.float32(dim)).astype(x.dtype)
        return x

    out = chain(jnp.asarray(x_np, jnp.bfloat16))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dim,iters", [(64, 4), (128, 8), (512, 4)])
def test_probe_chain_matches_the_reference_chain(dim, iters):
    x = t_nc.probe_input(dim)
    assert x.dtype == torch.bfloat16 and x.device.type == "cpu"
    got = t_nc._chain(x, iters).float().numpy()
    want = _jax_chain(x.float().numpy(), iters)
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= CHAIN_RTOL, rel


def test_digest_is_the_chains_bits_and_stable():
    digest = t_nc.probe_result_digest(device="cpu")
    assert re.fullmatch(r"[0-9a-f]{8}", digest)
    assert digest == t_nc.probe_result_digest(device="cpu")
    bits = t_nc._chain(t_nc.probe_input(t_nc.DIGEST_DIM),
                       t_nc.DIGEST_ITERS).view(torch.int16).numpy()
    assert digest == f"{zlib.crc32(bits.tobytes()) & 0xFFFFFFFF:08x}"


def test_probe_pins_the_reduction_flag():
    flag = torch.backends.cuda.matmul
    saved = flag.allow_bf16_reduced_precision_reduction
    try:
        flag.allow_bf16_reduced_precision_reduction = True
        seen = []
        real = t_nc._chain

        def spy(x, iters):
            seen.append(flag.allow_bf16_reduced_precision_reduction)
            return real(x, iters)

        t_nc._chain = spy
        try:
            t_nc.probe_result_digest(matrix_dim=32, device="cpu")
            t_nc.matmul_probe(32, iters=2, device="cpu")
        finally:
            t_nc._chain = real
        assert seen == [False, False, False]
        assert flag.allow_bf16_reduced_precision_reduction is True
    finally:
        flag.allow_bf16_reduced_precision_reduction = saved


def test_matmul_and_allreduce_probes_on_cpu():
    tflops = t_nc.matmul_probe(64, iters=2, device="cpu")
    assert np.isfinite(tflops) and tflops > 0
    # One local device: no all-reduce (the reference's (0.0, 0.0)).
    assert t_nc.allreduce_probe(device="cpu") == (0.0, 0.0)
    healthy, elapsed = t_nc.run_probe_payload(device="cpu")
    assert healthy and elapsed > 0


def test_cuda_probe_without_a_card_fails_and_stays_off_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the failure path needs none")
    devices = []
    real = t_nc.matmul_probe

    def spy(matrix_dim, iters=8, device="cuda"):
        devices.append(torch.device(device).type)
        return real(matrix_dim, iters, device)

    monkeypatch.setattr(t_nc, "matmul_probe", spy)
    healthy, elapsed = t_nc.run_probe_payload(device="cuda")
    assert not healthy and elapsed >= 0
    assert devices == ["cuda"]  # tried once, on the card, never the CPU


class _KV:
    """The two KV calls the golden check makes, on a dict."""

    def __init__(self):
        self.kv, self.puts = {}, []

    def kv_get(self, key):
        return self.kv.get(key)

    def kv_put(self, key, value):
        self.puts.append((key, value))
        self.kv[key] = value


def test_golden_replay_records_then_compares(monkeypatch):
    def scenario(ns):
        digests = iter(["aaaa0001", "aaaa0001", "bbbb0002"])
        monkeypatch.setattr(ns.nc, "probe_result_digest",
                            lambda *a, **k: next(digests))
        kv = _KV()
        verdicts = [ns.nc.golden_replay_check(kv, 3) for _ in range(3)]
        return {"verdicts": verdicts, "puts": kv.puts}

    want, got = scenario(REF), scenario(PORT)
    assert_same(got, want)
    assert got["verdicts"] == [True, True, False]
    assert got["puts"] == [("node_check_golden/3", b"aaaa0001")]


def test_check_rounds_against_a_master(monkeypatch):
    """``run_network_check`` against each package's master over its own
    transport, the probe's result fixed: two rounds, the golden digest in
    the KV store, the master's verdict ``done`` with no fault node; then a
    failing probe makes the node a fault node."""
    def scenario(ns, healthy):
        monkeypatch.setattr(ns.nc, "run_probe_payload",
                            lambda *a, **k: (healthy, 0.25))
        monkeypatch.setattr(ns.nc, "probe_result_digest",
                            lambda *a, **k: "cafef00d")
        master = ns.jm.JobMaster(port=0, num_nodes=1)
        port = master.start()
        client = ns.client.MasterClient(f"localhost:{port}", node_id=0)
        try:
            ok = ns.nc.run_network_check(client, 0)
            netcheck = master.rdzv_managers["network-check"]
            return {"ok": ok, "golden": master.kv_store.get(
                "node_check_golden/0"), "round": netcheck._rdzv_round,
                "result": client.get_network_check_result()}
        finally:
            client.close()
            master.stop()

    for healthy in (True, False):
        want, got = scenario(REF, healthy), scenario(PORT, healthy)
        assert_same(got, want)
        assert got["ok"] is healthy and got["golden"] == b"cafef00d"
        assert got["round"] == 2 and got["result"].reason == "done"


def _unlink_arena(job):
    path = f"/dev/shm/dlrover_tpu_ckpt_{job}_h0"
    if os.path.exists(path):
        os.unlink(path)


def test_launcher_from_a_spec_with_the_network_check(tmp_path):
    """``python -m dlrover_tpu_torch.run --job-spec`` (``[trainer]``
    network_check, max_restarts and monitor_interval; ``[checkpoint]``
    dir) against a master built by ``run._master_kwargs_from_spec`` with
    its HTTP plane; the check runs on the CPU (``--node-check-device``)."""
    from dlrover_tpu_torch import run
    from dlrover_tpu_torch.common.job_spec import load_job_spec
    from dlrover_tpu_torch.common.storage import (
        CheckpointDirLayout,
        PosixDiskStorage,
    )

    ckpt = str(tmp_path / "ckpt")
    spec_path = tmp_path / "job.toml"
    spec_path.write_text(f"""
api_version = "dlrover-tpu/v1"
job_name = "nodecheck"

[nodes]
min = 1
max = 1

[master]
hang_threshold = 60

[trainer]
network_check = true
max_restarts = 1
monitor_interval = 1

[checkpoint]
dir = "{ckpt}"
""")
    spec = load_job_spec(str(spec_path))
    master = t_jm.JobMaster(port=0, num_nodes=1, metrics_port=free_port(),
                            healthz_hbm_floor=0.999,
                            **run._master_kwargs_from_spec(spec))
    spans = []
    evict = master.timeline.evict_node

    def keep_spans(node_id):
        spans.extend(e for e in master.timeline.events(node_id).get(
            node_id, []) if e[0] == "node_check")
        evict(node_id)

    master.timeline.evict_node = keep_spans
    port = master.start()
    scrapes = []
    stop = threading.Event()

    def poll():
        while not stop.wait(0.5):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{master.metrics_port}/healthz",
                    timeout=5) as resp:
                scrapes.append(json.loads(resp.read()))

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    job = f"nc{os.getpid()}"
    env = dict(os.environ, DLROVER_TPU_JOB=job,
               DLROVER_TPU_SOCKET_DIR=str(tmp_path / "socks"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for key in ("DLROVER_TPU_RESTART_COUNT", "DLROVER_TPU_MASTER_ADDR",
                "DLROVER_TPU_COORDINATOR", "XLA_FLAGS"):
        env.pop(key, None)
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run",
           "--master", f"localhost:{port}", "--node-id", "0",
           "--job-spec", str(spec_path), "--node-check-device", "cpu", "--",
           sys.executable, "-m", "dlrover_tpu_torch.examples.train_lm",
           "--device", "cpu", "--layers", "1", "--d-model", "64",
           "--heads", "2", "--seq-len", "64", "--batch-size", "4",
           "--steps", "4", "--ckpt-every", "2", "--checkpoint-dir", ckpt]
    try:
        result = subprocess.run(cmd, env=env, cwd=REPO, timeout=240,
                                capture_output=True, text=True)
        log = result.stdout + result.stderr
        assert result.returncode == 0, log[-3000:]
        golden = master.kv_store.get("node_check_golden/0")
        netcheck = master.rdzv_managers["network-check"]
        verdict = netcheck.check_fault_node()
        diagnosis = master.diagnosis
    finally:
        stop.set()
        poller.join(timeout=10)
        master.stop()
        _unlink_arena(job)
    assert "node check: matmul" in log and "golden digest" in log
    assert [s[4].get("ok") for s in spans] == [True]
    assert netcheck._rdzv_round == 2 and verdict == ([], "done")
    assert re.fullmatch(rb"[0-9a-f]{8}", golden)
    assert diagnosis.cooldown_s == 60 and diagnosis.reports == []
    assert scrapes and all(s["hbm_headroom_frac"] == -1.0 and s["hbm_ok"]
                           for s in scrapes)
    assert CheckpointDirLayout(ckpt).latest_step(PosixDiskStorage()) == 4

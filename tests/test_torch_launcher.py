"""The port's launcher end to end on the CPU: ``python -m
dlrover_tpu_torch.run`` -> a master -> the elastic agent -> the ported
``train_lm`` in a subprocess, with a crash, an agent-driven restart and a
resume from Flash Checkpoint.

The first case mirrors ``tests/test_elastic_e2e.py::
test_cli_crash_restart_resume`` (standalone master, exit 17 at step 6,
resume at step 4, committed step 8).  The second runs two agents against
one port master at world 2 with the control-plane-only trainer
(``DLROVER_TPU_SKIP_JAX_INIT=1``): both join round 1, node 0's trainer
crashes, and both restart into round 2.  Each launcher runs under
``timeout=`` (no pytest-timeout here).
"""

import os
import re
import subprocess
import sys

from dlrover_tpu_torch.common.storage import (
    CheckpointDirLayout,
    PosixDiskStorage,
)
from dlrover_tpu_torch.master.job_master import JobMaster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--layers", "1", "--d-model", "64", "--heads",
        "2", "--seq-len", "64", "--batch-size", "4"]


def _env(tmp_path, tag):
    env = dict(os.environ)
    for key in ("DLROVER_TPU_RESTART_COUNT", "DLROVER_TPU_MASTER_ADDR",
                "DLROVER_TPU_COORDINATOR", "XLA_FLAGS"):
        env.pop(key, None)
    env.update({
        "DLROVER_TPU_SOCKET_DIR": str(tmp_path / f"socks_{tag}"),
        # Unique per run: the shm arena is named by the job tag and
        # outlives processes.
        "DLROVER_TPU_JOB": f"tl{os.getpid()}{tag}",
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    })
    return env


def _unlink_arenas(env, hosts=(0,)):
    for host in hosts:
        path = f"/dev/shm/dlrover_tpu_ckpt_{env['DLROVER_TPU_JOB']}_h{host}"
        if os.path.exists(path):
            os.unlink(path)


def _trainer(ckpt_dir, *extra):
    return [sys.executable, "-m", "dlrover_tpu_torch.examples.train_lm",
            *TINY, "--checkpoint-dir", ckpt_dir, *extra]


def test_cli_crash_restart_resume(tmp_path):
    """The trainer crashes at step 6 (after the step-4 checkpoint); the
    agent restarts it in place; it resumes from step 4 and completes."""
    ckpt_dir = str(tmp_path / "ckpt")
    env = _env(tmp_path, "s")
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
           "--max-restarts", "2", "--monitor-interval", "1",
           "--checkpoint-dir", ckpt_dir, "--",
           *_trainer(ckpt_dir, "--steps", "8", "--ckpt-every", "4",
                     "--fail-at-step", "6")]
    try:
        result = subprocess.run(cmd, env=env, cwd=REPO, timeout=240,
                                capture_output=True, text=True)
    finally:
        _unlink_arenas(env)
    log = result.stdout + result.stderr
    assert result.returncode == 0, log[-3000:]
    assert "crashing at step 6" in log
    assert "resumed from checkpoint at step 4" in log
    assert re.findall(r"starting trainer \(round (\d+)", log) == ["1", "2"]
    assert CheckpointDirLayout(ckpt_dir).latest_step(PosixDiskStorage()) == 8


def test_two_agents_restart_into_round_two(tmp_path):
    """Two agents, one master, world 2.  Node 0's trainer crashes at step
    4; its agent reports the failure and re-joins, node 1's agent sees
    the broken world and restarts its own trainer (half a second a step
    leaves it 6 s short of its last step then), and both seal round 2
    and finish."""
    master = JobMaster(port=0, num_nodes=2)
    port = master.start()
    env = _env(tmp_path, "w")
    env["DLROVER_TPU_SKIP_JAX_INIT"] = "1"
    # One checkpoint directory, as a job's hosts share one: the commit
    # barrier waits for both hosts' files of a step.
    ckpt_dir = str(tmp_path / "ckpt")
    procs = []
    try:
        for node in (0, 1):
            crash = ["--fail-at-step", "4"] if node == 0 else []
            cmd = [sys.executable, "-m", "dlrover_tpu_torch.run",
                   "--master", f"localhost:{port}", "--nnodes", "2",
                   "--node-id", str(node), "--max-restarts", "2",
                   "--monitor-interval", "1", "--checkpoint-dir", ckpt_dir,
                   "--", *_trainer(
                       ckpt_dir, "--steps", "16", "--ckpt-every", "2",
                       "--step-sleep", "0.5", "--lockstep-data", *crash)]
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=240)[0] for p in procs]
        rounds = [re.findall(r"starting trainer \(round (\d+), rank (\d)/2",
                             log) for log in logs]
        assert [p.returncode for p in procs] == [0, 0], \
            logs[0][-2000:] + logs[1][-2000:]
        assert rounds == [[("1", "0"), ("2", "0")], [("1", "1"), ("2", "1")]]
        assert "crashing at step 4" in logs[0]
        assert "crashing" not in logs[1]
        assert "membership changed: restarting" in logs[1]
        assert master.rdzv_managers["elastic-training"]._rdzv_round == 2
        assert master.job_phase() == "succeeded"
        assert master.speed_monitor.global_step == 16
        assert CheckpointDirLayout(ckpt_dir).latest_step(
            PosixDiskStorage()) == 16
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        master.stop()
        _unlink_arenas(env, hosts=(0, 1))

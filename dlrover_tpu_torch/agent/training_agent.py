"""Per-host elastic agent: supervise the trainer process, restart on
failure (port of ``dlrover_tpu/agent/training_agent.py``).

Capability ref: ``dlrover/python/elastic_agent/torch/training.py:352-715``
(``ElasticTrainingAgent``: ``_rendezvous``, ``_invoke_run`` monitor loop,
``_restart_workers``, ``_membership_changed``, ``_save_ckpt_to_storage``)
and ``MasterRendezvousHandler:172-349``.

As in the reference, the agent supervises a single trainer subprocess and
elasticity is host-granular.  The rendezvous world {host_rank: devices}
reaches the trainer through the environment (coordinator ``host:port``,
process count, process id, restart count), which
``runtime/env.initialize`` turns into ``torch.distributed.
init_process_group``.  The pre-flight network check (``--network-check``,
``agent/node_check.py``) is ROADMAP Queue 1 item 10b's remainder and is
refused.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
from enum import Enum
from typing import Dict, List, Optional

from dlrover_tpu_torch.common import faults, telemetry
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.retry import RetryPolicy
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.master.rdzv_manager import RendezvousName

from dlrover_tpu_torch.common.constants import ConfigKey

# Environment contract agent -> trainer (canonical names in ConfigKey).
ENV_MASTER_ADDR = ConfigKey.MASTER_ADDR
ENV_NODE_ID = ConfigKey.NODE_ID
ENV_COORDINATOR = "DLROVER_TPU_COORDINATOR"
ENV_NUM_PROC = "DLROVER_TPU_NUM_PROCESSES"
ENV_PROC_ID = "DLROVER_TPU_PROCESS_ID"
ENV_RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"

_COORD_PORT_KEY = "rdzv/coordinator/{round}"


def _routable_ip(master_addr: str) -> str:
    """This host's IP as seen on the route to the master.

    ``gethostbyname(gethostname())`` commonly yields 127.0.1.1 (Debian-style
    /etc/hosts), which other hosts cannot dial; the connected-UDP trick asks
    the kernel for the interface actually used to reach the cluster.
    """
    import socket

    host = master_addr.rsplit(":", 1)[0] or "localhost"
    try:
        # Connected-UDP local-address probe: the kernel resolves the
        # route without sending a packet, so there is no I/O to seam.
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:  # tracelint: disable=SEAM001
            s.connect((host, 1))
            ip = s.getsockname()[0]
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        # A host whose own name does not resolve (a sealed machine with
        # no resolver entry for it) can still coordinate on loopback.
        return "127.0.0.1"


@dataclasses.dataclass
class ElasticLaunchConfig:
    """ref ``ElasticLaunchConfig`` ``training.py:112-162``."""

    min_nodes: int = 1
    max_nodes: int = 1
    node_unit: int = 1
    max_restarts: int = 3
    monitor_interval: float = 5.0
    network_check: bool = False
    save_at_breakpoint: bool = False
    checkpoint_dir: str = ""
    rdzv_timeout: float = 600.0
    local_world_size: int = 0  # 0 -> discover (local chip count)
    heartbeat_interval: float = 15.0
    resource_report_interval: float = 30.0
    # Grace window a preemption notice grants before the host vanishes:
    # the drain (shm flush -> master notice -> trainer stop) must fit
    # inside it.  Cloud maintenance events give 30-60s.
    preempt_grace_s: float = 30.0
    # Virtual-mesh mode: on membership change, re-join the rendezvous to
    # adopt the new round but KEEP the trainer process — the trainer
    # itself folds/fans its logical mesh onto the surviving members
    # (ElasticTrainer.apply_world_change), so a resize costs a re-layout
    # in memory instead of a restart + checkpoint restore.
    live_relayout: bool = False
    # Device-init watchdog: a freshly started trainer that produces no
    # first step report within this bound is stuck below Python (a wedged
    # driver, a hung device init) — a failure mode the
    # generic heartbeat can NEVER catch, because the agent process itself
    # stays healthy and keeps heartbeating while the trainer hangs at
    # backend init.  0 disables.  Generous default: first-compile of a
    # multi-B model is legitimately minutes.
    device_init_timeout: float = 900.0


class RunResult(Enum):
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    STOPPED = "stopped"


class MasterRendezvousHandler:
    """Join master rendezvous, poll for the sealed world, agree coordinator."""

    def __init__(
        self, client: MasterClient, node_rank: int, config: ElasticLaunchConfig
    ):
        self._client = client
        self._node_rank = node_rank
        self._config = config

    def next_rendezvous(self) -> Dict:
        """Returns {round, world, rank, coordinator}."""
        local_world = self._config.local_world_size or 1
        deadline = time.monotonic() + self._config.rdzv_timeout
        def _join():
            # The ``rdzv.join`` seam scripts a transient join failure
            # (the flaky-control-plane moment right after a resize);
            # retries burn the same rendezvous deadline as the poll.
            faults.fire("rdzv.join")
            self._client.join_rendezvous(
                self._node_rank, local_world,
                RendezvousName.TRAINING, self._config.node_unit,
            )

        # retryable=() keeps real join errors fatal (master_client already
        # retries transport); injected faults are always retryable.
        RetryPolicy(
            max_attempts=1000, base_delay_s=0.5, max_delay_s=0.5,
            jitter=False, retryable=(),
            deadline_s=max(0.1, deadline - time.monotonic()),
            name="rdzv.join",
        ).call(_join)
        while time.monotonic() < deadline:
            state = self._client.get_comm_world(
                self._node_rank, RendezvousName.TRAINING
            )
            if state.world and self._node_rank in state.world:
                ranks = sorted(state.world)
                my_index = ranks.index(self._node_rank)
                coordinator = self._agree_coordinator(
                    state.round, my_index == 0
                )
                return {
                    "round": state.round,
                    "world": state.world,
                    "rank": my_index,
                    "coordinator": coordinator,
                }
            time.sleep(1.0)
        raise TimeoutError(
            f"rendezvous did not complete in {self._config.rdzv_timeout}s"
        )

    def _agree_coordinator(self, round_: int, am_rank0: bool) -> str:
        """Rank 0 publishes host:port via master kv (ref ``training.py:413-430``
        where rank-0 picks a free port and writes it to the store)."""
        key = _COORD_PORT_KEY.format(round=round_)
        if am_rank0:
            from dlrover_tpu_torch.master.messages import free_port

            addr = f"{_routable_ip(self._client._addr)}:{free_port()}"
            self._client.kv_put(key, addr.encode())
            return addr
        value = None
        deadline = time.monotonic() + 60
        while value is None and time.monotonic() < deadline:
            value = self._client.kv_get(key)
            if value is None:
                time.sleep(0.5)
        if value is None:
            raise TimeoutError("coordinator address never published")
        return value.decode()


class ElasticAgent:
    """Supervises one trainer subprocess; the restart-in-place state machine."""

    def __init__(
        self,
        config: ElasticLaunchConfig,
        entrypoint: List[str],
        master_addr: str,
        node_id: int = 0,
    ):
        if config.network_check:
            raise NotImplementedError(
                "the pre-flight network check (agent/node_check.py) is not "
                "ported yet (ROADMAP Queue 1 item 10b's remainder)"
            )
        self.config = config
        self.entrypoint = entrypoint
        self.master_addr = master_addr
        self.node_id = node_id
        self.client = MasterClient(master_addr, node_id=node_id)
        # Own recorder (not the module singleton): in-process tests run
        # agent and trainer side by side, and their streams must keep
        # distinct ``src`` lanes in the merged timeline.
        self.telemetry = telemetry.TelemetryRecorder(source="agent")
        self._rdzv = MasterRendezvousHandler(self.client, node_id, config)
        self._proc: Optional[subprocess.Popen] = None
        self._restart_count = 0
        self._current_round = -1
        self._stop = threading.Event()
        # Preemption drain latch: set by the ResourceMonitor's notice
        # callback (any thread); the monitor loop runs the actual drain.
        self._preempt_event = threading.Event()
        self._preempt_reason = ""
        self._saver: Optional[AsyncCheckpointSaver] = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._resource_monitor = None
        self._paral_config_version = 0
        self._log_path: Optional[str] = None
        self._log_pump: Optional[threading.Thread] = None
        self._log_pump_stop = threading.Event()
        # Device-init watchdog state, reset per worker start.
        self._worker_started_wallclock = 0.0
        self._first_step_confirmed = False
        self._last_log_size = -1
        self._last_activity_wallclock = 0.0

    def _metrics_file(self) -> str:
        """Trainer->agent device-telemetry handoff file (ref
        ``monitor/training.py`` metrics-file seam)."""
        from dlrover_tpu_torch.common.multi_process import socket_dir

        os.makedirs(socket_dir(), exist_ok=True)
        return os.path.join(socket_dir(), f"metrics_n{self.node_id}.json")

    def _stack_file(self) -> str:
        """Where the trainer's SIGUSR1 faulthandler dumps its stacks."""
        from dlrover_tpu_torch.common.multi_process import socket_dir

        os.makedirs(socket_dir(), exist_ok=True)
        return os.path.join(socket_dir(), f"stacks_n{self.node_id}.txt")

    def dump_trainer_stacks(self, timeout_s: float = 3.0) -> str:
        """Collect live Python stacks from the trainer (hang diagnosis;
        ref ``datacollector/cuda_log_collector.py``)."""
        from dlrover_tpu_torch.agent.stack_collector import collect_stacks

        if self._proc is None or self._proc.poll() is not None:
            return ""
        return collect_stacks(
            self._proc.pid, self._stack_file(), timeout_s=timeout_s
        )

    def _paral_config_file(self) -> str:
        """Master->trainer runtime-tunable-config handoff file (ref
        ``elastic_agent/config/paral_config_tuner.py:30-78``)."""
        from dlrover_tpu_torch.common.multi_process import socket_dir

        os.makedirs(socket_dir(), exist_ok=True)
        return os.path.join(
            socket_dir(), f"paral_config_n{self.node_id}.json"
        )

    def _poll_paral_config(self):
        """Fetch the master's runtime config; rewrite the trainer-visible
        file only when the version advances."""
        import dataclasses as _dc
        import json

        try:
            config = self.client.get_paral_config()
        except ConnectionError:
            return
        except Exception as e:  # noqa: BLE001 - config must not kill agent
            logger.warning("paral config poll failed: %s", e)
            return
        if config is None or config.version == self._paral_config_version:
            return
        self._paral_config_version = config.version
        path = self._paral_config_file()
        tmp = path + ".tmp"
        # Seam: config handoff to the trainer is a storage write the
        # drills must reach (a torn config file is a real incident).
        faults.fire("storage.write", path=os.path.basename(path))
        with open(tmp, "w") as f:
            json.dump(_dc.asdict(config), f)
        os.replace(tmp, path)
        logger.info(
            "paral config v%d written for trainer", config.version
        )

    # -- worker lifecycle -----------------------------------------------------

    def _tail_log(self, n: int = 80) -> str:
        """Last lines of the trainer's captured output (diagnosis payload,
        ref ``elastic_agent/datacollector/log_collector.py``)."""
        # Let the pump hit pipe EOF and write the final lines (the crash
        # traceback is exactly what this tail exists to deliver).
        if self._log_pump is not None:
            self._log_pump.join(timeout=3.0)
        if not self._log_path or not os.path.exists(self._log_path):
            return ""
        try:
            faults.fire(
                "storage.read", path=os.path.basename(self._log_path)
            )
            with open(self._log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - 16384))
                lines = f.read().decode(errors="replace").splitlines()
            return "\n".join(lines[-n:])
        except (OSError, faults.FaultInjected):
            return ""

    def _start_workers(self) -> Dict:
        # The rendezvous span IS the job's idle gap: its duration in the
        # merged timeline is time this host spent outside training.
        with self.telemetry.span("rendezvous") as sp:
            rdzv = self._rdzv.next_rendezvous()
            if sp is not None:
                sp.attrs["round"] = rdzv["round"]
                sp.attrs["world"] = len(rdzv["world"])
        self._current_round = rdzv["round"]
        env = dict(os.environ)
        env.update(
            {
                ENV_MASTER_ADDR: self.master_addr,
                ENV_NODE_ID: str(self.node_id),
                ENV_COORDINATOR: rdzv["coordinator"],
                ENV_NUM_PROC: str(len(rdzv["world"])),
                ENV_PROC_ID: str(rdzv["rank"]),
                ENV_RESTART_COUNT: str(self._restart_count),
                ConfigKey.METRICS_FILE: self._metrics_file(),
                ConfigKey.PARAL_CONFIG_PATH: self._paral_config_file(),
                # Stack-dump seam (agent/stack_collector.py): the trainer
                # bootstrap registers a SIGUSR1 faulthandler writing here.
                "DLROVER_TPU_STACK_FILE": self._stack_file(),
                # Piped stdout would flip the trainer to 8KB block
                # buffering, holding back exactly the final prints the
                # failure-report log tail exists to capture.
                "PYTHONUNBUFFERED": "1",
            }
        )
        logger.info(
            "starting trainer (round %d, rank %d/%d): %s",
            rdzv["round"], rdzv["rank"], len(rdzv["world"]),
            " ".join(self.entrypoint),
        )
        if self._saver is not None:
            # The commit barrier counts done-files of the *sealed* world, not
            # max_nodes — an elastic world of 3/4 hosts must still commit,
            # and the committer is its lowest live host id.
            self._saver.set_world(sorted(rdzv["world"]))
        # Trainer output is teed: passed through to the agent's stdout AND
        # captured to a per-node file so the failure path can report a log
        # tail to the master (the log-collector diagnosis seam).  The path
        # is unique per restart: an old pump kept alive by a lingering
        # grandchild's pipe handle can never scribble into the new round's
        # log (there is no portable way to wake a thread blocked in read).
        from dlrover_tpu_torch.common.multi_process import socket_dir

        os.makedirs(socket_dir(), exist_ok=True)
        self._log_path = os.path.join(
            socket_dir(),
            f"trainer_n{self.node_id}_r{self._restart_count}.log",
        )
        # Bounded retention: keep this round's and the previous round's
        # logs; a flapping trainer must not grow the dir forever.
        stale = os.path.join(
            socket_dir(),
            f"trainer_n{self.node_id}_r{self._restart_count - 2}.log",
        )
        if self._restart_count >= 2 and os.path.exists(stale):
            try:
                # Best-effort retention sweep of our own old log; failure
                # is already tolerated, nothing for a drill to surface.
                os.remove(stale)  # tracelint: disable=SEAM001
            except OSError:
                pass
        self._proc = subprocess.Popen(
            self.entrypoint, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        self._log_pump_stop = threading.Event()
        self._log_pump = threading.Thread(
            target=self._pump_output,
            args=(self._proc.stdout, self._log_path, self._log_pump_stop),
            name="trainer-log-pump",
            daemon=True,
        )
        self._log_pump.start()
        self._worker_started_wallclock = time.time()
        self._first_step_confirmed = False
        self._last_log_size = -1
        self._last_activity_wallclock = time.time()
        self.telemetry.event(
            "worker_start", restart=self._restart_count,
            round=rdzv["round"],
        )
        self.client.report_event("started")
        return rdzv

    # -- device-init watchdog -------------------------------------------------

    def _device_init_hung(self) -> bool:
        """True when the live trainer has gone fully silent for
        ``device_init_timeout`` before producing any step evidence.

        Step evidence is the trainer-side metrics file (written by
        ``write_device_metrics`` on every report step): an mtime at/after
        this round's start means the loop is stepping, and the check
        latches off for the round.  Until then, ANY trainer output
        (captured log growth) counts as liveness — so a healthy custom
        trainer that never integrates the metrics seam is not killed as
        long as it says anything, and the watchdog only fires on the real
        signature of a wedged device init: a process that stops emitting
        entirely, below Python, before its first step.  A later slow
        stretch is the master hang detector's job (it sees step reports);
        this covers the window the master is blind to (ref
        ``check_training_hang_operator.py:26-60`` covers the stepping
        case; nothing in the reference covers pre-first-step).
        """
        timeout = self.config.device_init_timeout
        if not timeout or self._first_step_confirmed:
            return False
        try:
            mtime = os.path.getmtime(self._metrics_file())
        except OSError:
            mtime = 0.0
        now = time.time()
        if mtime >= self._worker_started_wallclock:
            self._first_step_confirmed = True
            return False
        try:
            log_size = os.path.getsize(self._log_path)
        except (OSError, TypeError):
            log_size = 0
        if log_size != self._last_log_size:
            self._last_log_size = log_size
            self._last_activity_wallclock = now
        return now - self._last_activity_wallclock > timeout

    def _pump_output(self, stream, log_path: str, stop_flag):
        """Tee trainer output to our stdout + an unbuffered log file.

        The pipe must be drained NO MATTER WHAT: an abandoned pipe fills
        its 64KB buffer and blocks the writer's next print mid-step.  A
        sink that starts failing (broken stdout, unwritable disk) is
        dropped individually; draining continues.  ``stop_flag`` silences
        the stdout sink once this round is abandoned — a lingering
        grandchild's late lines must not interleave with the NEXT round's
        output (they still land in this round's own log file).
        """
        sinks = {"stdout": True, "file": True}
        try:
            # Seam: a fired fault drops the file sink exactly like an
            # unwritable disk would — draining must continue regardless.
            faults.fire("storage.write", path=os.path.basename(log_path))
            log = open(log_path, "wb", buffering=0)
        except (OSError, faults.FaultInjected):
            log, sinks["file"] = None, False
        try:
            for line in iter(stream.readline, b""):
                if stop_flag.is_set():
                    sinks["stdout"] = False
                if sinks["stdout"]:
                    try:
                        sys.stdout.buffer.write(line)
                        sys.stdout.buffer.flush()
                    except (OSError, ValueError):
                        sinks["stdout"] = False
                if sinks["file"]:
                    try:
                        log.write(line)
                    except (OSError, ValueError):
                        sinks["file"] = False
        finally:
            if log is not None:
                try:
                    log.close()
                except OSError:
                    pass

    def _stop_workers(self, sig=signal.SIGTERM, grace: float = 30.0):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.send_signal(sig)
            try:
                self._proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                logger.warning("trainer ignored %s; killing", sig)
                self._proc.kill()
                self._proc.wait()
        if self._log_pump is not None:
            # Best-effort: let the pump flush the final lines.  A pump kept
            # alive by a lingering grandchild's pipe handle is abandoned —
            # it writes to the PREVIOUS restart's uniquely-named log, so it
            # cannot corrupt the next round's file.
            self._log_pump.join(timeout=3.0)
            if self._log_pump.is_alive():
                logger.warning(
                    "trainer log pump still draining (grandchild holds the "
                    "pipe?); abandoning it to its per-restart log file"
                )
                self._log_pump_stop.set()  # silence its stdout sink
            self._log_pump = None

    def _restart_workers(self):
        """ref ``_restart_workers:687``: in-place process restart, no new pod."""
        # A LIVE trainer being torn down (membership change, hang
        # remediation) gets its stacks collected first — where it was
        # stuck is exactly what the post-incident diagnosis needs.
        stacks = self.dump_trainer_stacks(timeout_s=2.0)
        if stacks:
            logger.info(
                "trainer stacks at restart:\n%s",
                "\n".join(stacks.splitlines()[:60]),
            )
        self._restart_count += 1
        self.telemetry.event("restart", restart_count=self._restart_count)
        self._stop_workers()
        self._start_workers()

    def _membership_changed(self) -> bool:
        """ref ``_membership_changed:694``: nodes waiting to join (scale-up)
        or the formed world advanced past our round / lost a member
        (scale-down, peer death)."""
        try:
            waiting = self.client.num_nodes_waiting(RendezvousName.TRAINING)
            if waiting > 0:
                return True
            return self.client.world_changed(
                self._current_round, RendezvousName.TRAINING
            )
        except ConnectionError:
            return False

    # -- checkpoint hooks -----------------------------------------------------

    def start_async_saver(self, num_hosts: int = 1):
        if not self.config.checkpoint_dir:
            return
        self._saver = AsyncCheckpointSaver(
            self.config.checkpoint_dir,
            host_index=self.node_id,
            num_hosts=num_hosts,
        )
        self._saver.start()
        AsyncCheckpointSaver.register_signal_handlers()

    def _save_ckpt_to_storage(self):
        """ref ``_save_ckpt_to_storage:648`` (save_at_breakpoint): persist
        whatever the dead trainer left in shm before restarting."""
        if self._saver is not None and self.config.save_at_breakpoint:
            self._saver.save_shm_to_storage()

    # -- heartbeats -----------------------------------------------------------

    def _heartbeat_loop(self):
        while not self._stop.is_set():
            try:
                self.client.report_heartbeat()
                self.telemetry.ship(self.client)
            except ConnectionError:
                logger.warning("heartbeat: master unreachable")
            self._poll_paral_config()
            self._stop.wait(self.config.heartbeat_interval)

    # -- main loop ------------------------------------------------------------

    def run(self) -> RunResult:
        self.start_async_saver(num_hosts=self.config.max_nodes)
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, name="agent-heartbeat", daemon=True
        )
        self._heartbeat_thread.start()
        from dlrover_tpu_torch.agent.monitor import ResourceMonitor

        self._resource_monitor = ResourceMonitor(
            self.client,
            interval=self.config.resource_report_interval,
            metrics_file=self._metrics_file(),
            recorder=self.telemetry,
            on_preemption=self.request_preemption_drain,
        )
        self._resource_monitor.start()
        self._start_workers()
        result = self._invoke_run()
        self._stop.set()
        return result

    def request_preemption_drain(self, reason: str = ""):
        """Preemption-notice hook (ResourceMonitor callback, any thread):
        latch the reason and wake the monitor loop, which runs the drain."""
        self._preempt_reason = reason or "preempted"
        self._preempt_event.set()

    def _drain_and_exit(self) -> RunResult:
        """Graceful preemption drain, bounded by ``preempt_grace_s``:

        1. flush the trainer's latest shm checkpoint to storage — this
           host's done-file joins the old world's commit barrier, so the
           shrunk world can cross-world-restore a fully committed step
           instead of losing it;
        2. notify the master (rendezvous eviction, shard requeue, shrink
           ScalePlan happen there — survivors re-form without us);
        3. stop the trainer inside whatever grace remains.
        """
        grace = self.config.preempt_grace_s
        deadline = time.monotonic() + grace
        reason = self._preempt_reason
        logger.warning("preemption drain (grace %.0fs): %s", grace, reason)
        with self.telemetry.span("drain") as sp:
            if sp is not None:
                sp.attrs["reason"] = reason
                sp.attrs["grace_s"] = grace
            if self._saver is not None:
                with self.telemetry.span("drain_flush"):
                    try:
                        self._saver.save_shm_to_storage()
                    except Exception as e:  # noqa: BLE001 - keep draining
                        logger.warning("drain flush failed: %s", e)
            remaining = max(1.0, deadline - time.monotonic())
            try:
                self.client.report_preemption(
                    grace_s=remaining, reason=reason
                )
            except ConnectionError:
                logger.warning("preemption report: master unreachable")
        try:
            self.telemetry.ship(self.client)
        except Exception as e:  # noqa: BLE001 - master may already be gone
            logger.warning("drain telemetry ship failed: %s", e)
        self._stop_workers(grace=max(1.0, deadline - time.monotonic()))
        try:
            self.client.report_event("preempted", reason)
        except ConnectionError:
            pass
        self._stop.set()
        return RunResult.STOPPED

    def _invoke_run(self) -> RunResult:
        while not self._stop.is_set():
            # The preempt latch doubles as the sleep: a notice wakes the
            # loop immediately instead of burning monitor_interval of the
            # grace window.
            self._preempt_event.wait(self.config.monitor_interval)
            if self._preempt_event.is_set():
                return self._drain_and_exit()
            code = self._proc.poll()
            if code is None:
                if self._membership_changed():
                    if self.config.live_relayout:
                        # Virtual-mesh path: adopt the new round but keep
                        # the trainer — it folds its logical mesh onto the
                        # new member set in place (no restart, no restore).
                        logger.info(
                            "membership changed: live relayout (trainer kept)"
                        )
                        with self.telemetry.span("rendezvous") as sp:
                            rdzv = self._rdzv.next_rendezvous()
                            if sp is not None:
                                sp.attrs["round"] = rdzv["round"]
                                sp.attrs["world"] = len(rdzv["world"])
                                sp.attrs["live_relayout"] = True
                        self._current_round = rdzv["round"]
                        continue
                    logger.info("membership changed: restarting with new world")
                    self.client.report_event("restarting", "membership change")
                    # Persist the trainer's latest shm checkpoint first: the
                    # restarted world resumes from it (ref ``training.py:622``
                    # save-ckpt-then-restart on membership change).
                    if self._saver is not None:
                        self._saver.save_shm_to_storage()
                    self._restart_workers()
                    continue
                if self._device_init_hung():
                    # Stuck below Python before its first step: capture
                    # stacks for the diagnosis, then go through the
                    # restart/budget machinery instead of hanging with it.
                    stacks = self.dump_trainer_stacks(timeout_s=3.0)
                    error = (
                        "device-init-hang: trainer produced no step within "
                        f"{self.config.device_init_timeout:.0f}s of start"
                    )
                    if stacks:
                        error += (
                            "\n--- trainer stacks ---\n"
                            + "\n".join(stacks.splitlines()[:60])
                        )
                    logger.error("%s", error)
                    try:
                        action = self.client.report_failure(
                            error, exit_code=0, level="process",
                            restart_count=self._restart_count,
                        )
                    except ConnectionError:
                        action = (
                            "restart"
                            if self._restart_count < self.config.max_restarts
                            else "stop"
                        )
                    if action == "restart" and (
                        self._restart_count < self.config.max_restarts
                    ):
                        self._restart_workers()
                        continue
                    try:
                        self.client.report_event(
                            "failed", "device-init-hang"
                        )
                    except ConnectionError:
                        pass  # master down too; still reap the trainer
                    self._stop_workers(sig=signal.SIGKILL, grace=5.0)
                    return RunResult.FAILED
                continue
            if code == 0:
                self.telemetry.event("process_exit", code=0)
                self.client.report_event("succeeded")
                if self._saver is not None:
                    # Drain pending persists before declaring success.
                    time.sleep(1.0)
                return RunResult.SUCCEEDED
            # Failure path.
            logger.error("trainer exited with code %d", code)
            self.telemetry.event(
                "process_exit", code=code,
                restart_count=self._restart_count,
            )
            self._save_ckpt_to_storage()
            tail = self._tail_log(30)
            error = f"exit code {code}"
            if tail:
                error += f"\n--- trainer log tail ---\n{tail}"
            try:
                action = self.client.report_failure(
                    error,
                    exit_code=code,
                    level="process",
                    restart_count=self._restart_count,
                )
            except ConnectionError:
                action = (
                    "restart"
                    if self._restart_count < self.config.max_restarts
                    else "stop"
                )
            if action == "restart" and (
                self._restart_count < self.config.max_restarts
            ):
                self._restart_workers()
                continue
            self.client.report_event("failed", f"exit code {code}")
            return RunResult.FAILED
        self._stop_workers()
        return RunResult.STOPPED

    def shutdown(self, job_succeeded: bool = False):
        self._stop.set()
        if self._resource_monitor is not None:
            self._resource_monitor.stop()
        self._stop_workers()
        if self._saver is not None:
            self._saver.stop(unlink_shm=job_succeeded)
        try:
            self.telemetry.ship(self.client)
        except Exception as e:  # noqa: BLE001 - master may already be gone
            logger.debug("final telemetry ship skipped: %s", e)
        self.client.close()

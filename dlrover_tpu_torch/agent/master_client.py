"""The only channel node -> master: retry-wrapped typed calls (port of
``dlrover_tpu/agent/master_client.py``).

Capability ref: ``dlrover/python/elastic_agent/master_client.py:50-443``
(``join_rendezvous``, ``get_comm_world``, ``report_failures``,
``report_heart_beat``, kv_store accessors; every call retried).

Each call opens a TCP connection to the master's server
(``master/servicer.py``), sends one frame, the pickle of ``(method,
Envelope)``, and reads one ``Response`` back through
``messages.safe_loads``.  A connection per call keeps the client safe to
share between threads (the agent's heartbeat thread and its main loop)
and lets a restarted master be reached without a reconnect protocol.
Retries ride the shared :class:`~dlrover_tpu_torch.common.retry.RetryPolicy`
(exponential backoff + full jitter + overall deadline).  ``ConnectionError``
and ``socket.timeout`` are weather (retryable; a master that goes away
mid-answer raises ``ConnectionResetError``, never an empty answer); a
master that *answered* with a rejection is a bug (fatal, raised as-is).
The ``rpc.report`` / ``rpc.get`` fault seams fire before each attempt, so
a fault plan can script flaky-RPC incidents deterministically.
"""

from __future__ import annotations

import pickle
import socket
from typing import Dict, Optional

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.retry import RetryError, RetryPolicy
from dlrover_tpu_torch.master import messages as msg
from dlrover_tpu_torch.master.servicer import (
    GET,
    REPORT,
    recv_frame,
    send_frame,
)


def _split_addr(addr: str):
    host, _, port = addr.rpartition(":")
    return (host.strip("[]") or "localhost"), int(port)


class MasterClient:
    RPC_TIMEOUT_S = 30.0

    def __init__(
        self,
        addr: str,
        node_id: int = 0,
        node_type: str = "worker",
        retries: int = 5,
        deadline_s: float = 120.0,
    ):
        self._addr = addr
        self._host, self._port = _split_addr(addr)
        self.node_id = node_id
        self.node_type = node_type
        self._retries = retries
        self._policy = RetryPolicy(
            max_attempts=retries,
            base_delay_s=0.5,
            max_delay_s=10.0,
            deadline_s=deadline_s,
            retryable=(ConnectionError, socket.timeout),
            name="master_rpc",
        )

    def _rpc(self, method: str, envelope: msg.Envelope,
             timeout: float) -> msg.Response:
        """One request/response exchange on a fresh connection."""
        data = pickle.dumps((method, envelope))
        with socket.create_connection(
            (self._host, self._port), timeout=timeout
        ) as sock:
            sock.settimeout(timeout)
            send_frame(sock, data)
            response = msg.safe_loads(recv_frame(sock))
        if not isinstance(response, msg.Response):
            raise ConnectionResetError(
                f"master sent {type(response).__name__}, not a Response"
            )
        return response

    def _envelope(self, payload) -> msg.Envelope:
        return msg.Envelope(
            node_id=self.node_id, node_type=self.node_type, payload=payload
        )

    def _call(self, attempt_fn) -> msg.Response:
        try:
            return self._policy.call(attempt_fn)
        except RetryError as e:
            raise ConnectionError(
                f"master unreachable at {self._addr}: {e.last_error}"
            ) from e

    def report(self, payload) -> msg.Response:
        def attempt() -> msg.Response:
            faults.fire("rpc.report")
            response = self._rpc(
                REPORT, self._envelope(payload), self.RPC_TIMEOUT_S
            )
            if not response.success:
                raise RuntimeError(
                    f"master rejected {type(payload).__name__}: "
                    f"{response.message}"
                )
            return response

        return self._call(attempt)

    def get(self, payload) -> msg.Response:
        def attempt() -> msg.Response:
            faults.fire("rpc.get")
            response = self._rpc(
                GET, self._envelope(payload), self.RPC_TIMEOUT_S
            )
            if not response.success:
                raise RuntimeError(
                    f"master failed {type(payload).__name__}: "
                    f"{response.message}"
                )
            return response

        return self._call(attempt)

    def ping(self, timeout: float = 2.0) -> bool:
        try:
            self._rpc(GET, self._envelope(msg.JobStatusRequest()), timeout)
            return True
        except OSError:
            return False

    # -- rendezvous -----------------------------------------------------------

    def join_rendezvous(
        self,
        node_rank: int,
        local_world_size: int,
        rdzv_name: str = "elastic-training",
        node_unit: int = 1,
    ) -> int:
        response = self.report(
            msg.JoinRendezvous(
                node_rank, local_world_size, rdzv_name, node_unit
            )
        )
        return response.payload

    def get_comm_world(
        self, node_rank: int, rdzv_name: str = "elastic-training"
    ) -> msg.RendezvousState:
        return self.get(msg.CommWorldRequest(node_rank, rdzv_name)).payload

    def num_nodes_waiting(self, rdzv_name: str = "elastic-training") -> int:
        return self.get(msg.WaitingNodesRequest(rdzv_name)).payload

    def world_changed(
        self, round_: int, rdzv_name: str = "elastic-training"
    ) -> bool:
        return bool(
            self.get(msg.WorldChangedRequest(round_, rdzv_name)).payload
        )

    def report_network_status(
        self, node_rank: int, normal: bool, elapsed: float
    ):
        self.report(msg.NetworkStatus(node_rank, normal, elapsed))

    def get_network_check_result(self) -> msg.NetworkCheckResult:
        return self.get(msg.NetworkCheckResultRequest(self.node_id)).payload

    # -- data sharding --------------------------------------------------------

    def create_dataset(self, params: msg.DatasetShardParams):
        self.report(params)

    def get_task(self, dataset_name: str) -> msg.ShardTask:
        return self.get(msg.TaskRequest(dataset_name, self.node_id)).payload

    def report_task(self, dataset_name: str, task_id: int, success=True):
        self.report(msg.TaskResult(task_id, dataset_name, success))

    def get_shard_checkpoint(self, dataset_name: str) -> msg.ShardCheckpoint:
        return self.get(msg.ShardCheckpointRequest(dataset_name)).payload

    def restore_shard_checkpoint(self, ckpt: msg.ShardCheckpoint):
        self.report(ckpt)

    # -- kv store -------------------------------------------------------------

    def kv_put(self, key: str, value: bytes):
        self.report(msg.KVPut(key, value))

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.get(msg.KVGet(key)).payload

    def kv_add(self, key: str, amount: int = 1) -> int:
        return self.get(msg.KVAdd(key, amount)).payload

    # -- telemetry / lifecycle ------------------------------------------------

    def report_step(self, step: int, tokens: int = 0, loss: float = 0.0,
                    anomalies: tuple = ()):
        self.report(msg.StepReport(
            step, tokens=tokens, loss=loss, anomalies=tuple(anomalies),
        ))

    def report_heartbeat(self, diagnosis: Optional[Dict] = None):
        self.report(msg.HeartBeat(self.node_id, diagnosis=diagnosis or {}))

    def report_resource(
        self,
        cpu_percent: float,
        mem_gb: float,
        device_mem_gb: float = 0.0,
        device_util: float = 0.0,
        device_mem_max_gb: float = 0.0,
        device_util_max: float = 0.0,
    ):
        self.report(
            msg.ResourceStats(
                self.node_id, cpu_percent, mem_gb,
                device_mem_gb, device_util,
                device_mem_max_gb, device_util_max,
            )
        )

    def report_failure(
        self, error: str, exit_code: int = 1, level: str = "process",
        restart_count: int = 0,
    ) -> str:
        response = self.report(
            msg.NodeFailure(
                self.node_id, error, exit_code, restart_count, level
            )
        )
        return response.payload

    def report_event(self, event: str, detail: str = ""):
        self.report(msg.NodeEventReport(self.node_id, event, detail))

    def report_preemption(self, grace_s: float = 30.0, reason: str = ""):
        """Tell the master this host is being preempted and how much of
        its grace window remains — the master drains it (rendezvous
        eviction, shard requeue, shrink ScalePlan) instead of waiting for
        the heartbeat timeout."""
        self.report(msg.PreemptionNotice(self.node_id, grace_s, reason))

    def report_digest(self, step: int, digest: str, check_every: int = 0):
        """Ship one post-update state digest (trainer/state_digest.py) into
        the master's SDC vote ledger."""
        self.report(msg.DigestReport(self.node_id, step, digest, check_every))

    def report_telemetry(self, events, dropped: int = 0):
        """Ship one drained telemetry batch (common/telemetry.py wire
        tuples) to the master's job timeline."""
        self.report(msg.TelemetryEvents(
            self.node_id, tuple(events), dropped
        ))

    def serve_submit(self, submit: msg.ServeSubmit) -> msg.ServeTicket:
        """One generation request through the master's serving front door
        (requires a ``ServeFrontend`` wired into the servicer)."""
        return self.report(submit).payload

    def serve_poll(self, uid: str) -> msg.ServeStatus:
        return self.get(msg.ServePoll(uid=uid)).payload

    def serve_cancel(self, uid: str) -> msg.ServeStatus:
        return self.report(msg.ServeCancel(uid=uid)).payload

    def get_metrics_text(self) -> str:
        """The master's Prometheus-style exposition (render_metrics)."""
        return self.get(msg.MetricsRequest()).payload

    def get_timeline(self, node_id: int = -1):
        """Merged job-timeline wire events: {node_id: [event, ...]}."""
        return self.get(msg.TimelineRequest(node_id)).payload

    def get_job_status(self) -> msg.JobStatus:
        return self.get(msg.JobStatusRequest()).payload

    def join_sync(self, name: str, need: int) -> bool:
        return bool(self.get(msg.SyncJoin(name, self.node_id, need)).payload)

    def sync_finished(self, name: str) -> bool:
        return bool(self.get(msg.SyncQuery(name)).payload)

    def report_cluster_version(self, version: int, expected: int = 0) -> int:
        return int(
            self.get(
                msg.ClusterVersion(self.node_id, version, expected)
            ).payload
        )

    def get_cluster_version(self) -> int:
        return int(self.get(msg.ClusterVersion(self.node_id, -1)).payload)

    def get_paral_config(self) -> msg.ParalConfig:
        return self.get(msg.ParalConfigRequest(self.node_id)).payload

    def close(self):
        """Nothing to release: each call's connection closes with it."""

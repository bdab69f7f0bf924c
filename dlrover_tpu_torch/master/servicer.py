"""The single surface of the master: two RPCs, ~20 typed messages (port of
``dlrover_tpu/master/servicer.py``).

Capability ref: ``dlrover/python/master/servicer.py:71-668`` and
``dlrover/proto/elastic_training.proto:26-28`` (``Master.report`` fire-and-
forget + ``Master.get`` query, dataclass payloads inside).  The reference
keeps the same 2-RPC shape over gRPC generic handlers; the port carries it
over the standard library: a threaded TCP server reads length-prefixed
frames, each the pickle of ``(method, Envelope)``, and answers with the
pickle of a ``Response``.  Every request is read through
``messages.safe_loads`` (the restricted unpickler), never ``pickle.loads``.
Adding a message type is adding a dataclass + a dispatch entry.
"""

from __future__ import annotations

import json
import pickle
import socket
import socketserver
import struct
import threading
from typing import Callable, Dict, Type

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import recv_exact
from dlrover_tpu_torch.master import messages as msg

SERVICE = "dlrover_tpu.Master"
REPORT = f"/{SERVICE}/report"
GET = f"/{SERVICE}/get"

#: Frame header: the payload's byte length, little-endian u64.
_HEADER = struct.Struct("<Q")
#: Largest frame either side accepts (a corrupt or hostile length must not
#: make the reader allocate without bound).
MAX_FRAME_BYTES = 256 << 20


def send_frame(sock: socket.socket, data: bytes):
    sock.sendall(_HEADER.pack(len(data)) + data)


def recv_frame(sock: socket.socket) -> bytes:
    """One frame; a peer that closes first raises ``ConnectionResetError``
    (never a short, empty answer)."""
    (length,) = _HEADER.unpack(recv_exact(sock, _HEADER.size))
    if length > MAX_FRAME_BYTES:
        raise ConnectionResetError(f"frame of {length} bytes refused")
    return recv_exact(sock, length)


#: Instant (occurrence-only) telemetry kinds routed straight into a
#: timeline counter: event name -> counter, rendered by render_metrics
#: as ``dlrover_<counter>_total``.  Anything not in this table and not
#: handled by a ledger branch below lands in the timeline ring only,
#: which TEL001 (telemetry-contract) flags as an unrouted event.
_COUNTER_KINDS: Dict[str, str] = {
    "retry": "retries",
    "circuit_open": "circuit_opens",
    "replica.death": "replica_deaths",
    "process_exit": "worker_exits",
    "worker_start": "worker_starts",
}


class MasterServicer:
    """Dispatches report/get payloads to the master components."""

    def __init__(
        self,
        rdzv_managers=None,
        task_manager=None,
        node_manager=None,
        speed_monitor=None,
        kv_store=None,
        paral_config=None,
        metrics=None,
        timeline=None,
        auto_scaler=None,
        serve_frontend=None,
        calibration=None,
        memory_ledger=None,
    ):
        self.rdzv_managers = rdzv_managers or {}
        self.task_manager = task_manager
        self.node_manager = node_manager
        self.speed_monitor = speed_monitor
        self.kv_store = kv_store
        self.paral_config = paral_config or msg.ParalConfig()
        self.metrics = metrics
        self.timeline = timeline
        self.auto_scaler = auto_scaler
        # Optional serving front door (serving/frontend.py): when wired,
        # submit/poll/cancel ride the same 2-RPC transport as the rest of
        # the control plane — no second server, no new wire format.
        self.serve_frontend = serve_frontend
        # Calibration ledger (master/calibration.py): "calibration" wire
        # events from profiled trainers fold in here.
        self.calibration = calibration
        # Classified HBM ledger (master/memory_ledger.py): "memory" wire
        # events from trainers/engines fold in here.
        self.memory_ledger = memory_ledger
        from dlrover_tpu_torch.master.sync_service import SyncService

        self.sync_service = SyncService()
        self._get_handlers: Dict[Type, Callable] = {
            msg.CommWorldRequest: self._get_comm_world,
            msg.WaitingNodesRequest: self._get_waiting_nodes,
            msg.WorldChangedRequest: self._get_world_changed,
            msg.TaskRequest: self._get_task,
            msg.KVGet: self._kv_get,
            msg.KVAdd: self._kv_add,
            msg.ShardCheckpointRequest: self._get_shard_checkpoint,
            msg.JobStatusRequest: self._get_job_status,
            msg.ParalConfigRequest: self._get_paral_config,
            msg.NetworkCheckResultRequest: self._get_network_check_result,
            msg.SyncJoin: self._join_sync,
            msg.SyncQuery: self._query_sync,
            msg.ClusterVersion: self._cluster_version,
            msg.MetricsRequest: self._get_metrics_text,
            msg.TimelineRequest: self._get_timeline,
            msg.ServePoll: self._serve_poll,
        }
        self._report_handlers: Dict[Type, Callable] = {
            msg.JoinRendezvous: self._join_rendezvous,
            msg.NetworkStatus: self._report_network_status,
            msg.DatasetShardParams: self._create_dataset,
            msg.TaskResult: self._report_task_result,
            msg.KVPut: self._kv_put,
            msg.StepReport: self._report_step,
            msg.HeartBeat: self._report_heartbeat,
            msg.NodeFailure: self._report_failure,
            msg.NodeEventReport: self._report_event,
            msg.PreemptionNotice: self._report_preemption,
            msg.ResourceStats: self._report_resource,
            msg.ShardCheckpoint: self._restore_shard_checkpoint,
            msg.TelemetryEvents: self._report_telemetry,
            msg.DigestReport: self._report_digest,
            msg.ServeSubmit: self._serve_submit,
            msg.ServeCancel: self._serve_cancel,
        }

    # -- RPC entry points -----------------------------------------------------

    def report(self, envelope: msg.Envelope) -> msg.Response:
        handler = self._report_handlers.get(type(envelope.payload))
        if handler is None:
            return msg.Response(
                False, message=f"no handler for {type(envelope.payload)}"
            )
        try:
            result = handler(envelope)
            return msg.Response(True, payload=result)
        except Exception as e:
            logger.exception("report handler failed")
            return msg.Response(False, message=str(e))

    def get(self, envelope: msg.Envelope) -> msg.Response:
        handler = self._get_handlers.get(type(envelope.payload))
        if handler is None:
            return msg.Response(
                False, message=f"no handler for {type(envelope.payload)}"
            )
        try:
            return msg.Response(True, payload=handler(envelope))
        except Exception as e:
            logger.exception("get handler failed")
            return msg.Response(False, message=str(e))

    # -- rendezvous -----------------------------------------------------------

    def _join_rendezvous(self, env: msg.Envelope):
        p: msg.JoinRendezvous = env.payload
        manager = self.rdzv_managers[p.rdzv_name]
        if p.node_unit > 1:
            manager._node_unit = p.node_unit
        return manager.join_rendezvous(p.node_rank, p.local_world_size)

    def _get_comm_world(self, env: msg.Envelope):
        p: msg.CommWorldRequest = env.payload
        manager = self.rdzv_managers[p.rdzv_name]
        round_, group, world = manager.get_comm_world(p.node_rank)
        return msg.RendezvousState(
            round=round_, group=group, world=world,
            waiting=manager.num_nodes_waiting(),
        )

    def _get_waiting_nodes(self, env: msg.Envelope):
        manager = self.rdzv_managers[env.payload.rdzv_name]
        return manager.num_nodes_waiting()

    def _get_world_changed(self, env: msg.Envelope):
        p: msg.WorldChangedRequest = env.payload
        return self.rdzv_managers[p.rdzv_name].world_changed(p.round)

    def _report_network_status(self, env: msg.Envelope):
        p: msg.NetworkStatus = env.payload
        manager = self.rdzv_managers.get("network-check")
        if manager is not None:
            manager.report_network_status(p.node_rank, p.normal, p.elapsed)

    def _get_network_check_result(self, env: msg.Envelope):
        manager = self.rdzv_managers.get("network-check")
        if manager is None:
            return msg.NetworkCheckResult(reason="done")
        faults, reason = manager.check_fault_node()
        return msg.NetworkCheckResult(
            fault_nodes=faults,
            stragglers=manager.get_stragglers(),
            reason=reason,
        )

    # -- data sharding --------------------------------------------------------

    def _create_dataset(self, env: msg.Envelope):
        self.task_manager.create_dataset(env.payload)

    def _get_task(self, env: msg.Envelope):
        p: msg.TaskRequest = env.payload
        node = p.node_id if p.node_id >= 0 else env.node_id
        return self.task_manager.get_task(p.dataset_name, node)

    def _report_task_result(self, env: msg.Envelope):
        p: msg.TaskResult = env.payload
        return self.task_manager.report_task(
            p.dataset_name, p.task_id, p.success
        )

    def _get_shard_checkpoint(self, env: msg.Envelope):
        return self.task_manager.checkpoint(env.payload.dataset_name)

    def _restore_shard_checkpoint(self, env: msg.Envelope):
        self.task_manager.restore(env.payload)

    # -- kv store -------------------------------------------------------------

    def _kv_put(self, env: msg.Envelope):
        self.kv_store.put(env.payload.key, env.payload.value)

    def _kv_get(self, env: msg.Envelope):
        return self.kv_store.get(env.payload.key)

    def _kv_add(self, env: msg.Envelope):
        return self.kv_store.add(env.payload.key, env.payload.amount)

    # -- telemetry / lifecycle ------------------------------------------------

    def _report_step(self, env: msg.Envelope):
        p: msg.StepReport = env.payload
        self.speed_monitor.collect_global_step(p.step, p.timestamp, p.tokens)
        if p.loss:
            self.speed_monitor.record_loss(p.step, p.loss)
        for encoded in getattr(p, "anomalies", ()):
            self.speed_monitor.record_anomaly(p.step, str(encoded))

    def _report_heartbeat(self, env: msg.Envelope):
        p: msg.HeartBeat = env.payload
        if self.node_manager:
            self.node_manager.report_heartbeat(p.node_id, p.timestamp)

    def _report_failure(self, env: msg.Envelope):
        p: msg.NodeFailure = env.payload
        for manager in self.rdzv_managers.values():
            manager.remove_alive_node(p.node_id)
        if self.task_manager:
            self.task_manager.recover_tasks(p.node_id)
        if self.speed_monitor:
            self.speed_monitor.reset_running_speed()
        if self.node_manager:
            return self.node_manager.report_failure(
                p.node_id, p.error, p.exit_code, p.level
            )
        return "restart"

    def _report_preemption(self, env: msg.Envelope):
        """A host's grace window is burning: drain it NOW.

        Ordering mirrors ``_report_failure`` (rendezvous eviction first so
        survivors stop sealing worlds containing the doomed host, then
        shard requeue), plus the resize bookkeeping that makes the drain
        observable: the resize ledger opens here and closes on the first
        step report of the re-formed world, and the shrink ScalePlan goes
        through the auto-scaler so the resize shows up in its plan history
        instead of as an unexplained heartbeat death.
        """
        p: msg.PreemptionNotice = env.payload
        logger.warning(
            "preemption notice from node %d (grace %.0fs): %s",
            p.node_id, p.grace_s, p.reason or "unspecified",
        )
        if self.speed_monitor is not None:
            self.speed_monitor.begin_resize(reason=f"preempt:{p.node_id}")
            self.speed_monitor.reset_running_speed()
        for manager in self.rdzv_managers.values():
            manager.remove_alive_node(p.node_id)
        if self.task_manager:
            self.task_manager.recover_tasks(p.node_id)
        if self.node_manager:
            self.node_manager.report_event(p.node_id, "preempting", p.reason)
        if self.auto_scaler is not None:
            self.auto_scaler.note_preemption(p.node_id)
        if self.timeline is not None:
            # Recorded AFTER the retire: retiring evicts the node's
            # observability series, and the notice must outlive its node
            # (it is the resize's own record, not a host sample).
            self.timeline.record(
                p.node_id, "preempt_notice",
                attrs={"grace_s": p.grace_s, "reason": p.reason,
                       "src": "master"},
            )

    def _report_digest(self, env: msg.Envelope):
        """Route one replica's state digest into the SDC vote ledger."""
        p: msg.DigestReport = env.payload
        if self.speed_monitor is None:
            return
        node = p.node_id if p.node_id >= 0 else env.node_id
        if self.node_manager is not None and self.node_manager.is_quarantined(
            node
        ):
            # A quarantined host keeps shipping until its agent tears the
            # trainer down; its digests must not re-enter the vote.
            return
        self.speed_monitor.record_digest(
            node, p.step, p.digest, p.check_every
        )

    def _report_event(self, env: msg.Envelope):
        p: msg.NodeEventReport = env.payload
        if p.event == "compile" and self.speed_monitor is not None:
            # Trainer (re)compile wall time → the goodput compile ledger.
            # Detail is trainer-authored JSON; a malformed report must not
            # fail the RPC (the node event below still lands).
            try:
                detail = json.loads(p.detail or "{}")
                self.speed_monitor.record_compile(
                    float(detail.get("seconds", 0.0)),
                    restart=bool(detail.get("restart", False)),
                    cached=bool(detail.get("cached", False)),
                )
            except (ValueError, TypeError):
                logger.warning(
                    "unparseable compile event from %s: %r",
                    p.node_id, p.detail,
                )
        elif p.event == "relayout" and self.speed_monitor is not None:
            # Virtual-mesh live re-layout: the trainer measured the whole
            # resize itself (no open window to close), so its seconds land
            # straight in the resize ledger under kind "relayout" — or as
            # a "relayout_failed" restore when retries were exhausted.
            try:
                detail = json.loads(p.detail or "{}")
                self.speed_monitor.record_relayout(
                    float(detail.get("relayout_s", 0.0)),
                    ok=not bool(detail.get("fallback", False)),
                )
            except (ValueError, TypeError):
                logger.warning(
                    "unparseable relayout event from %s: %r",
                    p.node_id, p.detail,
                )
        if self.node_manager:
            self.node_manager.report_event(p.node_id, p.event, p.detail)

    def _report_telemetry(self, env: msg.Envelope):
        p: msg.TelemetryEvents = env.payload
        if self.timeline is None:
            return
        node = p.node_id if p.node_id >= 0 else env.node_id
        self.timeline.add_events(node, p.events)
        # Wire events are (name, kind, t_wall, duration_s, attrs).
        for ev in p.events:
            try:
                name, _, _, duration_s, attrs = ev
            except (TypeError, ValueError):
                continue
            if not isinstance(attrs, dict):
                continue
            if self.speed_monitor is not None and name == "fault":
                # Injected-fault events feed the Faultline ledger: a chaos
                # run's lost time is attributed to the fault plan, not to
                # the job.
                self.speed_monitor.record_fault(
                    str(attrs.get("seam", "?")),
                    str(attrs.get("kind", "")),
                    float(duration_s or 0.0),
                )
            elif self.speed_monitor is not None and name == "serve.swap":
                # Weight hot-swap booking: versioned, with the
                # rollback verdict — the serve ledger's swap counters
                # (and gauges) come from here.
                self.speed_monitor.record_swap(
                    node,
                    version=int(attrs.get("version", 0)),
                    ok=bool(attrs.get("ok", False)),
                    rolled_back=bool(attrs.get("rolled_back", False)),
                    seconds=float(duration_s or 0.0),
                )
            elif self.speed_monitor is not None and name == "serve":
                # Serving-replica stats snapshot: feeds the serve
                # ledger behind dlrover_serve_* and the auto-scaler's
                # latency/occupancy replica policy.
                try:
                    self.speed_monitor.record_serve(node, **attrs)
                except (TypeError, ValueError):
                    logger.warning(
                        "unparseable serve event from %d: %r",
                        node, attrs,
                    )
            elif self.speed_monitor is not None and name == "moe":
                # Router-health snapshot (gate entropy, capacity drops,
                # per-expert load): feeds the moe ledger behind the
                # dlrover_moe_* gauges.
                try:
                    self.speed_monitor.record_moe(node, **attrs)
                except (TypeError, ValueError):
                    logger.warning(
                        "unparseable moe event from %d: %r",
                        node, attrs,
                    )
            elif self.speed_monitor is not None and name == "embed":
                # Embedding-plane stats snapshot: feeds the embed ledger
                # behind the dlrover_embed_* gauges (rows owned, cache
                # hit rate, reshard time).
                try:
                    self.speed_monitor.record_embed(node, **attrs)
                except (TypeError, ValueError):
                    logger.warning(
                        "unparseable embed event from %d: %r",
                        node, attrs,
                    )
            elif name in _COUNTER_KINDS:
                # Occurrence-only events (retries, breaker trips, worker
                # lifecycle): one counter bump each, surfaced as
                # dlrover_*_total so reliability dashboards see them
                # without scraping the timeline ring.
                self.timeline.bump(_COUNTER_KINDS[name])
            elif name == "memory":
                # Classified HBM snapshot (utils/memory_profile emits
                # them on the report cadence): newest-wins per node in
                # the MemoryLedger behind dlrover_hbm_* / /memory /
                # HBMPressureOperator, plus one measured-vs-modeled
                # bytes pairing for the calibration ledger so tune's
                # pruner runs on corrected bytes.
                if self.memory_ledger is not None:
                    try:
                        self.memory_ledger.record(node, **attrs)
                    except (TypeError, ValueError):
                        logger.warning(
                            "unparseable memory event from %d: %r",
                            node, attrs,
                        )
                if self.calibration is not None:
                    try:
                        self.calibration.observe(
                            str(attrs.get("cache_key", "")), "memory",
                            float(attrs.get("measured_b", 0.0)),
                            float(attrs.get("modeled_b", 0.0)),
                        )
                    except (TypeError, ValueError):
                        logger.warning(
                            "unparseable memory calibration from %d: %r",
                            node, attrs,
                        )
            elif self.calibration is not None and name == "calibration":
                # One measured/modeled pairing per capture window (flat
                # float attrs; utils/device_profile emits them) folds
                # into the per-cache-key EWMA correction ledger.
                key = str(attrs.get("cache_key", ""))
                for kind in ("compute", "collective"):
                    try:
                        self.calibration.observe(
                            key, kind,
                            float(attrs.get(f"measured_{kind}", 0.0)),
                            float(attrs.get(f"modeled_{kind}", 0.0)),
                        )
                    except (TypeError, ValueError):
                        logger.warning(
                            "unparseable calibration event from %d: %r",
                            node, attrs,
                        )
                if "overlap" in attrs:
                    # Measured collective-overlap fraction from the same
                    # window — feeds est_comm_time's learned hidden share
                    # and the dlrover_overlap_fraction gauge.
                    try:
                        self.calibration.observe_overlap(
                            key, float(attrs["overlap"])
                        )
                    except (TypeError, ValueError):
                        logger.warning(
                            "unparseable overlap attr from %d: %r",
                            node, attrs,
                        )
        if p.dropped:
            # Make ring overflow visible master-side: the gauge
            # dlrover_telemetry_dropped_total accumulates what the log
            # line alone used to swallow.
            self.timeline.bump("telemetry_dropped", p.dropped)
            logger.warning(
                "node %d telemetry ring overwrote %d events before this "
                "drain (raise DLROVER_TPU_TELEMETRY_RING?)",
                node, p.dropped,
            )

    def _get_metrics_text(self, env: msg.Envelope) -> str:
        if self.timeline is None:
            return ""
        return self.timeline.render_metrics(
            speed_monitor=self.speed_monitor,
            node_manager=self.node_manager,
            calibration=self.calibration,
            memory=self.memory_ledger,
            metrics=self.metrics,
        )

    def _get_timeline(self, env: msg.Envelope):
        if self.timeline is None:
            return {}
        p: msg.TimelineRequest = env.payload
        return self.timeline.events(p.node_id if p.node_id >= 0 else None)

    def _report_resource(self, env: msg.Envelope):
        p: msg.ResourceStats = env.payload
        if self.metrics is not None:
            self.metrics.collect(
                p.node_id, p.cpu_percent, p.mem_gb,
                p.device_mem_gb, p.device_util,
                device_mem_max_gb=p.device_mem_max_gb,
                device_util_max=p.device_util_max,
            )

    def _get_job_status(self, env: msg.Envelope):
        return msg.JobStatus(
            speed=self.speed_monitor.running_speed() if self.speed_monitor else 0.0,
            global_step=self.speed_monitor.global_step if self.speed_monitor else 0,
            nodes=self.node_manager.statuses() if self.node_manager else {},
            goodput=self.speed_monitor.goodput() if self.speed_monitor else 0.0,
        )

    def _get_paral_config(self, env: msg.Envelope):
        return self.paral_config

    def update_paral_config(self, config: msg.ParalConfig):
        """Master-side tuners (auto-scaler/brain tier) push new runtime
        knobs; agents poll and hand them to trainers via the config file
        (ref ``paral_config_tuner.py:30-78``)."""
        config.version = self.paral_config.version + 1
        self.paral_config = config

    # -- serving front door ---------------------------------------------------

    def _require_frontend(self):
        if self.serve_frontend is None:
            raise RuntimeError("no serving front door on this master")
        return self.serve_frontend

    def _serve_submit(self, env: msg.Envelope):
        return self._require_frontend().submit(env.payload)

    def _serve_poll(self, env: msg.Envelope):
        return self._require_frontend().poll(env.payload)

    def _serve_cancel(self, env: msg.Envelope):
        return self._require_frontend().cancel(env.payload)

    # -- sync service ---------------------------------------------------------

    def _join_sync(self, env: msg.Envelope):
        p: msg.SyncJoin = env.payload
        return self.sync_service.join_sync(p.name, p.node_id, p.need)

    def _query_sync(self, env: msg.Envelope):
        return self.sync_service.sync_finished(env.payload.name)

    def _cluster_version(self, env: msg.Envelope):
        p: msg.ClusterVersion = env.payload
        if p.version >= 0:
            return self.sync_service.update_local_version(
                p.node_id, p.version, p.expected
            )
        return self.sync_service.get_global_version()


class _FrameHandler(socketserver.BaseRequestHandler):
    """One connection: frames in, frames out, until the peer closes."""

    def handle(self):
        servicer: MasterServicer = self.server.servicer  # type: ignore[attr-defined]
        sock = self.request
        while True:
            try:
                data = recv_frame(sock)
            except (ConnectionError, OSError):
                return
            try:
                method, envelope = msg.safe_loads(data)
                if not isinstance(envelope, msg.Envelope):
                    raise pickle.UnpicklingError(
                        f"not an Envelope: {type(envelope).__name__}"
                    )
            except Exception as e:  # noqa: BLE001 - answered, not raised
                logger.warning("master refused a request: %s", e)
                response = msg.Response(False, message=f"refused: {e}")
            else:
                if method == REPORT:
                    response = servicer.report(envelope)
                elif method == GET:
                    response = servicer.get(envelope)
                else:
                    response = msg.Response(
                        False, message=f"no such method {method!r}"
                    )
            try:
                send_frame(sock, pickle.dumps(response))
            except (ConnectionError, OSError):
                return


class MasterServer(socketserver.ThreadingTCPServer):
    """The master's listening socket and its serving thread."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, servicer: "MasterServicer", port: int = 0):
        super().__init__(("", port), _FrameHandler)
        self.servicer = servicer
        self._thread = threading.Thread(
            target=self.serve_forever, name="master-rpc", daemon=True
        )

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self):
        self._thread.start()

    def stop(self):
        """Stop accepting, close the socket and join the serving thread."""
        self.shutdown()
        self.server_close()
        self._thread.join(timeout=5)


def start_master_server(servicer: MasterServicer, port: int = 0):
    """Returns (MasterServer, bound_port)."""
    server = MasterServer(servicer, port)
    server.start()
    logger.info("master server on port %d", server.port)
    return server, server.port

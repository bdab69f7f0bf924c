"""Typed control-plane messages multiplexed over the 2-RPC master service
(port of ``dlrover_tpu/master/messages.py``).

Capability ref: ``dlrover/python/common/grpc.py`` (dataclass-serialized
messages inside ``Master.report``/``Master.get``,
``dlrover/proto/elastic_training.proto:26-28``).  The envelope identifies the
sender (host) and the payload class selects the handler — adding a message
type never changes the wire contract.  The port carries the envelopes over
the standard library (``master/servicer.py``), and the server reads them
only through :func:`safe_loads`.
"""

from __future__ import annotations

import dataclasses
import pickle
import socket
import time
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Envelope:
    """Wrapper for every request: which host, which job, what payload."""

    node_id: int = -1
    node_type: str = "worker"
    job_name: str = "local"
    payload: Any = None


@dataclasses.dataclass
class Response:
    success: bool = True
    payload: Any = None
    message: str = ""


# -- rendezvous --------------------------------------------------------------


@dataclasses.dataclass
class JoinRendezvous:
    node_rank: int
    local_world_size: int
    rdzv_name: str = "elastic-training"
    node_unit: int = 1


@dataclasses.dataclass
class RendezvousState:
    round: int = 0
    group: int = 0
    world: Dict[int, int] = dataclasses.field(default_factory=dict)
    waiting: int = 0


@dataclasses.dataclass
class CommWorldRequest:
    node_rank: int
    rdzv_name: str = "elastic-training"


@dataclasses.dataclass
class NetworkStatus:
    node_rank: int
    normal: bool
    elapsed: float


@dataclasses.dataclass
class NetworkCheckResult:
    fault_nodes: List[int] = dataclasses.field(default_factory=list)
    stragglers: List[int] = dataclasses.field(default_factory=list)
    reason: str = ""


@dataclasses.dataclass
class WaitingNodesRequest:
    rdzv_name: str = "elastic-training"


@dataclasses.dataclass
class WorldChangedRequest:
    """Has the world sealed at ``round`` been superseded or broken?"""

    round: int
    rdzv_name: str = "elastic-training"


@dataclasses.dataclass
class NetworkCheckResultRequest:
    node_rank: int = -1


# -- data sharding -----------------------------------------------------------


@dataclasses.dataclass
class DatasetShardParams:
    dataset_name: str
    dataset_size: int
    shard_size: int
    num_epochs: int = 1
    shuffle: bool = False
    storage_type: str = "table"  # table | text | stream
    batch_size: int = 0
    # OOM guard (ref ``dataset_splitter.py`` _MAX_SHARD_COUNT): an epoch
    # producing more shards than this is split into subepochs of at most
    # this many shards, so the master never materializes an unbounded
    # shard list for a huge dataset.  0 = library default.
    max_shard_count: int = 0


@dataclasses.dataclass
class ShardTask:
    task_id: int = -1
    dataset_name: str = ""
    start: int = 0
    end: int = 0
    epoch: int = 0
    record_indices: Optional[List[int]] = None

    @property
    def empty(self) -> bool:
        return self.task_id < 0


@dataclasses.dataclass
class TaskRequest:
    dataset_name: str
    node_id: int = -1


@dataclasses.dataclass
class TaskResult:
    task_id: int
    dataset_name: str
    success: bool = True


@dataclasses.dataclass
class ShardCheckpointRequest:
    dataset_name: str


@dataclasses.dataclass
class ShardCheckpoint:
    dataset_name: str
    content: str  # json


# -- kv store ----------------------------------------------------------------


@dataclasses.dataclass
class KVPut:
    key: str
    value: bytes


@dataclasses.dataclass
class KVGet:
    key: str


@dataclasses.dataclass
class KVAdd:
    key: str
    amount: int = 1


# -- telemetry / lifecycle ---------------------------------------------------


@dataclasses.dataclass
class StepReport:
    step: int
    timestamp: float = dataclasses.field(default_factory=time.time)
    samples: int = 0
    tokens: int = 0
    loss: float = 0.0
    # Encoded numeric anomalies observed at/since the last report
    # (trainer/numeric_health.py): e.g. "nan@120:loss=nan grad_norm=12.3".
    anomalies: tuple = ()


@dataclasses.dataclass
class DigestReport:
    """One replica's post-update train-state digest (trainer/state_digest.py).

    After the ZeRO-1 all-gather (or the replicated update) all DP replicas
    hold bitwise-identical state, so the master can majority-vote the
    per-node digests for a given step and attribute a silent-data-corruption
    outlier without any extra collective.  ``check_every`` rides along so
    the ledger can report the configured cadence in its metrics."""

    node_id: int
    step: int
    digest: str
    check_every: int = 0


@dataclasses.dataclass
class HeartBeat:
    node_id: int
    timestamp: float = dataclasses.field(default_factory=time.time)
    diagnosis: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NodeFailure:
    node_id: int
    error: str = ""
    exit_code: int = 0
    restart_count: int = 0
    level: str = "process"  # process | node | job


@dataclasses.dataclass
class NodeEventReport:
    node_id: int
    event: str  # started | succeeded | failed | preempting
    detail: str = ""


@dataclasses.dataclass
class PreemptionNotice:
    """Agent-side preemption warning: this host disappears within
    ``grace_s`` seconds.  The master drains it gracefully — rendezvous
    eviction, shard requeue, a shrink ScalePlan — instead of paying the
    heartbeat timeout to discover the death after the fact."""

    node_id: int
    grace_s: float = 30.0
    reason: str = ""


@dataclasses.dataclass
class ResourceStats:
    node_id: int
    cpu_percent: float = 0.0
    mem_gb: float = 0.0
    device_mem_gb: float = 0.0
    device_util: float = 0.0
    # Per-device maxima across the host (a single hot device hides
    # inside the host-wide sums above).  Defaults keep older agents
    # wire-compatible.
    device_mem_max_gb: float = 0.0
    device_util_max: float = 0.0


@dataclasses.dataclass
class TelemetryEvents:
    """One drained batch of a node's telemetry ring (common/telemetry.py):
    tuples of (name, kind, t_wall, duration_s, attrs) — plain builtins
    only, so the restricted unpickler admits them.  ``dropped`` reports
    ring overwrites since the last drain (an observability gap marker,
    not an error)."""

    node_id: int
    events: Tuple = ()
    dropped: int = 0


@dataclasses.dataclass
class MetricsRequest:
    """Fetch the master's Prometheus-style text exposition
    (master/timeline.py ``render_metrics``)."""

    pass


@dataclasses.dataclass
class TimelineRequest:
    """Fetch the merged job timeline's wire events ({node_id: [event...]});
    ``node_id`` < 0 means all nodes."""

    node_id: int = -1


@dataclasses.dataclass
class JobStatusRequest:
    pass


@dataclasses.dataclass
class JobStatus:
    speed: float = 0.0
    global_step: int = 0
    nodes: Dict[int, str] = dataclasses.field(default_factory=dict)
    goodput: float = 0.0


@dataclasses.dataclass
class SyncJoin:
    """Named worker barrier (ref sync_service.py); returns completion."""

    name: str
    node_id: int
    need: int


@dataclasses.dataclass
class SyncQuery:
    name: str


@dataclasses.dataclass
class ClusterVersion:
    """PS cluster-version protocol (ref elastic_ps.py): report local,
    receive global."""

    node_id: int
    version: int = -1  # -1 = query only
    expected: int = 0  # reporters required before the global can advance


@dataclasses.dataclass
class ParalConfigRequest:
    node_id: int


@dataclasses.dataclass
class ParalConfig:
    """Runtime-tunable knobs pushed master -> trainer (ref ParalConfigTuner)."""

    global_batch_size: int = 0
    grad_accum: int = 1
    version: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BatchFetch:
    """Cross-host coworker data service: one batch, please (ref
    ``protos/coworker.proto`` GetBatchData).  The service itself is ROADMAP
    Queue 1 item 10b's remainder; the message keeps the wire's set whole."""

    consumer: str = ""
    timeout_s: float = 10.0


@dataclasses.dataclass
class BatchPayload:
    """One collated batch on the wire: raw bytes + per-array metadata
    (shape, dtype str, byte offset) — no numpy objects in the pickle."""

    seq: int = -1
    meta: Dict[str, Tuple[Tuple[int, ...], str, int]] = dataclasses.field(
        default_factory=dict
    )
    data: bytes = b""
    end: bool = False       # producer exhausted: no more batches ever
    retry: bool = False     # nothing ready inside timeout_s: ask again
    error: str = ""


# -- serving front door -------------------------------------------------------


@dataclasses.dataclass
class ServeSubmit:
    """One generation request through the RPC front door.  The prompt is
    a tuple of token ids (plain builtins only — the restricted unpickler
    admits no numpy); ``deadline_s`` is the client's end-to-end budget,
    which the admission controller sheds against."""

    uid: str
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1
    deadline_s: float = 30.0


@dataclasses.dataclass
class ServeTicket:
    """Submit verdict: accepted into the bounded queue, or fast-rejected
    (``reason`` = "shed" | "queue_full" | "no_fleet") with the predicted
    wait that triggered the shed."""

    uid: str
    accepted: bool
    reason: str = ""
    predicted_wait_s: float = 0.0


@dataclasses.dataclass
class ServePoll:
    uid: str


@dataclasses.dataclass
class ServeStatus:
    """Poll answer.  ``state`` walks pending -> done; ``tokens`` are the
    generated ids once done; shed/cancelled/unknown are terminal."""

    uid: str
    state: str = "unknown"
    tokens: Tuple[int, ...] = ()
    latency_s: float = 0.0


@dataclasses.dataclass
class ServeCancel:
    uid: str


class _RestrictedUnpickler(pickle.Unpickler):
    """Deserializer for the control-plane wire format.

    Wire payloads are pickled dataclasses; vanilla ``pickle.loads`` on a
    network port is arbitrary code execution.  Restrict resolvable globals
    to this package's message/dataclass types and a small builtin set, so a
    crafted payload can at worst construct our own message objects.
    """

    _SAFE_BUILTINS = {
        "dict", "list", "tuple", "set", "frozenset", "bytes", "str",
        "int", "float", "complex", "bool", "NoneType", "bytearray",
    }

    def find_class(self, module: str, name: str):
        # Dotted names are attribute chains (STACK_GLOBAL resolves
        # 'subprocess.Popen' relative to any allowed module) — reject them,
        # and allow only top-level classes of this exact module.
        if "." in name:
            raise pickle.UnpicklingError(
                f"forbidden dotted global {module}.{name}"
            )
        if module == __name__:
            value = globals().get(name)
            if isinstance(value, type):
                return value
        if module == "builtins" and name in self._SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"forbidden global {module}.{name} in control-plane payload"
        )


def safe_loads(data: bytes):
    import io

    return _RestrictedUnpickler(io.BytesIO(data)).load()


def free_port(start: int = 20000, end: int = 40000) -> int:
    for port in range(start, end, 7):
        # Local ephemeral-port probe (bind + close, no remote I/O);
        # nothing a fault drill could meaningfully break here.
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:  # tracelint: disable=SEAM001
            try:
                s.bind(("", port))
                return port
            except OSError:
                continue
    raise RuntimeError("no free port found")

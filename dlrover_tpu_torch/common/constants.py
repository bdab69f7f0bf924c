"""Canonical enums and constants for the control plane.

TPU-native analogue of the reference's ``dlrover/python/common/constants.py``
(see SURVEY.md §2.3): node types/status, distribution strategies, rendezvous
names, exception levels.  The GPU/K8s-specific notions (PS pods, nvidia.com/gpu
resources) become TPU notions: a *node* is one TPU-VM host; the atomic
schedulable unit for elasticity is a *slice* (preemption kills whole slices).
"""

from __future__ import annotations


class NodeType:
    """Roles a node can play in a job."""

    MASTER = "master"
    WORKER = "worker"          # a TPU-VM host running one trainer process
    COWORKER = "coworker"      # CPU-only host offloading data preprocessing
    EVALUATOR = "evaluator"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    PREEMPTED = "preempted"    # TPU-VM/slice preemption: first-class, not a failure

    @staticmethod
    def is_terminal(status: str) -> bool:
        return status in (
            NodeStatus.SUCCEEDED,
            NodeStatus.FAILED,
            NodeStatus.DELETED,
            NodeStatus.PREEMPTED,
        )


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"
    HEARTBEAT_TIMEOUT = "heartbeat_timeout"


class DistributionStrategy:
    """How the job parallelizes. SPMD is the TPU-native main path."""

    SPMD = "spmd"              # jax multi-controller, one proc per host
    LOCAL = "local"            # single-process (tests / single host)


class RendezvousName:
    TRAINING = "elastic-training"
    NODE_CHECK = "node-check"


class JobStage:
    INIT = "init"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    STOPPING = "stopping"


class TrainingExceptionLevel:
    """Classification of a reported failure, mirroring the reference's levels
    (ref ``dlrover/python/common/constants.py:277-283``)."""

    ERROR = "error"                  # recoverable process error -> restart in place
    NODE_ERROR = "node_error"        # node is bad -> relaunch/replace the node
    RDZV_ERROR = "rdzv_error"        # rendezvous failed
    WARNING = "warning"
    INFO = "info"


class Accelerators:
    TPU_V5E = "tpu-v5e"
    TPU_V5P = "tpu-v5p"
    TPU_V4 = "tpu-v4"
    CPU = "cpu"                      # CI / fake-backend testing


class ConfigKey:
    """Env vars used across master/agent/trainer processes."""

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    PARAL_CONFIG_PATH = "DLROVER_TPU_PARAL_CONFIG_PATH"
    METRICS_FILE = "DLROVER_TPU_METRICS_FILE"
    SHM_PREFIX = "DLROVER_TPU_SHM_PREFIX"


class CheckpointConstant:
    MODEL_STATES_NAME = "model_states"
    TRACKER_FILE = "latest_step.txt"
    DONE_SUFFIX = ".done"
    TEMP_DIR_PREFIX = "_tmp_step_"


class NetworkCheck:
    """Defaults for the pre-flight node health check (SURVEY.md §3.5)."""

    ROUNDS = 2
    MATMUL_SIZE = 1024           # per-chip MXU stress probe
    ALLGATHER_BYTES = 1 << 22    # ICI bandwidth probe payload
    STRAGGLER_RATIO = 1.8        # elapsed-time ratio flagged as straggler


class GoodputEvent:
    """Phases accounted by the goodput tracker (north-star metric)."""

    TRAINING = "training"
    COMPILE = "compile"
    RESTART = "restart"
    CHECKPOINT = "checkpoint"
    RENDEZVOUS = "rendezvous"
    IDLE = "idle"

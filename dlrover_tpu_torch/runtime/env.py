"""Trainer-side runtime bootstrap (port of ``dlrover_tpu/runtime/env.py``:
the agent's environment contract at one process).

The agent (ROADMAP Queue 1 item 9) rendezvouses with the master and
exports the world and restart variables named below; the trainer reads
them here.  The names are this module's own copies of the agent's
(``dlrover_tpu/agent/training_agent.py``), so a trainer of either package
reads the same environment.  A multi-process world waits for the mesh
(item 4), and a master client for the control plane (item 9).
"""

from __future__ import annotations

import os

from dlrover_tpu_torch.common.constants import ConfigKey
from dlrover_tpu_torch.common.log import default_logger as logger

ENV_MASTER_ADDR = ConfigKey.MASTER_ADDR
ENV_NODE_ID = ConfigKey.NODE_ID
ENV_COORDINATOR = "DLROVER_TPU_COORDINATOR"
ENV_NUM_PROC = "DLROVER_TPU_NUM_PROCESSES"
ENV_PROC_ID = "DLROVER_TPU_PROCESS_ID"
ENV_RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"


def under_agent() -> bool:
    return ENV_COORDINATOR in os.environ


def process_id() -> int:
    return int(os.environ.get(ENV_PROC_ID, 0))


def num_processes() -> int:
    return int(os.environ.get(ENV_NUM_PROC, 1))


def restart_count() -> int:
    return int(os.environ.get(ENV_RESTART_COUNT, 0))


def node_id() -> int:
    return int(os.environ.get(ENV_NODE_ID, 0))


def initialize(force: bool = False):
    """Join the world the agent rendezvoused for this process: nothing to
    do in a one-process world; more processes wait for the mesh."""
    if not under_agent():
        logger.info("no agent environment; single-process torch")
        return
    n = num_processes()
    if n <= 1 and not force:
        return
    raise NotImplementedError(
        f"a {n}-process world (torch.distributed over the agent's "
        "rendezvous) is a later slice of the port (ROADMAP Queue 1 item 4)"
    )


def master_client(node_type: str = "worker"):
    """The trainer's master client, or None when the environment names no
    master."""
    addr = os.environ.get(ENV_MASTER_ADDR, "")
    if not addr:
        return None
    raise NotImplementedError(
        f"{ENV_MASTER_ADDR}={addr!r} names a master, but the master client "
        f"({node_type}) is a later slice of the port (ROADMAP Queue 1 item "
        "9)"
    )

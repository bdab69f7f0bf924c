"""Trainer-side runtime bootstrap (port of ``dlrover_tpu/runtime/env.py``:
the agent's environment contract).

The agent (``agent/training_agent.py``) rendezvouses with the master and
exports the world and restart variables named below; the trainer reads
them here.  The names are this module's own copies of the agent's, so a
trainer of either package reads the same environment.  ``initialize``
joins the agent's world with ``torch.distributed.init_process_group``
(and, under an agent, installs the SIGUSR1 stack dump the agent collects);
``master_client`` is the trainer's ``agent/master_client.MasterClient``.
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
# The agent's control-plane-only switch: each trainer keeps a world of its
# own while rendezvous, sharding and checkpoints stay multi-host.
ENV_SKIP_INIT = "DLROVER_TPU_SKIP_JAX_INIT"


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


def default_backend(device=None) -> str:
    """The backend that follows the device: NCCL for ``cuda`` (the
    default device), gloo for ``cpu``."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize(force: bool = False, device=None, backend: str = None):
    """Join the world the agent rendezvoused for this process.

    Reads the agent's variables as the reference does: the coordinator
    (``host:port``), the process count and this process's id, and calls
    ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator>`` with that rank and world size.  ``backend``
    defaults to the one that follows ``device`` (NCCL for ``cuda``, gloo
    for ``cpu``); a caller may name gloo on ``cuda`` (a world of several
    processes on one card stages its collectives through the host,
    ``parallel/wire.py``).  Nothing here switches backend on a failure.

    No-op for a one-process job (no group; the mesh is then
    ``runtime.mesh.single_device_mesh``).  With the agent's
    ``DLROVER_TPU_SKIP_JAX_INIT=1`` each process keeps a one-process group
    of its own (a local store), the control plane staying multi-host.
    Safe to call twice: a live group is kept.
    """
    import torch.distributed as dist

    if not under_agent():
        logger.info("no agent environment; single-process torch")
        return
    # Hang-diagnosis seam: the agent can SIGUSR1 this process for an
    # all-thread Python stack dump (agent/stack_collector.py).
    from dlrover_tpu_torch.agent.stack_collector import (
        install_stack_dump_handler,
    )

    install_stack_dump_handler()
    n = num_processes()
    if n <= 1 and not force:
        return
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    if os.environ.get(ENV_SKIP_INIT, "") == "1":
        logger.warning(
            "%s=1: not joining the %d-process world; a one-process group "
            "(control-plane-only multi-host mode)", ENV_SKIP_INIT, n,
        )
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ[ENV_COORDINATOR]}",
        world_size=n,
        rank=process_id(),
    )
    logger.info(
        "joined the torch world: process %d/%d (coordinator %s, %s)",
        process_id(), n, os.environ[ENV_COORDINATOR], backend,
    )


def master_client(node_type: str = "worker"):
    """The trainer's MasterClient, or None when running without a master."""
    addr = os.environ.get(ENV_MASTER_ADDR, "")
    if not addr:
        return None
    from dlrover_tpu_torch.agent.master_client import MasterClient

    return MasterClient(addr, node_id=node_id(), node_type=node_type)

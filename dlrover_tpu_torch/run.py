"""``dlrover-tpu-run`` — the elastic launcher CLI (port of
``dlrover_tpu/run.py``).

Capability ref: ``dlrover/trainer/torch/elastic_run.py:124-388``
(``dlrover-run``: standalone local master spawn, master ping, agent launch)
and its flag surface (``--max-restarts``, node counts).

Usage::

    python -m dlrover_tpu_torch.run --standalone -- python train.py
    python -m dlrover_tpu_torch.run --master host:port --nnodes 4 \\
        --node-id 2 -- python train.py
    python -m dlrover_tpu_torch.run --master-only --port 5000 --nnodes 4

Not ported yet, and refused with ``NotImplementedError`` naming ROADMAP
Queue 1 item 10b's remainder: ``--job-spec`` (``common/job_spec.py``),
``--cloud`` (``master/cloud_launcher.py``, ``master/tpu_api.py``),
``--network-check`` (``agent/node_check.py``) and an elastic range
``--nnodes MIN:MAX`` with MIN below MAX (``master/brain.py``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.agent.training_agent import (
    ElasticAgent,
    ElasticLaunchConfig,
    RunResult,
)

REMAINDER = "ROADMAP Queue 1 item 10b's remainder"


def _parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(prog="dlrover-tpu-run")
    parser.add_argument(
        "--job-spec", default="",
        help="declarative job spec file (refused: not ported yet)",
    )
    parser.add_argument(
        "--standalone", action="store_true",
        help="run an in-process master (single-host jobs, no control plane)",
    )
    parser.add_argument(
        "--master-only", action="store_true",
        help="run the job master alone (cluster jobs: agents join over "
             "the network)",
    )
    parser.add_argument(
        "--cloud", action="store_true",
        help="actuate cloud VMs (refused: not ported yet)",
    )
    parser.add_argument("--port", type=int, default=0,
                        help="master port (0 = ephemeral)")
    parser.add_argument("--master", default="", help="master host:port")
    parser.add_argument("--nnodes", default="1",
                        help="N hosts (an elastic MIN:MAX range is refused)")
    parser.add_argument("--node-id", type=int,
                        default=int(os.environ.get("TPU_WORKER_ID", 0)))
    parser.add_argument("--node-unit", type=int, default=1,
                        help="world size must be a multiple of this")
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--monitor-interval", type=float, default=5.0)
    parser.add_argument("--heartbeat-interval", type=float, default=15.0)
    parser.add_argument("--network-check", action="store_true",
                        help="pre-flight node check (refused: not ported "
                             "yet)")
    parser.add_argument("--save-at-breakpoint", action="store_true")
    parser.add_argument(
        "--live-relayout", action="store_true",
        help="on membership change, re-rendezvous but keep the trainer "
             "running — it re-lays-out its virtual mesh in place "
             "(pair with the trainer's --live-relayout flag)",
    )
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument(
        "--device-init-timeout", type=float, default=900.0,
        help="fail/restart a trainer with no first step within this bound "
             "(a wedged device runtime hangs below Python; 0 disables)",
    )
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="-- trainer command")
    args = parser.parse_args(argv)
    for flag, module in (("job_spec", "common/job_spec.py"),
                         ("cloud", "master/cloud_launcher.py"),
                         ("network_check", "agent/node_check.py")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} ({module}) is not ported yet "
                f"({REMAINDER})"
            )
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    if min_nodes < max_nodes:
        raise NotImplementedError(
            f"--nnodes {args.nnodes}: an elastic range needs the running-"
            f"job optimizer (master/brain.py), not ported yet ({REMAINDER})"
        )
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if not args.command and not args.master_only:
        parser.error(
            "no trainer command given (use: ... -- python train.py)"
        )
    return args


def _parse_nnodes(spec: str) -> Tuple[int, int]:
    if ":" in spec:
        lo, hi = spec.split(":")
        return int(lo), int(hi)
    n = int(spec)
    return n, n


def _launch_local_master(num_nodes: int, node_unit: int, min_nodes: int = 0):
    """Standalone mode: in-process master (ref
    ``_launch_dlrover_local_master`` ``elastic_run.py:344-351``)."""
    from dlrover_tpu_torch.master.job_master import JobMaster

    master = JobMaster(
        port=0, num_nodes=num_nodes, node_unit=node_unit,
        min_nodes=min_nodes,
    )
    port = master.start()
    return master, f"localhost:{port}"


def build_cluster_master(args):
    """--master-only wiring: a network-facing JobMaster (the reference's
    operator role: the master IS the job controller)."""
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.master.messages import free_port

    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    port = args.port or free_port()
    return JobMaster(
        port=port, num_nodes=max_nodes, node_unit=args.node_unit,
        min_nodes=min_nodes,
    )


def _run_master_only(args) -> int:
    master = build_cluster_master(args)
    port = master.start()
    logger.info("cluster master on port %d", port)
    try:
        while True:
            phase = master.job_phase()
            if phase == "failed":
                logger.error(
                    "job failed: %s", master.node_manager.job_failure_reason
                )
                return 1
            if phase == "succeeded":
                logger.info("job succeeded")
                return 0
            time.sleep(2.0)
    except KeyboardInterrupt:
        return 130
    finally:
        master.stop()


def run(argv: Optional[List[str]] = None) -> int:
    args = _parse_args(argv)
    if args.master_only:
        return _run_master_only(args)
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    local_master = None
    if args.standalone or not args.master:
        local_master, master_addr = _launch_local_master(
            max_nodes, args.node_unit, min_nodes
        )
        logger.info("standalone master at %s", master_addr)
    else:
        master_addr = args.master
    config = ElasticLaunchConfig(
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        node_unit=args.node_unit,
        max_restarts=args.max_restarts,
        monitor_interval=args.monitor_interval,
        heartbeat_interval=args.heartbeat_interval,
        network_check=args.network_check,
        save_at_breakpoint=args.save_at_breakpoint,
        checkpoint_dir=args.checkpoint_dir,
        device_init_timeout=args.device_init_timeout,
        live_relayout=args.live_relayout,
    )
    agent = ElasticAgent(
        config, args.command, master_addr, node_id=args.node_id
    )
    result = RunResult.FAILED
    try:
        result = agent.run()
    finally:
        agent.shutdown(job_succeeded=result == RunResult.SUCCEEDED)
        if local_master is not None:
            local_master.stop()
    logger.info("job finished: %s", result.value)
    return 0 if result == RunResult.SUCCEEDED else 1


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()

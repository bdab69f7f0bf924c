"""``dlrover-tpu-run`` — the elastic launcher CLI (port of
``dlrover_tpu/run.py``).

Capability ref: ``dlrover/trainer/torch/elastic_run.py:124-388``
(``dlrover-run``: standalone local master spawn, master ping, agent launch)
and its flag surface (``--network-check``, ``--max-restarts``, node counts).

Usage::

    python -m dlrover_tpu_torch.run --standalone -- python train.py
    python -m dlrover_tpu_torch.run --master host:port --nnodes 4 \
        --node-id 2 --network-check -- python train.py
    python -m dlrover_tpu_torch.run --standalone --job-spec job.toml
    python -m dlrover_tpu_torch.run --master-only --cloud --job-spec job.toml

``--network-check`` probes the local cards; ``--node-check-device cpu``
runs the same probes on the CPU (a host without a card fails the check
on ``cuda``, it is never moved to the CPU).
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


def _parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(prog="dlrover-tpu-run")
    parser.add_argument(
        "--job-spec", default="",
        help="declarative ElasticJobSpec file (.toml/.yaml/.json); CLI "
             "flags explicitly given override the spec (the reference's "
             "CRD-spec tier, elasticjob_types.go)",
    )
    parser.add_argument(
        "--standalone", action="store_true",
        help="run an in-process master (single-host jobs, no control plane)",
    )
    parser.add_argument(
        "--master-only", action="store_true",
        help="run the job master alone (cluster jobs: agents join over "
             "the network); with --cloud it also creates the TPU VMs",
    )
    parser.add_argument(
        "--cloud", action="store_true",
        help="actuate TPU VMs via tpu.googleapis.com (master/tpu_api.py); "
             "requires --master-only and a --job-spec with [accelerator]",
    )
    parser.add_argument("--port", type=int, default=0,
                        help="master port (0 = ephemeral)")
    parser.add_argument("--master", default="", help="master host:port")
    parser.add_argument("--nnodes", default="1",
                        help="N or MIN:MAX elastic range of hosts")
    parser.add_argument("--node-id", type=int,
                        default=int(os.environ.get("TPU_WORKER_ID", 0)))
    parser.add_argument("--node-unit", type=int, default=1,
                        help="world size must be a multiple of this (slice size)")
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--monitor-interval", type=float, default=5.0)
    parser.add_argument("--heartbeat-interval", type=float, default=15.0)
    parser.add_argument("--network-check", action="store_true")
    parser.add_argument(
        "--node-check-device", default="cuda", choices=("cuda", "cpu"),
        help="where the network check's probes run (default: the cards)",
    )
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
    spec = None
    if args.job_spec:
        from dlrover_tpu_torch.common.job_spec import load_job_spec

        spec = load_job_spec(args.job_spec)
        # Precedence: spec < explicitly-given CLI flags.  argparse skips
        # defaults for attributes already present on the namespace, so
        # re-parsing over a spec-seeded namespace leaves spec values in
        # place unless the flag appeared on the command line.
        ns = argparse.Namespace(
            nnodes=f"{spec.nodes.min}:{spec.nodes.max}",
            node_unit=spec.nodes.unit,
            max_restarts=spec.trainer.max_restarts,
            monitor_interval=spec.trainer.monitor_interval,
            heartbeat_interval=spec.trainer.heartbeat_interval,
            checkpoint_dir=spec.checkpoint.dir,
            device_init_timeout=spec.trainer.device_init_timeout,
        )
        args = parser.parse_args(argv, namespace=ns)
        # store_true flags cannot be "unset" on the CLI: OR semantics.
        args.network_check = (
            args.network_check or spec.trainer.network_check
        )
        args.save_at_breakpoint = (
            args.save_at_breakpoint or spec.checkpoint.save_at_breakpoint
        )
    args.spec = spec
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if not args.command and spec is not None:
        args.command = list(spec.trainer.command)
    if not args.command and not args.master_only:
        parser.error(
            "no trainer command given (use: ... -- python train.py, or "
            "[trainer].command in the job spec)"
        )
    if args.cloud and (not args.master_only or spec is None):
        parser.error("--cloud requires --master-only and --job-spec")
    return args


def _parse_nnodes(spec: str) -> Tuple[int, int]:
    if ":" in spec:
        lo, hi = spec.split(":")
        return int(lo), int(hi)
    n = int(spec)
    return n, n


def _master_kwargs_from_spec(spec) -> dict:
    """The [master]+[brain] spec sections as JobMaster kwargs — one
    place, so standalone and cluster masters cannot silently diverge."""
    if spec is None:
        return {}
    import dataclasses as _dc

    return dict(
        heartbeat_timeout=spec.master.heartbeat_timeout,
        hang_threshold=spec.master.hang_threshold,
        optimize_interval_s=spec.master.optimize_interval_s,
        rdzv_waiting_timeout=spec.master.rdzv_waiting_timeout,
        max_relaunches=spec.master.max_relaunches,
        state_path=spec.master.state_path,
        brain_overrides=_dc.asdict(spec.brain),
        pools=(
            {"coworker": spec.nodes.coworkers}
            if spec.nodes.coworkers else None
        ),
    )


def _launch_local_master(
    num_nodes: int, node_unit: int, min_nodes: int = 0, spec=None
):
    """Standalone mode: in-process master (ref
    ``_launch_dlrover_local_master`` ``elastic_run.py:344-351``)."""
    from dlrover_tpu_torch.master.job_master import JobMaster

    master_kwargs = _master_kwargs_from_spec(spec)
    master = JobMaster(
        port=0, num_nodes=num_nodes, node_unit=node_unit,
        min_nodes=min_nodes, **master_kwargs,
    )
    port = master.start()
    return master, f"localhost:{port}"


def build_cluster_master(args, launcher_factory=None):
    """--master-only wiring: a network-facing JobMaster, optionally with
    cloud TPU-VM actuation (the reference's operator role: the master IS
    the job controller; ``elasticjob_controller.go``).

    ``launcher_factory(spec, master_addr)`` is the test seam; production
    uses ``tpu_api.make_cloud_launcher``.
    """
    import socket

    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.master.messages import free_port

    spec = args.spec
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    port = args.port or free_port()
    launcher = None
    if args.cloud:
        host = os.environ.get("DLROVER_TPU_MASTER_HOST") or (
            socket.gethostbyname(socket.gethostname())
        )
        master_addr = f"{host}:{port}"
        if launcher_factory is None:
            from dlrover_tpu_torch.master.tpu_api import make_cloud_launcher

            def launcher_factory(spec, master_addr):
                return make_cloud_launcher(
                    spec.job_name, master_addr,
                    accelerator_type=spec.accelerator.type,
                    runtime_version=spec.accelerator.runtime_version,
                    preemptible=spec.accelerator.preemptible,
                    project=spec.accelerator.project,
                    zone=spec.accelerator.zone,
                )

        launcher = launcher_factory(spec, master_addr)
    master_kwargs = _master_kwargs_from_spec(spec)
    master = JobMaster(
        port=port, num_nodes=max_nodes, node_unit=args.node_unit,
        min_nodes=min_nodes, launcher=launcher, **master_kwargs,
    )
    return master, launcher


def _run_master_only(args) -> int:
    master, launcher = build_cluster_master(args)
    port = master.start()
    logger.info("cluster master on port %d (cloud=%s)", port, args.cloud)
    if launcher is not None:
        master.bootstrap_nodes()
    terminal = False
    try:
        while True:
            phase = master.job_phase()
            if phase == "failed":
                terminal = True
                logger.error(
                    "job failed: %s", master.node_manager.job_failure_reason
                )
                return 1
            if phase == "succeeded":
                terminal = True
                logger.info("job succeeded")
                return 0
            time.sleep(2.0)
    except KeyboardInterrupt:
        return 130
    finally:
        if launcher is not None:
            if terminal:
                # Operator teardown: a finished cloud job must not leave
                # billing VMs behind.
                master.teardown_nodes()
            else:
                # Ctrl-C / master crash mid-job: leave the nodes (and the
                # job they are running) up so a restarted master can
                # reattach via state_path instead of finding a torn-down
                # slice.  Terminal phases above still clean up billing VMs.
                logger.warning(
                    "master exiting before the job finished; leaving "
                    "nodes up for a reattaching master (state_path)"
                )
        master.stop()
        if launcher is not None and hasattr(launcher, "shutdown"):
            launcher.shutdown()


def run(argv: Optional[List[str]] = None) -> int:
    args = _parse_args(argv)
    if args.master_only:
        return _run_master_only(args)
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    if args.spec is not None and args.spec.trainer.env:
        # The agent hands its own environment to the trainer subprocess.
        os.environ.update(args.spec.trainer.env)
    if args.spec is not None and getattr(args.spec, "faults", None) and (
        args.spec.faults.plan
    ):
        # Arm Faultline in this process AND every child (agents hand their
        # env to trainer subprocesses): one spec drives a deterministic
        # chaos run across the whole job.
        from dlrover_tpu_torch.common import faults

        os.environ[faults.ENV_PLAN] = args.spec.faults.plan
        os.environ[faults.ENV_SEED] = str(args.spec.faults.seed)
        faults.configure_from_env()
    local_master = None
    if args.standalone or not args.master:
        local_master, master_addr = _launch_local_master(
            max_nodes, args.node_unit, min_nodes, spec=args.spec
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
        node_check_device=args.node_check_device,
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

"""End-to-end elastic LM training example, nanoGPT-scale, on the card
(port of ``examples/train_lm.py``).

    python -m dlrover_tpu_torch.examples.train_lm --steps 50 \\
        --checkpoint-dir /tmp/ckpt

The full loop through :class:`ElasticTrainer`: the agent's environment,
the train step, step reporting, Flash Checkpoint every ``--ckpt-every``
steps, and crash-resume (a restart picks up from the latest checkpoint).
Under the agent's world (``runtime/env.initialize``: one process a
device, NCCL on ``cuda``, gloo on ``cpu``) the step is data-parallel, with
``--zero1``, ``--overlap``, ``--reduce-quant int8`` and
``--allgather-quant int8``, and ``--live-relayout`` polls the master's
node ledger and re-folds the world in place.  Under a master (the agent's
``DLROVER_TPU_MASTER_ADDR``) the loader takes its shards from the
master's task manager, the trainer reports its steps, events and
telemetry, and ``--timeline`` writes the master's merged timeline.  The
flags are the reference's, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain versions of the kernels) and ``--memory-report`` (the
classified device-memory snapshot on the report cadence).  A flag whose
feature is not ported raises ``NotImplementedError`` naming its ROADMAP
queue item: ``--auto-tune`` is item 10c.  ``--profile-every`` captures
one step in a ``torch.profiler`` window every N steps.
``--attention-impl ring`` runs ring attention
(``parallel/ring_attention.py``): a ring of one on the data-parallel
world, the sequence kept whole on each rank.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8,
                   help="GLOBAL batch size (constant across elasticity)")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--dataset-size", type=int, default=100000)
    p.add_argument("--fail-at-step", type=int, default=0,
                   help="test hook: crash at this step on first run")
    p.add_argument("--step-sleep", type=float, default=0.0,
                   help="test hook: slow steps down (chaos windows)")
    p.add_argument("--remat", default="none",
                   help="remat policy (ops/remat_policy.py): none, full, "
                        "attn_out, branch_out, flash_only, flash_res, "
                        "offload, offload:<name>[,<name>...]")
    p.add_argument("--auto-tune", action="store_true",
                   help="search the strategy before training (ROADMAP "
                        "Queue 1 item 10c)")
    p.add_argument("--optimizer", default="adamw",
                   help="adamw | adafactor | sgd | lion | q8_adam | agd")
    p.add_argument("--metrics-lag", type=int, default=0,
                   help="defer metrics materialization by N steps (one "
                        "batched device fetch per N steps; 0 = sync)")
    p.add_argument("--prefetch", type=int, default=0,
                   help="device-resident batches to keep ahead of compute "
                        "(H2D of batch N+1 overlaps step N; 0 = off)")
    p.add_argument("--warmup-compile", action="store_true",
                   help="the reference's AOT compile at startup (refused: "
                        "eager PyTorch compiles nothing ahead of time)")
    p.add_argument("--compile-cache-dir", default="",
                   help="the reference's persistent XLA cache (refused "
                        "when set: no counterpart)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches per step: split the global batch "
                        "into N sequential microbatches and accumulate "
                        "gradients (same tokens/step, 1/N the activation "
                        "memory)")
    p.add_argument("--accum-dtype", default="float32",
                   help="gradient accumulator dtype: float32 (default) | "
                        "bfloat16")
    p.add_argument("--reduce-quant", default="none",
                   help="wire format of the data-parallel gradient reduce: "
                        "none (full precision) | int8 (block-quantized "
                        "all-reduce; with --zero1, a quantized "
                        "reduce-scatter)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 sharded weight update: optimizer state and "
                        "update sharded over the data ranks, the reduce a "
                        "reduce-scatter + all-gather")
    p.add_argument("--overlap", action="store_true",
                   help="overlap engine (with --zero1): each microbatch's "
                        "reduce-scatter issued per bucket off the backward, "
                        "the all-gather per bucket after the update")
    p.add_argument("--overlap-bucket-mb", type=float, default=4.0,
                   help="collective bucket size (MB of wire bytes) for the "
                        "overlap engine")
    p.add_argument("--allgather-quant", default="none",
                   help="wire format of the zero1 parameter all-gather: "
                        "none | int8")
    p.add_argument("--attention-impl", default="xla",
                   choices=("xla", "flash", "ring"),
                   help="attention math: xla (plain softmax), flash (the "
                        "CUDA flash kernels on the card), ring (blockwise "
                        "ring attention with online-softmax merges)")
    p.add_argument("--flash-block-q", type=int, default=0,
                   help="flash attention query block size (0 = model "
                        "default)")
    p.add_argument("--flash-block-kv", type=int, default=0,
                   help="flash attention key/value block size (0 = model "
                        "default)")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="mixture-of-experts: replace each block's MLP with "
                        "N routed experts (0 = dense)")
    p.add_argument("--moe-top-k", type=int, default=2,
                   help="experts each token is routed to")
    p.add_argument("--moe-capacity-factor", type=float, default=1.25,
                   help="per-expert slot budget as a multiple of the "
                        "balanced load")
    p.add_argument("--moe-dispatch", default="einsum",
                   choices=("einsum", "a2a", "a2a_int8", "grouped"),
                   help="expert dispatch: einsum, a2a and a2a_int8 (run as "
                        "einsum: one device, no expert axis), grouped (the "
                        "grouped-GEMM kernels)")
    p.add_argument("--sdc-check-every", type=int, default=0,
                   help="silent-data-corruption sentry: every N steps, "
                        "digest the post-update train state on device "
                        "(0 = off)")
    p.add_argument("--lockstep-data", action="store_true",
                   help="skip master data sharding so every node consumes "
                        "the identical sequential sample stream")
    p.add_argument("--ref-world", type=int, default=0,
                   help="logical member count the job was sized for "
                        "(virtual-mesh reference world); 0 = the process "
                        "group's size")
    p.add_argument("--live-relayout", action="store_true",
                   help="poll the master's node ledger every 2 steps and "
                        "fold the virtual mesh in place when the live "
                        "member count changes")
    p.add_argument("--timeline", default="",
                   help="write this process's telemetry (step/checkpoint "
                        "spans) as a Chrome-trace JSON at exit")
    p.add_argument("--profile-every", type=int, default=0,
                   help="device-time capture every N steps (one step in a "
                        "torch.profiler window; utils/device_profile)")
    p.add_argument("--memory-report", action="store_true",
                   help="register the state as the params/opt_state pools "
                        "and ship a classified memory event on the report "
                        "cadence (utils/memory_profile)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from dlrover_tpu_torch.common.log import default_logger as logger
    from dlrover_tpu_torch.data.loader import (
        ElasticDataLoader,
        synthetic_lm_sample_fn,
    )
    from dlrover_tpu_torch.data.sharding_client import ShardingClient
    from dlrover_tpu_torch.models.gpt2 import gpt2_config
    from dlrover_tpu_torch.runtime import env as renv
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        ElasticTrainer,
        TrainerConfig,
    )

    renv.initialize(device=args.device)
    client = renv.master_client()

    model_kw = dict(
        num_layers=args.layers,
        d_model=args.d_model,
        num_heads=args.heads,
        vocab_size=args.vocab,
        max_seq_len=args.seq_len,
        remat=args.remat,
        attention_impl=args.attention_impl,
    )
    if args.flash_block_q:
        model_kw["flash_block_q"] = args.flash_block_q
    if args.flash_block_kv:
        model_kw["flash_block_kv"] = args.flash_block_kv
    if args.moe_experts:
        model_kw.update(
            num_experts=args.moe_experts,
            top_k=args.moe_top_k,
            capacity_factor=args.moe_capacity_factor,
            moe_dispatch=args.moe_dispatch,
        )
    cfg = gpt2_config("124m", **model_kw)
    trainer = ElasticTrainer(
        cfg,
        TrainerConfig(
            global_batch_size=args.batch_size,
            seq_len=args.seq_len,
            optimizer=args.optimizer,
            learning_rate=1e-3,
            checkpoint_dir=args.checkpoint_dir,
            ckpt_every=args.ckpt_every,
            auto_tune=args.auto_tune,
            metrics_lag=args.metrics_lag,
            prefetch_to_device=args.prefetch,
            warmup_compile=args.warmup_compile,
            compile_cache_dir=args.compile_cache_dir,
            grad_accum=args.grad_accum,
            accum_dtype=args.accum_dtype,
            reduce_quant=args.reduce_quant,
            zero1=args.zero1,
            overlap=args.overlap,
            overlap_bucket_mb=args.overlap_bucket_mb,
            allgather_quant=args.allgather_quant,
            sdc_check_every=args.sdc_check_every,
            profile_every=args.profile_every,
            memory_report=args.memory_report,
            world=args.ref_world,
            grad_accum_ref_world=args.ref_world,
        ),
        client=client,
        device=args.device,
    )

    # Each process's loader produces its local slice of the global batch,
    # split over the processes of the torch world (the reference's
    # ``jax.process_count()``): under the agent's control-plane-only
    # switch each trainer is a world of one.
    import torch.distributed as dist

    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if args.batch_size % n_proc:
        raise ValueError(
            f"--batch-size {args.batch_size} must be divisible by the "
            f"{n_proc}-process world"
        )
    local_batch = args.batch_size // n_proc
    if client is not None and not args.lockstep_data:
        loader_source = ShardingClient(
            client,
            "train",
            dataset_size=args.dataset_size,
            shard_size=local_batch * 8,
            num_epochs=8,
            create=True,
        )
    else:
        loader_source = None
    loader = ElasticDataLoader(
        synthetic_lm_sample_fn(args.vocab, args.seq_len),
        batch_size=local_batch,
        source=loader_source,
    )

    # Live-relayout: watch the master's node ledger and fold/fan the
    # virtual mesh in place when the live member count changes.  Dead or
    # preempting members drop out of the "running" set; the survivor
    # re-lays-out state onto itself instead of restarting from storage.
    live_world = [trainer.vmesh.physical_world]

    def _poll_world(step):
        try:
            status = client.get_job_status()
        except Exception as e:  # noqa: BLE001 - master may be mid-resize
            logger.warning("live-relayout: job status poll failed: %s", e)
            return
        alive = sum(1 for s in status.nodes.values() if s == "running")
        if alive >= 1 and alive != live_world[0]:
            logger.info(
                "live-relayout: world %d -> %d at step %d",
                live_world[0], alive, step,
            )
            detail = trainer.apply_world_change(alive, reason="scale")
            if detail.get("ok"):
                live_world[0] = alive

    def on_step(step, metrics):
        if args.fail_at_step and step == args.fail_at_step:
            if renv.restart_count() == 0:
                logger.error("test hook: crashing at step %d", step)
                os._exit(17)
        if args.live_relayout and client is not None and step % 2 == 0:
            _poll_world(step)
        if args.step_sleep:
            time.sleep(args.step_sleep)

    trainer.fit(loader, max_steps=args.steps, on_step=on_step)
    trainer.close()
    if args.timeline:
        _write_timeline(args.timeline, client)
    return 0


def _write_timeline(path: str, client):
    """Dump the run's telemetry as a Chrome trace.

    With a master attached, its merged timeline covers every node;
    standalone runs fall back to this process's own ring.
    """
    import json

    from dlrover_tpu_torch.common import telemetry
    from dlrover_tpu_torch.common.log import default_logger as logger
    from dlrover_tpu_torch.runtime import env as renv

    events = {}
    if client is not None:
        try:
            events = {
                int(n): list(evs)
                for n, evs in client.get_timeline().items()
            }
        except Exception as e:  # noqa: BLE001 - best-effort at exit
            logger.warning("timeline fetch from master failed: %s", e)
    local = telemetry.recorder().drain()
    if local or not events:
        events.setdefault(renv.node_id(), []).extend(local)
    trace = telemetry.events_to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(trace, f)
    logger.info(
        "timeline: %d events -> %s",
        sum(len(evs) for evs in events.values()), path,
    )


if __name__ == "__main__":
    sys.exit(main())

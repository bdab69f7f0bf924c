"""ElasticTrainer: the reusable high-level training loop (port of
``dlrover_tpu/trainer/elastic_trainer.py``).

Capability ref: ``dlrover/trainer/torch/elastic/trainer.py:181-336``
(``ElasticTrainer.step`` keeps the global batch fixed via gradient
accumulation when the world shrinks) and the HF-style façade
``atorch/atorch/trainer/atorch_trainer.py:136``.

The façade is the glue every trainer re-implements around the step
(``train_lib.build_train``): checkpoint restore and save cadence (Flash
Checkpoint), master step reporting, numeric health, the silent-data-
corruption digest, the deferred-metrics ring and the device prefetcher,
and the crash/elastic-resume contract.  The global batch is a property of
the step; ``grad_accum`` is recomputed from the booked reference world
on every restore (``_adopt_checkpoint_accum``).

The data-parallel world: ``parallel=ParallelConfig(data=-1)`` (the
default) builds the mesh over the default process group
(``runtime/mesh.build_mesh``; ``runtime/env.initialize`` joins the
agent's world), and the step is ``train_lib.build_train`` on it with the
config's ``zero1``, ``overlap``, ``reduce_quant`` and ``allgather_quant``.
``world`` defaults to the group's size, as the reference's defaults to
its device count.  Flash Checkpoint saves each rank's pieces under
``Train.checkpoint_layout`` and a restore lays them out for this world,
whatever world saved them.  The numeric-health save decision and the SDC
digest are taken over the group.  ``apply_world_change`` re-folds the
virtual mesh live: the data group stays (as the reference's per-process
mesh does), the fold's ``grad_accum`` follows the new world, the state is
re-laid out in memory through the checkpoint's record path
(``virtual_mesh.relayout_state``), and the sampler rebinds; a failed
re-layout retries under its ``relayout.apply`` fault seam and falls back
to a restore.

The fsdp, tensor and expert axes: ``parallel=ParallelConfig(fsdp=..,
tensor=.., expert=..)`` builds the step on that mesh
(``train_lib.build_train``: each rank holds its boxes of the parameters
and the optimizer state, and the batch group is ``data x fsdp x
expert``).  Flash Checkpoint saves each rank's
boxes under their global indices, so a save at one mesh restores into
another (into one process, for one).  The SDC digest completes each
split leaf's byte sum over the world.  A live re-layout folds the data
axis only; on a mesh with an fsdp or tensor axis above 1 it is refused
(ROADMAP Queue 1 item 5), and with an expert axis above 1 too, until the
virtual mesh has its expert fields (item 6's remainder), and with a seq
or pipe axis above 1 (item 9's remainder).  ``fit`` runs on a seq mesh
(Ulysses or ring attention) and on a pipe mesh (one pipeline stage a
rank) as on the others.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Not ported yet, and refused with ``NotImplementedError`` when asked for:
``auto_tune`` (item 10c).  The measurement planes are here: every
``profile_every`` steps one step runs in a ``torch.profiler`` window
(``utils/device_profile``) and books measured phase rows and a
calibration event; ``memory_report`` registers the state's tensors as
the ``params`` and ``opt_state`` pools (``utils/memory_profile``) and
ships a ``memory`` event on the report cadence; a step that dies of an
allocator failure writes ``oom_postmortem.json`` next to
``checkpoint_dir`` before the error propagates; and every report writes
the agent's device-metrics file (``agent/monitor.write_device_metrics``)
where one is configured.  An MoE model's router statistics are
harvested on the report cadence (``train_lib.build_moe_stats_fn``, a
forward of its own) and shipped as ``moe`` telemetry events with the
report.  Eager PyTorch has nothing to compile ahead of time, so
``warmup_compile``, ``prewarm_worlds(aot=True)`` and a persistent
``compile_cache_dir`` are refused too, and ``reuse_compiled`` has no
effect (item 3).

The host's garbage collector: ``fit`` runs one full collection before its
first step and freezes what survives (``gc.freeze``) until it returns, so
a collection of the oldest generation during a step scans only what the
loop made.  Unfrozen, such a collection walks every object of the
process at a step boundary, where the device's launch queue holds tens
of milliseconds of work; on an H100 under GPT-2 1.5B it took 264-290 ms
inside a step (PERF.md, PR 20).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common import faults, telemetry
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.retry import RetryError, RetryPolicy
from dlrover_tpu_torch.models.transformer import TransformerConfig
from dlrover_tpu_torch.optimizers import optax_ports as ox
from dlrover_tpu_torch.parallel import rules as lr
from dlrover_tpu_torch.runtime import env as renv
from dlrover_tpu_torch.runtime import mesh as mesh_lib
from dlrover_tpu_torch.runtime import virtual_mesh
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device
from dlrover_tpu_torch.trainer import state_digest, train_lib
from dlrover_tpu_torch.utils.profiler import pipeline_counters


@dataclasses.dataclass
class TrainerConfig:
    global_batch_size: int = 8
    seq_len: int = 128
    optimizer: str = "adamw"
    learning_rate: float = 1e-3
    # LR schedule (train_lib.make_schedule): warmup-linear, then cosine
    # decay when decay_steps > 0.
    warmup_steps: int = 0
    decay_steps: int = 0
    checkpoint_dir: str = ""
    ckpt_every: int = 100
    report_every: int = 5
    # Evaluation cadence: 0 disables periodic eval during fit().
    eval_every: int = 0
    eval_batches: int = 10
    # Strategy search (ROADMAP Queue 1 item 10c): refused.
    auto_tune: bool = False
    ce_chunks: int = 0
    # Numeric health (trainer/numeric_health.py): anomalies ship to the
    # master with step reports.
    numeric_checks: bool = True
    # -- async step pipeline ------------------------------------------------
    # Deferred metrics: keep step metrics in a ring, their copy to the
    # host queued behind each step, and every this many steps materialize
    # all but the newest step's with ONE blocking wait (the newest step
    # still runs: waiting for it would leave the device idle until the
    # next step is dispatched); flushed whole at eval/checkpoint/
    # end-of-fit.  0 = synchronous: every report blocks on the loss.
    metrics_lag: int = 0
    # Keep this many batches device-resident ahead of compute so the H2D
    # copy of batch N+1 overlaps step N (data.loader.DevicePrefetcher).
    # 0 = place each batch on the step's critical path.
    prefetch_to_device: int = 0
    # -- restart-fast build ------------------------------------------------
    # The reference reuses its compiled step when (config, mesh) repeats.
    # No effect here: an eager Train holds nothing compiled to reuse
    # (ROADMAP Queue 1 item 3).
    reuse_compiled: bool = True
    # The reference's AOT compile at construction: refused (eager PyTorch
    # compiles nothing ahead of time).
    warmup_compile: bool = False
    # The reference's persistent XLA cache: refused when set (no
    # counterpart).
    compile_cache_dir: str = ""
    # -- microbatch engine --------------------------------------------------
    # Gradient accumulation: split the global batch into N microbatches,
    # gradients summed on device.  Tokens/step is invariant in N; on a
    # restore into another world the effective N is recomputed from the
    # reference world below.
    grad_accum: int = 1
    # Accumulator dtype: "float32" (default) or "bf16".
    accum_dtype: str = "float32"
    # "int8" routes the data-parallel gradient reduce through the int8
    # wire (parallel/quantized_collectives.py; K5a/K5b on the card).
    reduce_quant: str = "none"
    # ZeRO-1 sharded weight update (optimizers/zero1.py).
    zero1: bool = False
    # Overlap engine (parallel/overlap.py; with zero1).
    overlap: bool = False
    # Collective bucket size for the overlap engine's wave schedule.
    overlap_bucket_mb: float = 4.0
    # "int8" zero1 param all-gather under the overlap engine.
    allgather_quant: str = "none"
    # -- silent data corruption ---------------------------------------------
    # Every N steps, digest the post-update train state on device
    # (trainer/state_digest.py) and queue it for the master's cross-replica
    # vote.  0 disables: nothing is built or allocated.
    sdc_check_every: int = 0
    # -- device-time capture ---------------------------------------------------
    # Every N steps, run ONE step in a ``torch.profiler`` window and emit
    # the parsed per-phase device seconds as ``source="measured"`` timeline
    # rows + a calibration event (utils/device_profile.py).  The captured
    # step pays one host-device sync plus the trace export and parse; 0
    # disables — no profiler object is built and the step path allocates
    # nothing.
    profile_every: int = 0
    # -- classified device-memory accounting ----------------------------------
    # Register the trainer's tensors (params / optimizer state) in the
    # utils/memory_profile registry and ship one flat-attr ``memory``
    # telemetry event per report tick: allocator bytes, per-pool classified
    # bytes and the measured-vs-modeled pairing.  Off (default): the step
    # path pays one attribute read and nothing else.
    memory_report: bool = False
    # World size ``grad_accum`` was chosen for; 0 = the world at first
    # construction.  Booked in checkpoint `extra` so a restore into a
    # different world recomputes N from the ORIGINAL reference pairing.
    grad_accum_ref_world: int = 0
    # -- virtual mesh ---------------------------------------------------------
    # Logical member count for elastic accounting (0 = the process
    # group's size).
    world: int = 0


def _refuse_unported(config: TrainerConfig) -> None:
    """Raise for every option whose feature the port does not have yet."""
    def later(what: str, item: str):
        raise NotImplementedError(
            f"{what} is a later slice of the port (ROADMAP Queue 1 item "
            f"{item})")

    for name, value in (("reduce_quant", config.reduce_quant),
                        ("allgather_quant", config.allgather_quant)):
        if value not in ("none", "int8"):
            raise ValueError(f"{name} {value!r} must be 'none' or 'int8'")
    if config.auto_tune:
        later("TrainerConfig.auto_tune", "10c")
    if config.warmup_compile:
        raise NotImplementedError(
            "TrainerConfig.warmup_compile: eager PyTorch has nothing to "
            "compile ahead of time (ROADMAP Queue 1 item 3)")
    if config.compile_cache_dir:
        raise NotImplementedError(
            "TrainerConfig.compile_cache_dir: there is no persistent "
            "compile cache in eager PyTorch (ROADMAP Queue 1 item 3)")


class TrainerCallback:
    """Hook surface of the fit loop (ref ``atorch_trainer.py`` callbacks /
    the HF TrainerCallback contract it implements).  Subclass and override;
    every method is optional."""

    def on_train_begin(self, trainer: "ElasticTrainer"):
        pass

    def on_step_end(self, trainer: "ElasticTrainer", step: int,
                    metrics: Dict[str, Any]):
        pass

    def on_evaluate(self, trainer: "ElasticTrainer", step: int,
                    eval_metrics: Dict[str, float]):
        pass

    def on_checkpoint(self, trainer: "ElasticTrainer", step: int):
        pass

    def on_epoch_end(self, trainer: "ElasticTrainer", epoch: int):
        pass

    def on_train_end(self, trainer: "ElasticTrainer", step: int):
        pass


def _fetch(entries: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Every value of ``entries`` as a float, with ONE device-to-host read
    for all the tensors among them (fp32 and integer scalars are exact in
    fp64)."""
    tensors = [v for entry in entries for v in entry.values()
               if isinstance(v, torch.Tensor)]
    values = iter(())
    if tensors:
        stacked = torch.stack([t.detach().reshape(()).to(torch.float64)
                               for t in tensors])
        values = iter(stacked.cpu().tolist())
    return [{k: next(values) if isinstance(v, torch.Tensor) else float(v)
             for k, v in entry.items()} for entry in entries]


class _InFlight:
    """One step's metrics on their way to the host.  On the card their
    tensors are stacked and copied, non-blocking, into pinned memory right
    behind the step that made them, and an event marks the copy's end:
    reading them waits for that step alone, not for the steps dispatched
    after it.  Elsewhere they are read as :func:`_fetch` reads them."""

    def __init__(self, metrics: Dict[str, Any]):
        self.metrics = metrics
        self.host = self.event = None
        tensors = [v for v in metrics.values() if isinstance(v, torch.Tensor)]
        if tensors and all(t.is_cuda for t in tensors):
            stacked = torch.stack([t.detach().reshape(()).to(torch.float64)
                                   for t in tensors])
            self.host = torch.empty(stacked.shape, dtype=torch.float64,
                                    pin_memory=True)
            self.host.copy_(stacked, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(stacked.device))

    def read(self) -> Dict[str, float]:
        """The metrics as floats (fp32 and integer scalars are exact in
        fp64)."""
        if self.event is None:
            (host,) = _fetch([self.metrics])
            return host
        self.event.synchronize()
        values = iter(self.host.tolist())
        return {k: next(values) if isinstance(v, torch.Tensor) else float(v)
                for k, v in self.metrics.items()}


class ElasticTrainer:
    """Training loop with flash checkpointing + master reporting.

    Usage::

        trainer = ElasticTrainer(model_config, TrainerConfig(...))
        trainer.fit(loader, max_steps=1000)
        trainer.close()
    """

    def __init__(
        self,
        model_config: TransformerConfig,
        config: TrainerConfig,
        parallel=None,
        rules=None,
        optimizer: Optional[ox.GradientTransformation] = None,
        client=None,
        callbacks=None,
        device: DeviceLike = None,
    ):
        _refuse_unported(config)
        self.config = config
        self.callbacks = list(callbacks or [])
        self.client = client if client is not None else renv.master_client()
        self.model_config = model_config
        self.device = resolve_device(device)
        # The mesh over the default process group (one process without
        # one); its shape is constant for the process's lifetime.
        self.parallel = parallel or mesh_lib.ParallelConfig(data=-1)
        self.mesh = mesh_lib.build_mesh(self.parallel,
                                        device_type=self.device.type)
        self.mesh_shape: Tuple[int, ...] = tuple(self.mesh.shape)
        self._rules = rules if rules is not None else lr.DEFAULT_RULES
        self.optimizer = optimizer or train_lib.make_optimizer(
            config.optimizer, learning_rate=config.learning_rate,
            warmup_steps=config.warmup_steps,
            decay_steps=config.decay_steps,
        )
        self.lr_schedule = train_lib.make_schedule(
            config.learning_rate, config.warmup_steps, config.decay_steps
        )
        self.numeric_monitor = None
        if config.numeric_checks:
            from dlrover_tpu_torch.trainer.numeric_health import (
                NumericHealthMonitor,
            )

            self.numeric_monitor = NumericHealthMonitor()
        self.epoch = 0
        # Once a NaN/Inf is observed in the step scalars the live state is
        # poisoned; checkpoints taken after that point would be restored by
        # the master's restart remediation and loop the failure.  The flag
        # resets on construction — the restart restores the last good
        # checkpoint into a fresh trainer.
        self._state_poisoned = False
        self._last_metrics = None
        # Deferred-metrics ring: (step, metrics in flight) pairs awaiting
        # the single wait in _flush_metrics.
        self._metrics_ring: List[Tuple[int, _InFlight]] = []
        # SDC sentry: (step, device_digest) pairs awaiting the report-
        # cadence ship — the fetch happens off the step's critical path.
        # Without a master only the newest is kept (_sdc_check).
        self._pending_digests: List[Tuple[int, Any]] = []
        # MoE router statistics: the harvest (built on first use, False
        # once it failed) and the (step, device vector) pairs awaiting the
        # report-cadence fetch.
        self._moe_stats_fn = None
        self._moe_stats_train = None
        self._pending_moe_stats: List[Tuple[int, Any]] = []
        self._on_step: Optional[Callable[[int, Dict], None]] = None
        self._fit_max_steps = 0
        # Microbatch engine: resolve the effective grad_accum for THIS
        # world from the configured reference pairing (config.grad_accum @
        # grad_accum_ref_world, default: the current world).
        self._world = max(1, config.world or mesh_lib.process_count())
        self._ref_accum = max(1, config.grad_accum)
        self._ref_world = config.grad_accum_ref_world or self._world
        # The virtual mesh: logical shape fixed at the reference world for
        # the life of the job, folded onto however many members are live.
        self.vmesh = virtual_mesh.VirtualMesh(
            self.mesh_shape, logical_world=self._ref_world,
            physical_world=self._world,
        )
        # The fit loop's prefetcher and loader handles.
        self._prefetcher = None
        self._active_loader = None
        # Sparse embedding plane (embedding/sharded.py), if the model has
        # one: its booking rides the checkpoint ``extra``.
        self._embed_plane = None
        self._embed_dir = None
        # Device-time capture: None when off, so the step path pays one
        # attribute read and nothing else.
        self._device_profiler = None
        if config.profile_every > 0:
            from dlrover_tpu_torch.utils.device_profile import DeviceProfiler

            self._device_profiler = DeviceProfiler(config.profile_every,
                                                   device=self.device)
        self.grad_accum = self._resolve_grad_accum()
        if self.grad_accum != self._ref_accum:
            logger.info(
                "elastic grad_accum: %d (reference %d @ world %d -> world "
                "%d; tokens/step unchanged at %d)",
                self.grad_accum, self._ref_accum, self._ref_world,
                self._world,
                config.global_batch_size * config.seq_len,
            )
        self.train = self._build_train()
        self._layout_of = None  # (train, layout) of the live state
        self.state = self.train.init(seed=0)
        # Classified device-memory accounting: None when off, so _report
        # pays one attribute read and nothing else.  Bound methods: the
        # registry holds them weakly, so a dropped trainer drops out.
        self._memory_registry = None
        if config.memory_report:
            from dlrover_tpu_torch.utils import memory_profile

            self._memory_registry = memory_profile.registry()
            self._memory_registry.register(
                "params", "trainer.params", self.memory_params)
            self._memory_registry.register(
                "opt_state", "trainer.opt_state", self.memory_opt_state)
        self.step = 0
        self._last_saved = 0
        self._ckpt = None
        if config.checkpoint_dir:
            from dlrover_tpu_torch.checkpoint import Checkpointer

            self._ckpt = Checkpointer(
                config.checkpoint_dir, local_saver=not renv.under_agent(),
                device=self.device,
            )
            with telemetry.span("restore"):
                restored_step, restored = self._ckpt.load_checkpoint(
                    shardings=self._layout(),
                    state_template=self.state.checkpoint_tree(),
                )
            if restored is not None:
                self.state = self.train.restore(restored_step, restored)
                del restored
                self.step = restored_step
                # A restored step is NOT a step this world has committed:
                # shm restores (and another world's uncommitted files) are
                # exactly what elastic restarts resume from.  Leaving
                # _last_saved behind the current step makes the end-of-fit
                # persistence re-commit the state under THIS world.
                self._last_saved = -1
                logger.info(
                    "resumed from checkpoint at step %d", restored_step
                )
                self._adopt_checkpoint_accum(self._ckpt.last_extra)
        if config.sdc_check_every > 0 and self.device.type == "cuda":
            # The digest's first call in a process loads its kernels (CUDA
            # loads a kernel's module at its first launch) and fills the
            # fold's caches: tens of ms of host time, more than the host's
            # lead over the device in a step, so it is paid here and not by
            # the step that first checks.
            state_digest.digest_state(self.state)

    # -- microbatch engine -----------------------------------------------------

    def _dp_shards(self) -> int:
        """How many ways the batch dim splits on this mesh + rule table."""
        return lr.batch_shard_count(self.mesh, self._rules)

    def _resolve_grad_accum(self) -> int:
        return self.vmesh.grad_accum_for(
            self._ref_accum, self.config.global_batch_size,
            self._dp_shards())

    def _layout(self):
        """Where each leaf of the live state lies on this rank (the
        checkpoint's and the digest's layout), per step program."""
        if self._layout_of is None or self._layout_of[0] is not self.train:
            self._layout_of = (self.train,
                               self.train.checkpoint_layout(self.state))
        return self._layout_of[1]

    def _build_train(self, grad_accum: Optional[int] = None
                     ) -> train_lib.Train:
        """Build the step for ``grad_accum`` microbatches (default: the
        current fold's)."""
        config = self.config
        accum = self.grad_accum if grad_accum is None else grad_accum
        return train_lib.build_train(
            self.model_config, self.optimizer,
            global_batch_size=config.global_batch_size,
            seq_len=config.seq_len,
            ce_chunks=config.ce_chunks,
            grad_accum=accum,
            accum_dtype=config.accum_dtype,
            reduce_quant=config.reduce_quant,
            zero1=config.zero1,
            overlap=config.overlap,
            overlap_bucket_mb=config.overlap_bucket_mb,
            allgather_quant=config.allgather_quant,
            mesh=self.mesh,
            rules=self._rules,
            device=self.device,
        )

    def attach_embedding_plane(self, plane, directory: str = None):
        """Bind a ``ShardedEmbeddingTable`` to the trainer's elasticity.

        From here on the plane's bucket→owner booking rides every
        checkpoint's ``extra``, and a restore adopts the booked optimizer
        clocks and folds the plane onto the live world.  With ``directory``
        set, every dense checkpoint also flushes the plane's delta export
        there (rows touched since the last export, under the integrity
        chain).

        If the trainer already restored a checkpoint before the attach
        (the normal construction order), the booking it carried is
        adopted now.
        """
        self._embed_plane = plane
        self._embed_dir = directory
        if self._ckpt is not None:
            self._adopt_embed_booking(self._ckpt.last_extra)

    def _adopt_embed_booking(self, extra):
        """Adopt a restored embed booking onto the LIVE world: clocks come
        from the booking, but the fold target is this trainer's current
        physical world."""
        plane = self._embed_plane
        if plane is None or not extra:
            return
        booking = extra.get("embed")
        if not booking:
            return
        booking = dict(booking)
        booking["world"] = self._world
        plane.adopt_booking(booking)

    def _accum_extra(self) -> Dict[str, Any]:
        """The microbatch-engine sidecar booked with every checkpoint."""
        extra = {
            "grad_accum": self.grad_accum,
            "grad_accum_ref": {
                "accum": self._ref_accum, "world": self._ref_world,
            },
            "accum_dtype": self.config.accum_dtype,
            "reduce_quant": self.config.reduce_quant,
            "zero1": self.config.zero1,
            "global_batch_size": self.config.global_batch_size,
            "world": self._world,
        }
        if self._embed_plane is not None:
            extra["embed"] = self._embed_plane.booking()
        return extra

    def _adopt_checkpoint_accum(self, extra: Dict[str, Any]):
        """Recompute grad_accum from the checkpoint's booked reference.

        The checkpoint carries the ORIGINAL (accum, world) pairing the run
        was launched with; a restore into a resized world derives N from
        that booking — not from whatever this process's config says — so
        every restart of the job lands on the same tokens/step-invariant
        schedule.  A changed N rebuilds the step (the state is
        N-independent).
        """
        # The embed booking adopts regardless of the grad-accum outcome.
        self._adopt_embed_booking(extra)
        ref = extra.get("grad_accum_ref") if extra else None
        if not ref:
            return
        booked = (int(ref.get("accum", 1)), int(ref.get("world", 0)))
        if booked[1] <= 0:
            return
        if booked == (self._ref_accum, self._ref_world):
            return
        self._ref_accum, self._ref_world = booked
        # The logical mesh is sized by the booked reference world.
        self.vmesh = virtual_mesh.VirtualMesh(
            self.mesh_shape, logical_world=self._ref_world,
            physical_world=self._world,
        )
        resolved = self._resolve_grad_accum()
        if resolved == self.grad_accum:
            return
        logger.info(
            "checkpoint booked grad_accum reference %d @ world %d -> "
            "rebuilding with grad_accum=%d for world %d",
            booked[0], booked[1], resolved, self._world,
        )
        self.grad_accum = resolved
        self.train = self._build_train()

    # -- virtual mesh: live resize ---------------------------------------------

    def prewarm_worlds(
        self, worlds: Iterable[int], aot: bool = False
    ) -> Dict[int, int]:
        """Build the step for every fold ``worlds`` implies, so a later
        ``apply_world_change`` to any of them is known to build; returns
        ``{world: grad_accum}``.  Eager PyTorch compiles nothing ahead of
        time, so a rebuild at the resize costs what this one did, and
        ``aot=True`` is refused (ROADMAP Queue 1 item 3)."""
        if aot:
            raise NotImplementedError(
                "prewarm_worlds(aot=True): eager PyTorch has nothing to "
                "compile ahead of time (ROADMAP Queue 1 item 3)")
        out: Dict[int, int] = {}
        for world in worlds:
            vm = self.vmesh.with_world(int(world))
            accum = vm.grad_accum_for(
                self._ref_accum, self.config.global_batch_size,
                self._dp_shards(),
            )
            self._build_train(grad_accum=accum)
            out[int(world)] = accum
        return out

    def apply_world_change(
        self, new_world: int, reason: str = "scale"
    ) -> Dict[str, Any]:
        """Live re-layout to a resized world: no restore.

        The graceful-resize path: the job world changed but THIS member
        survived, so its live state is authoritative — re-fold the virtual
        mesh onto the new member count in memory and keep stepping.
        ``self.step`` is never rewound: the graceful path loses zero steps
        by construction.  Every rank of the data group calls it.

        Retries ride the ``relayout.apply`` fault seam under a
        RetryPolicy; on exhaustion the path degrades to the checkpoint
        restore.  Returns the booking detail (also emitted as a
        "relayout" telemetry event): ok/fallback flags, worlds, fold,
        grad_accum, relayout seconds.
        """
        new_world = max(1, int(new_world))
        if self.train.sp > 1 or self.train.pipe is not None:
            raise NotImplementedError(
                "a live re-layout on a mesh with a seq or pipe axis: the "
                "port's virtual mesh folds the data axis only (ROADMAP "
                "Queue 1 item 9's remainder)")
        if self.train.parallel.active:
            raise NotImplementedError(
                "a live re-layout on a mesh with an fsdp, tensor or expert "
                "axis: the port's virtual mesh folds the data axis only "
                "(ROADMAP Queue 1 item 5; the expert fields, item 6's "
                "remainder)")
        if new_world == self._world:
            return {
                "ok": True, "noop": True, "fallback": False,
                "old_world": self._world, "new_world": new_world,
            }
        # Barrier: the deferred-metrics ring references the pre-resize
        # step's outputs — flush under their own step attribution.
        self._flush_metrics()
        old_world = self._world
        t0 = time.perf_counter()
        policy = RetryPolicy(
            max_attempts=3, base_delay_s=0.05, max_delay_s=0.5,
            name="relayout.apply", quiet=True,
        )
        try:
            detail = policy.call(self._relayout, new_world)
        except RetryError as e:
            return self._relayout_fallback(new_world, reason, e)
        relayout_s = time.perf_counter() - t0
        detail.update(
            ok=True, fallback=False, old_world=old_world,
            new_world=new_world, reason=reason,
            relayout_s=round(relayout_s, 6),
        )
        logger.info(
            "live relayout: world %d -> %d (fold %d, grad_accum %d) in "
            "%.1f ms", old_world, new_world, detail["fold"],
            detail["grad_accum"], relayout_s * 1e3,
        )
        self._ship_relayout(detail, relayout_s)
        return detail

    def _relayout(self, new_world: int) -> Dict[str, Any]:
        """One re-layout attempt; commits only once everything succeeded,
        so a retried attempt always starts from a consistent trainer."""
        faults.fire(
            "relayout.apply", old_world=self._world, new_world=new_world,
        )
        vmesh = self.vmesh.with_world(new_world)
        accum = vmesh.grad_accum_for(
            self._ref_accum, self.config.global_batch_size,
            self._dp_shards(),
        )
        # Drain the prefetcher: device placements of the old fold are
        # dropped, host batches retained and re-placed.
        drained = (
            self._prefetcher.drain() if self._prefetcher is not None else 0
        )
        rebuilt = accum != self.grad_accum
        train = self._build_train(grad_accum=accum) if rebuilt else self.train
        # In-memory re-layout of params and optimizer state through the
        # checkpoint's record path, the data group's wire in place of
        # storage.  Transient cost: one host copy of the state.
        old_train, live = self.train, self.state.checkpoint_tree()
        tree = virtual_mesh.relayout_state(
            live, lambda r: old_train.checkpoint_layout(self.state, r),
            train.checkpoint_layout(self.state), live, self.device,
            old_train.wire,
        )
        state = train.restore(self.step, tree)
        del tree, live
        moves = len(self.vmesh.relayout_plan(new_world))
        embed_moved = 0
        if self._embed_plane is not None:
            embed_moved = self._embed_plane.reshard(
                new_world
            )["moved_rows"]
        self.vmesh = vmesh
        self._world = new_world
        self.grad_accum = accum
        self.train = train
        self.state = state
        rebound = self._rebind_sampler(new_world)
        return {
            "fold": vmesh.fold, "grad_accum": accum,
            "drained_batches": drained, "rebuilt_program": rebuilt,
            "shard_moves": moves, "sampler_rebound": rebound,
            "embed_moved_rows": embed_moved,
        }

    def _relayout_fallback(
        self, new_world: int, reason: str, err: BaseException
    ) -> Dict[str, Any]:
        """Re-layout exhausted its retries: degrade to checkpoint restore
        (the live source state is unusable, storage is the only truth)."""
        logger.error(
            "live relayout to world %d failed after retries (%s); "
            "degrading to checkpoint restore", new_world, err,
        )
        if self._ckpt is None:
            raise err
        old_world = self._world
        t0 = time.perf_counter()
        if self._prefetcher is not None:
            self._prefetcher.drain()
        self.vmesh = self.vmesh.with_world(new_world)
        self._world = new_world
        resolved = self._resolve_grad_accum()
        if resolved != self.grad_accum:
            self.grad_accum = resolved
            self.train = self._build_train()
        with telemetry.span("restore"):
            restored_step, restored = self._ckpt.load_checkpoint(
                shardings=self._layout(),
                state_template=self.state.checkpoint_tree(),
            )
        if restored is None:
            raise err
        self.state = self.train.restore(restored_step, restored)
        self.step = restored_step
        self._last_saved = -1
        self._adopt_checkpoint_accum(self._ckpt.last_extra)
        if (self._embed_plane is not None
                and self._embed_plane.world != new_world):
            self._embed_plane.reshard(new_world)
        self._rebind_sampler(new_world)
        restore_s = time.perf_counter() - t0
        detail = {
            "ok": True, "fallback": True, "old_world": old_world,
            "new_world": new_world, "reason": reason,
            "relayout_s": round(restore_s, 6),
            "restored_step": restored_step,
            "grad_accum": self.grad_accum,
        }
        logger.warning(
            "relayout fallback: restored step %d from checkpoint in "
            "%.2f s", restored_step, restore_s,
        )
        self._ship_relayout(detail, restore_s)
        return detail

    def _rebind_sampler(self, new_world: int) -> bool:
        """Rebind the active loader's sampler onto the new physical world
        (its logical keying keeps the batch order invariant).  Lockstep
        and dynamic-sharding sources carry no rank binding — no-op."""
        loader = self._active_loader
        for candidate in (loader, getattr(loader, "source", None)):
            if candidate is not None and hasattr(candidate, "rebind_world"):
                candidate.rebind_world(num_replicas=new_world)
                return True
        return False

    def _ship_relayout(self, detail: Dict[str, Any], seconds: float):
        attrs = {k: v for k, v in detail.items() if k != "relayout_s"}
        telemetry.event("relayout", duration_s=seconds, **attrs)
        if self.client is not None:
            import json

            try:
                self.client.report_event("relayout", json.dumps(detail))
                telemetry.recorder().ship(self.client)
            except Exception as e:  # noqa: BLE001 — booking is best-effort
                logger.warning("relayout report failed: %s", e)

    # -- loop -----------------------------------------------------------------

    def train_step(self, batch: Dict[str, Any]):
        # The span times what the host observes of this step: H2D place +
        # dispatch, plus any backpressure when the device falls behind.
        prof = self._device_profiler
        capturing = prof is not None and prof.arm(self.step + 1)
        t_span = time.monotonic()
        with telemetry.span("step", step=self.step + 1):
            if capturing:
                # A host-side marker row around the step in the trace.
                # A step that raises closes the window: no profiler may
                # keep recording (or hold the wire's ranges open) after.
                try:
                    with prof.annotation("step"):
                        metrics = self._dispatch_step(batch)
                except BaseException:
                    prof.abort()
                    raise
            else:
                metrics = self._dispatch_step(batch)
        if capturing:
            self._finish_capture(t_span)
        if (
            self.train.grad_accum > 1 or self.train.zero1
        ) and telemetry.recorder().enabled:
            # The accumulate/reduce/update phases are not timed one by
            # one: emit the reference's cost-model breakdown as sub-spans
            # backdated into the measured step span (source="modeled").
            wall = time.monotonic() - t_span
            for row in train_lib.microbatch_phase_plan(
                self.train.grad_accum, self.train.reduce_quant, wall,
                zero1=self.train.zero1, overlap=self.train.overlap,
            ):
                telemetry.event(
                    row["phase"], duration_s=row["dur"],
                    t_mono=t_span + row["t0"], step=self.step,
                    micro=row["micro"], source="modeled",
                )
        self._last_metrics = metrics
        return metrics

    def _dispatch_step(self, batch: Dict[str, Any]):
        placed = train_lib.shard_batch(batch, self.train)
        t0 = time.perf_counter()
        try:
            self.state, metrics = self.train.step(self.state, placed)
        except Exception as e:
            # OOM forensics: before the process dies, write the classified
            # buffer table (who held the device memory) next to the
            # checkpoint dir.  Best-effort, then re-raise — the postmortem
            # must never mask the original error.
            from dlrover_tpu_torch.utils import memory_profile

            if memory_profile.is_oom_error(e) and self.config.checkpoint_dir:
                memory_profile.dump_oom_postmortem(
                    self.config.checkpoint_dir, error=e)
            raise
        self.step += 1
        pipeline_counters().record_dispatch(
            self.step, time.perf_counter() - t0
        )
        every = self.config.sdc_check_every
        if every > 0 and self.step % every == 0:
            # Booked inside the step span: the digest dispatch is part
            # of the step's host-observed cost at its check cadence.
            self._sdc_check()
        if (
            getattr(self.model_config, "num_experts", 0)
            and self.step % self.config.report_every == 0
        ):
            self._moe_stats_check(placed)
        return metrics

    def _moe_stats_check(self, placed):
        """Dispatch the router-statistics harvest (entropy, load, drop
        fraction) on the report cadence; the fetch and the telemetry ride
        ``_report``, off the step's critical path.  Best effort, as in the
        reference: a harvest that fails logs once and turns itself off."""
        if self._moe_stats_fn is False:
            return
        try:
            if self._moe_stats_fn is None or \
                    self._moe_stats_train is not self.train:
                self._moe_stats_fn = train_lib.build_moe_stats_fn(self.train)
                self._moe_stats_train = self.train
            self._pending_moe_stats.append(
                (self.step, self._moe_stats_fn(self.state, placed)))
        except Exception as e:  # noqa: BLE001 - observability must not kill
            logger.warning("moe stats harvest failed (disabled): %s", e)
            self._moe_stats_fn = False

    # -- device-time capture ---------------------------------------------------

    def _finish_capture(self, t_span: float):
        """Close the armed profiler window: wait for the step's device
        work so it lands inside the trace, then parse it and book the
        measured rows + calibration event.  A window that fails to stop
        or parse books nothing and never takes the step down with it.
        The port has no compile cache (ROADMAP Queue 1 item 3), so every
        window is booked under the ledger's ``uncacheable`` key."""
        from dlrover_tpu_torch.utils import device_profile

        # The capture sync is a deliberate host stall (the window must
        # close after the device finished) — book it as a host block so
        # the pipeline counters price what profiling costs the step loop.
        with pipeline_counters().host_block("profile-sync",
                                            steps=(self.step,)):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        wall = time.monotonic() - t_span
        window = self._device_profiler.finish()
        if window is None:
            return
        # The modeled baseline for the SAME wall the window measured —
        # the calibration ratio compares like with like.
        rows = train_lib.microbatch_phase_plan(
            self.train.grad_accum, self.train.reduce_quant, wall,
            zero1=self.train.zero1, overlap=self.train.overlap,
        )
        device_profile.emit_measured_phases(
            window, step=self.step, t_span=t_span, wall_s=wall,
            modeled_rows=rows,
        )

    # -- classified device memory ----------------------------------------------

    def memory_params(self):
        """Registry provider: this rank's parameters."""
        return self.state.params()

    def memory_opt_state(self):
        """Registry provider: this rank's optimizer state."""
        return self.state.opt_state

    def _emit_memory_event(self, step: int):
        """One flat-attr ``memory`` event: allocator truth + classified
        pool bytes.  ``modeled_b`` is the params + optimizer-state bytes,
        so the master's ratio measures what the state model misses
        (activations, temporaries, allocator slack)."""
        from dlrover_tpu_torch.utils import memory_profile

        pools = self._memory_registry.pool_bytes()
        memory_profile.emit_memory_event(
            step=step, modeled_b=pools["params"] + pools["opt_state"])

    # -- silent data corruption ------------------------------------------------

    def _sdc_check(self):
        """Digest the post-update state on device and queue it for the
        master's cross-replica vote (shipped on the report cadence).

        The ``sdc.flip`` chaos seam fires HOST-side here, so the drill
        corrupts the live state without touching the step, and the
        corruption persists into every later step as a real SDC would.
        """
        try:
            faults.fire("sdc.flip", step=self.step)
        except faults.FaultInjected as e:
            logger.warning(
                "sdc.flip: flipping one mantissa bit in the live state (%s)",
                e,
            )
            self.state = state_digest.flip_mantissa_bit(self.state)
        wire = self.train.state_wire
        entry = (self.step, state_digest.digest_state(
            self.state, self._layout() if wire is not None else None, wire))
        if self.client is None:
            # No master to vote: keep the newest digest for a caller to
            # read, not one device scalar per check for the whole run.
            self._pending_digests = [entry]
        else:
            self._pending_digests.append(entry)

    def _batch_stream(self, loader: Iterable) -> Iterable:
        """Wrap ``loader`` in a DevicePrefetcher when configured, so batch
        N+1's H2D copy is issued before batch N is even handed to
        ``train_step`` (whose ``shard_batch`` then passes it through)."""
        if self.config.prefetch_to_device <= 0:
            self._prefetcher = None
            return loader
        from dlrover_tpu_torch.data.loader import DevicePrefetcher

        # place_fn reads ``self.train`` at call time, so a rebuilt step
        # (a restored booking) places under the new one.
        self._prefetcher = DevicePrefetcher(
            loader,
            lambda batch: train_lib.shard_batch(batch, self.train),
            depth=self.config.prefetch_to_device,
            device=self.train.device,
        )
        return self._prefetcher

    # -- deferred metrics ------------------------------------------------------

    def _flush_metrics(self, keep: int = 0):
        """Materialize the deferred-metrics ring, all but its newest
        ``keep`` entries, with ONE blocking wait.

        Called every ``metrics_lag`` steps by the fit loop with ``keep=1``
        (the newest step still runs on the device, so only the older
        entries' copies are waited for, and the device's queue stays
        full), and forced whole at the pipeline barriers — evaluate,
        checkpoint, end-of-fit — so no step's metrics outlive the state
        that produced them.  Each entry then flows through callbacks /
        reporting / numeric checks with its own step attribution, exactly
        as the synchronous loop would have.
        """
        cut = len(self._metrics_ring) - keep
        if cut <= 0:
            return
        ring = self._metrics_ring[:cut]
        self._metrics_ring = self._metrics_ring[cut:]
        steps = tuple(step for step, _ in ring)
        with pipeline_counters().host_block("metrics-flush", steps=steps):
            fetched = [entry.read() for _, entry in ring]
        for (step, _), host in zip(ring, fetched):
            self._last_metrics = host
            if self._on_step is not None:
                self._on_step(step, host)
            self._dispatch("on_step_end", step, host)
            cfg = self.config
            if step % cfg.report_every == 0 or step == self._fit_max_steps:
                self._report(host, step=step)

    def _dispatch(self, hook: str, *args):
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(self, *args)
            except Exception as e:  # noqa: BLE001 - one callback must not
                logger.warning("callback %s.%s failed: %s",
                               type(cb).__name__, hook, e)

    def current_lr(self, step: Optional[int] = None) -> float:
        """The LR the schedule prescribes at ``step`` (default: current)."""
        step = self.step if step is None else step
        if callable(self.lr_schedule):
            return float(self.lr_schedule(step))
        return float(self.lr_schedule)

    def evaluate(
        self,
        eval_loader: Iterable[Dict[str, Any]],
        max_batches: int = 0,
    ) -> Dict[str, float]:
        """Forward-only evaluation: mean loss + perplexity over the loader.

        Loss·tokens accumulate ON DEVICE across the loop; one blocking
        fetch at the end materializes both sums.
        """
        self._flush_metrics()
        t_eval = time.monotonic()
        weighted_loss = total_tokens = None  # device-resident accumulators
        batches = 0
        for batch in eval_loader:
            if max_batches and batches >= max_batches:
                break
            placed = train_lib.shard_batch(batch, self.train)
            metrics = self.train.eval_step(self.state, placed)
            weighted = metrics["loss"] * metrics["tokens"]
            if batches == 0:
                weighted_loss, total_tokens = weighted, metrics["tokens"]
            else:
                weighted_loss = weighted_loss + weighted
                total_tokens = total_tokens + metrics["tokens"]
            batches += 1
        if batches:
            with pipeline_counters().host_block(
                "eval-fetch", steps=(self.step,)
            ):
                (fetched,) = _fetch(
                    [{"loss": weighted_loss, "tokens": total_tokens}])
            total_tokens = fetched["tokens"]
            mean_loss = (
                fetched["loss"] / total_tokens
                if total_tokens else float("nan")
            )
        else:
            total_tokens, mean_loss = 0.0, float("nan")
        out = {
            "eval_loss": mean_loss,
            "eval_ppl": float(np.exp(min(mean_loss, 30.0))),
            "eval_tokens": total_tokens,
            "eval_batches": batches,
        }
        logger.info(
            "eval @ step %d: loss %.4f ppl %.2f (%d batches)",
            self.step, mean_loss, out["eval_ppl"], batches,
        )
        telemetry.event(
            "eval", duration_s=time.monotonic() - t_eval,
            step=self.step, batches=batches,
        )
        self._dispatch("on_evaluate", self.step, out)
        return out

    def fit(
        self,
        loader: Iterable[Dict[str, Any]],
        max_steps: int,
        on_step: Optional[Callable[[int, Dict], None]] = None,
        eval_loader: Optional[Iterable[Dict[str, Any]]] = None,
        epochs: int = 0,
    ) -> int:
        """Run until ``max_steps``; returns the final step.

        ``on_step(step, metrics)`` runs after every step (test hooks,
        custom logging); metrics values are still on device unless read.
        ``eval_loader`` + ``config.eval_every`` turn on periodic
        evaluation.  ``epochs > 0`` re-iterates ``loader`` that many times
        (resume-aware: a restored trainer continues counting from its
        restored step, and for a SIZED loader the epoch counter resumes at
        ``step // len(loader)``; an unsized generator cannot imply an
        epoch, so its counter restarts at 0).  What is alive when it
        starts is frozen out of the garbage collector until it returns
        (the module docstring).
        """
        gc.collect()
        gc.freeze()
        try:
            return self._fit(loader, max_steps, on_step, eval_loader, epochs)
        finally:
            gc.unfreeze()

    def _fit(self, loader, max_steps, on_step, eval_loader, epochs) -> int:
        cfg = self.config
        if epochs:
            # Single-use iterators (generators, list_iterator,
            # map/zip/filter, ...) expose __next__; containers don't.
            # Each is exhausted after one pass, so the epoch counter would
            # spin to N while training a single epoch's worth of data.
            if hasattr(loader, "__next__"):
                raise ValueError(
                    f"fit(epochs={epochs}) needs a re-iterable loader, "
                    "got a one-shot iterator (pass a list, Dataset, or "
                    "ElasticDataLoader)"
                )
        t_start = time.monotonic()
        start_step = self.step
        steps_per_epoch = None
        if epochs and hasattr(loader, "__len__"):
            steps_per_epoch = max(1, len(loader))
            # Resume accounting: a restored step implies the epoch.
            self.epoch = self.step // steps_per_epoch
        self._on_step = on_step
        self._fit_max_steps = max_steps
        self._active_loader = loader
        lag = max(0, cfg.metrics_lag)
        self._dispatch("on_train_begin")
        done = False
        epoch_iterations = max(1, epochs) if epochs else 1
        passes = 0
        while not done:
            # A resumed trainer can start at/past the epoch budget — check
            # BEFORE running a pass, not only after one completes.
            if epochs and self.epoch >= epoch_iterations:
                break
            batches_this_pass = 0
            for batch in self._batch_stream(loader):
                batches_this_pass += 1
                if self.step >= max_steps:
                    done = True
                    break
                metrics = self.train_step(batch)
                if lag:
                    # Pipelined: park the metrics in the ring, their copy
                    # queued behind the step; every ``lag`` steps the older
                    # entries materialize (and drive callbacks/reporting
                    # with their own step attribution) in one wait, which
                    # leaves the newest step running.
                    self._metrics_ring.append((self.step, _InFlight(metrics)))
                    if len(self._metrics_ring) > lag:
                        self._flush_metrics(keep=1)
                else:
                    if on_step is not None:
                        on_step(self.step, metrics)
                    self._dispatch("on_step_end", self.step, metrics)
                    if self.step % cfg.report_every == 0 or (
                        self.step == max_steps
                    ):
                        self._report(metrics)
                if cfg.eval_every and eval_loader is not None and (
                    self.step % cfg.eval_every == 0
                ):
                    self.evaluate(eval_loader, cfg.eval_batches)
                if self.step % cfg.ckpt_every == 0 or self.step == max_steps:
                    self.save_checkpoint()
            else:
                # Loader exhausted: an epoch boundary.
                passes += 1
                if epochs and passes > 1 and batches_this_pass == 0:
                    logger.warning(
                        "fit epoch pass %d yielded no batches (drained "
                        "dataset, empty shard, or a non-re-iterable "
                        "loader)", passes,
                    )
                self.epoch += 1
                self._dispatch("on_epoch_end", self.epoch)
                if epochs and self.epoch >= epoch_iterations:
                    done = True
                if not epochs:
                    done = True
        # End-of-fit barrier: drain whatever the ring still holds so the
        # final steps' metrics reach callbacks/reports before on_train_end.
        self._flush_metrics()
        if self._last_saved < self.step:
            # A restart can resume at (or past) max_steps with the newest
            # state only in a previous world's uncommitted files, and a
            # cadence save is skipped while the saver persists the one
            # before — persist under THIS world before declaring done,
            # waiting for the saver if it is busy.
            self.save_checkpoint(wait_for_saver=True)
        elapsed = time.monotonic() - t_start
        tokens = (self.step - start_step) * cfg.global_batch_size * cfg.seq_len
        logger.info(
            "done: %d steps (%.1f tokens/s)", self.step,
            tokens / elapsed if elapsed > 0 else 0.0,
        )
        self._dispatch("on_train_end", self.step)
        if self.client is not None:
            try:
                telemetry.recorder().ship(self.client)
            except Exception as e:  # noqa: BLE001 - telemetry is best-effort
                logger.warning("final telemetry ship failed: %s", e)
        return self.step

    def _report(self, metrics: Dict[str, Any], step: Optional[int] = None):
        """Report ``metrics`` under ``step`` (default: the current step —
        the synchronous path; the deferred-metrics flush passes the ring
        entry's own step so lagged values keep correct attribution), and
        write the agent's device-metrics file."""
        cfg = self.config
        step = self.step if step is None else step
        loss = metrics["loss"]
        grad_norm = metrics.get("grad_norm")
        if isinstance(loss, torch.Tensor):
            # Synchronous mode's per-step blocking fetch — the "metrics"
            # block the pipeline counters tally as sync_block_count (and
            # the pipelined path never reaches: its flush hands host
            # floats in).  One read for both scalars.
            fetch = {"loss": loss}
            if grad_norm is not None:
                fetch["grad_norm"] = grad_norm
            with pipeline_counters().host_block("metrics", steps=(step,)):
                (fetch,) = _fetch([fetch])
            loss = fetch["loss"]
            grad_norm = fetch.get("grad_norm")
        loss = float(loss)
        grad_norm = float(grad_norm) if grad_norm is not None else None
        logger.info(
            "step %d loss %.4f lr %.3g", step, loss, self.current_lr(step)
        )
        anomalies = ()
        if self.numeric_monitor is not None:
            found = self.numeric_monitor.check(step, loss, grad_norm)
            if found:
                for a in found:
                    logger.error("numeric anomaly: %s", a.encode())
                anomalies = tuple(a.encode() for a in found)
                if any(a.kind == "nan" for a in found):
                    self._state_poisoned = True
        if self._memory_registry is not None:
            # Classified memory snapshot on the report cadence, queued
            # BEFORE the ring ships below so it rides this report's drain.
            self._emit_memory_event(step)
        if self._pending_moe_stats:
            # The router statistics' fetch rides the report cadence,
            # queued before the ring ships below: [entropy, drop_fraction,
            # load_0..load_{E-1}] (models/moe.py).
            pending, self._pending_moe_stats = self._pending_moe_stats, []
            with pipeline_counters().host_block(
                    "moe_stats", steps=tuple(s for s, _ in pending)):
                pending = [(s, v.detach().double().cpu().numpy())
                           for s, v in pending]
            for mstep, vec in pending:
                telemetry.event(
                    "moe", step=mstep, entropy=float(vec[0]),
                    drop_fraction=float(vec[1]), experts=int(vec.size - 2),
                    top_k=int(getattr(self.model_config, "top_k", 0)),
                    load=json.dumps([round(float(v), 6) for v in vec[2:]]))
        if self.client is not None:
            self.client.report_step(
                step,
                tokens=cfg.global_batch_size * cfg.seq_len
                * cfg.report_every,
                loss=loss,
                anomalies=anomalies,
            )
            # Piggyback the telemetry drain on the report cadence.
            dropped = telemetry.recorder().dropped
            if dropped:
                pipeline_counters().record_dropped(dropped)
            telemetry.recorder().ship(self.client)
            if self._pending_digests:
                # Digest fetch + ship rides the same cadence: the uint32
                # scalars materialize here, off the step critical path.
                pending, self._pending_digests = self._pending_digests, []
                for dstep, value in pending:
                    self.client.report_digest(
                        dstep,
                        state_digest.format_digest(value),
                        check_every=cfg.sdc_check_every,
                    )
        from dlrover_tpu_torch.agent.monitor import write_device_metrics

        write_device_metrics()

    # -- checkpoint -----------------------------------------------------------

    def save_checkpoint(self, wait_for_saver: bool = False) -> bool:
        """Save the live state at the current step; True when it was saved.

        A save while the saver still persists the previous one is skipped
        (training never blocks on storage I/O): the step stays unsaved and
        ``on_checkpoint`` does not fire.  ``wait_for_saver`` waits for that
        persist instead and then saves (the end-of-fit barrier)."""
        # Checkpoint barrier: drain deferred metrics first, so (a) every
        # step committed by this save has already been reported/attributed
        # and (b) _healthy_to_save reads host floats, not device tensors.
        self._flush_metrics()
        if self._ckpt is None:
            return False
        if self._healthy_to_save() is False:
            logger.error(
                "skipping checkpoint at step %d: state holds non-finite "
                "values; waiting for the master's restart remediation",
                self.step,
            )
            return False
        from dlrover_tpu_torch.checkpoint import StorageType

        def save() -> bool:
            return self._ckpt.save_checkpoint(
                self.step, self.state.checkpoint_tree(), StorageType.DISK,
                extra=self._accum_extra(), layout=self._layout(),
            )

        with telemetry.span("checkpoint", step=self.step):
            saved = save()
            if not saved and wait_for_saver:
                with pipeline_counters().host_block(
                    "checkpoint-wait", steps=(self.step,)
                ):
                    self._ckpt.wait()
                saved = save()
        if not saved:
            logger.warning(
                "step %d: checkpoint skipped, the saver is still "
                "persisting the previous one", self.step,
            )
            return False
        if self._embed_plane is not None and self._embed_dir is not None:
            # The plane's delta leg rides every dense checkpoint.
            self._embed_plane.drain(self._embed_dir, self.step)
            self._embed_plane.emit_telemetry()
        self._last_saved = self.step
        self._dispatch("on_checkpoint", self.step)
        return True

    def _healthy_to_save(self) -> bool:
        """False when the live state is known (or found) non-finite on any
        rank of the data group (one MIN vote).

        The monitor only samples on report cadence, so a NaN can land
        between reports; re-check the newest step's loss at save time —
        one scalar read per checkpoint — so a poisoned state is never
        committed.
        """
        healthy = self._healthy_here()
        wire = self.train.state_wire
        if wire is None:
            return healthy
        vote = torch.tensor([int(healthy)], dtype=torch.int64,
                            device=self.device)
        wire.all_reduce(vote, op=torch.distributed.ReduceOp.MIN)
        return bool(vote.item())

    def _healthy_here(self) -> bool:
        if self._state_poisoned:
            return False
        if self.numeric_monitor is not None and (
            self._last_metrics is not None
        ):
            # grad_norm too: the loss is computed on the PRE-update params,
            # so NaN gradients at the newest step poison the state while
            # its loss still reads finite.
            (host,) = _fetch([{
                k: v for k, v in self._last_metrics.items()
                if k in ("loss", "grad_norm")}])
            loss = host["loss"]
            grad_norm = host.get("grad_norm")
            if not np.isfinite(loss) or (
                grad_norm is not None and not np.isfinite(grad_norm)
            ):
                self._state_poisoned = True
                # Ship the anomaly NOW: the skip path waits for the
                # master's restart remediation, which only fires on a
                # reported anomaly.
                found = self.numeric_monitor.check(
                    self.step, loss, grad_norm
                )
                if self.client is not None:
                    self.client.report_step(
                        self.step, tokens=0, loss=loss,
                        anomalies=tuple(a.encode() for a in found),
                    )
                return False
        return True

    def close(self, wait: float = 120.0):
        if self._ckpt is not None:
            self._ckpt.wait(timeout=wait)
            self._ckpt.close()

"""The train step (port of ``dlrover_tpu/trainer/train_lib.py``).

``build_train`` is the counterpart of the JAX ``build_sharded_train``: the
same arguments and the same step.  The loss is the token-weighted cross
entropy normalised by the *global* token count (with ``grad_accum``
microbatches each microbatch's CE sum is divided by the whole batch's
weight, so the accumulated gradient equals the full-batch gradient),
plus the model's aux loss; the gradient's global norm is reported
before clipping; the optimizer is a hand port of the optax chain
``make_optimizer`` builds (``optimizers/optax_ports.py``) applied to the
JAX-shaped, layer-stacked parameter tree.  Metrics carry the JAX names:
``loss``, ``aux_loss``, ``tokens``, ``grad_norm``, ``step``.  MoE configs
(``num_experts > 0``) train through the same step: ``aux_loss`` is the
blocks' load-balancing loss times ``moe_aux_weight``, and the expert
kernels ``[E, ., .]`` stack to ``[layers, E, ., .]`` leaves.

``make_optimizer`` builds ``adamw``, ``adafactor``, ``sgd``, ``lion``,
``agd`` (``optimizers/agd.py``) and the low-bit ``q8_adam``/``q4_adam``
(``ops/quantization.py``, whose per-leaf update is one CUDA kernel on the
card).  Lion and AGD are elementwise: under ZeRO-1 and on fsdp boxes
each shard updates on its own, and their states (``{"count", "mu"}``,
``AGDState``) go into Flash Checkpoint records as the others do.
``optimizers/mup.mup_scale`` chains after any of them and
``optimizers/wsam.make_wsam_step`` wraps one.

The data-parallel world.  ``mesh`` (``runtime/mesh.build_mesh``) with a
``data`` axis of ``dp`` > 1 makes each process one data rank: it holds a
replica of the parameters and takes its own rows of the global batch,
the contiguous block ``[r * B / dp, (r + 1) * B / dp)`` that the JAX
batch sharding gives data index ``r`` (``shard_batch``).  The loss is
normalised by the global token count (one all-reduce of the rows'
weights), so each rank's gradient is its share of the global gradient,
and the shares are summed across ranks:

* replicated (the default): one all-reduce per leaf, fp, or int8
  (``parallel/quantized_collectives.quantized_all_reduce``) with
  ``reduce_quant="int8"`` and ``grad_accum`` > 1, as the reference
  reduces on the int8 wire only in its microbatched step;
* ``zero1=True``: each leaf is reduce-scattered to its ZeRO-1 shard
  (``optimizers/zero1.ShardPlan``; fp, or int8 with ``reduce_quant``),
  the optimizer updates the shard (its state lives as shards, and its
  reductions over a leaf stay global, ``optax_ports.sharded_update``),
  and the updated shards are all-gathered back into every replica;
* ``overlap=True`` (with ``zero1``): the reduce-scatters are issued per
  bucket (``parallel/overlap.py``) from the backward's gradient hooks,
  per microbatch, into a 1/dp shard accumulator, and the all-gathers per
  bucket after the update (int8 with ``allgather_quant="int8"``).

As in the reference, ``zero1`` and ``overlap`` deactivate silently
without a data axis above 1 (``Train.zero1``/``Train.overlap`` say what
is active), and ``overlap`` without ``zero1``.  The int8 step quantizes
each rank's partial gradient, where the reference, under GSPMD,
quantizes the gradient already summed: the two steps agree within a
block-quantization bound, not bit for bit (ROADMAP Queue 3, "by
design").

The fsdp and tensor axes.  On a mesh with ``fsdp`` or ``tensor`` above
1 the model is this rank's part of it (``models/transformer.py``,
``parallel/sharding.py``): the parameters are this rank's boxes of the
whole leaves under the rules, the blocks gather their fsdp slices for
their forward and reduce-scatter their gradients in the backward, and
the tensor axis sums the row-parallel products.  The batch group is
``data x fsdp`` (and the expert axis, below): each of its ranks takes
its rows of the global batch, and the ranks of a tensor group take the
same rows.  With the tensor
axis the cross entropy is vocab-parallel (:func:`cross_entropy_loss` and
:func:`chunked_cross_entropy_loss` take the group: the max and the
log-sum-exp are completed over it).  A leaf's gradient is completed
over the fsdp axis where the leaf is not split over it (one all-reduce
for all of them), then over the data axis as above; the optimizer runs
on the rank's boxes under ``optax_ports.sharded_update``, its reductions
over a leaf completed over the axes that split it; ZeRO-1 splits a box
further over ``data`` on the dimension ``zero1_partition_spec`` picks.
A block-quantized optimizer (``q8_adam``/``q4_adam``) on a leaf the
fsdp or tensor axis splits needs each box to be whole blocks of the
whole leaf (``parallel/sharding.runs_are_whole_blocks``), else
``build_train`` refuses it.

``shard_batch`` places a host batch on the train's device in the dtypes
``Train._batch`` takes (pinned, ``non_blocking`` on the card), so the
step passes it through with no copy; ``elastic_grad_accum`` is the
elastic trainer's microbatch accounting and ``microbatch_phase_plan`` its
modeled phase breakdown.

The expert axis.  On a mesh with ``expert`` above 1 the batch group is
``data x expert`` (``parallel/rules.batch_group_axes``): the trunk's
batch is split over the expert axis too, and each MoE layer exchanges
its experts' rows over it (``models/moe.py``), so a rank holds its
``E / ep`` experts of every layer.  A dense leaf's gradient (the trunk,
the router) is its rank's share from its rows, summed over ``data x
expert``; an expert leaf's gradient already holds every chunk routed to
the rank's experts, so it is summed over ``data`` alone; both are divided
by the same global token count.  The MoE layers' aux loss is computed
from router means taken over the batch group, so it is the same on every
rank, and each rank's gradient keeps its own share of it.  ZeRO-1 and
``grad_accum`` compose with it; the global-norm clip and the optimizer's
reductions over an expert leaf are completed over the expert axis.
:func:`build_moe_stats_fn` is the router statistics' harvest, a forward
of its own.

The seq axis.  On a mesh with ``seq`` above 1 each rank of a seq group
takes the same rows as the others and its ``S / sp`` slice of their
columns (``inputs``, ``targets`` and ``weights`` alike: the batch carries
its shifted targets, so no token crosses a slice's edge).  The model runs
each block's attention on the whole sequence over its rank's heads
(Ulysses, ``models/attention.ulysses_attention``) or, under
``attention_impl="ring"`` (with ``RING_RULES``), on its slice with K and
V hopping around the seq ring (``parallel/ring_attention.py``); the loss
is normalised by the token weight summed over the batch group and the
seq group, and every gradient is summed over ``seq`` (one all-reduce for
all of them) before the data axis's reduction, ZeRO-1's included.

The pipe axis.  A config with ``pipeline_stages`` S on a mesh with a
``pipe`` axis of S runs one stage a pipe rank (``parallel/pipeline.py``):
the layer-stacked leaves are split over ``pipe`` on their layers
dimension (a rank holds its stage's layers), and every pipe rank holds
the leaves outside the blocks (the embedding, the positions, the final
norm and the head) and takes the same rows.  The first stage embeds, the
last computes the head and the loss; the loss and the token count reach
every rank (the metrics' sums run over ``pipe`` too).  A leaf outside the
blocks gets its gradient from the stages that use it (the embedding from
the first stage's lookup and, tied, from the last stage's head) and is
summed over ``pipe``, so every pipe rank updates it alike; the global
norm counts it once and completes the stages' sums over ``pipe``.
``pipe`` composes with ``data`` (ZeRO-1 included) and ``tensor``.

Not ported yet, and refused when asked for: MoE on an fsdp, tensor or
seq axis (item 6's remainder), a pipe axis beside fsdp, seq or expert
(item 9's remainder), and the overlap engine and the int8 wires beside
an fsdp, tensor, expert, seq or pipe axis (they stay the data axis's).
MoE under pipelining is refused as the reference refuses it.

PyTorch updates in place: ``step`` mutates the state it is given (the
JAX step donated it) and returns it.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.checkpoint import shm_handler
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    check_parallel,
    init_params,
    param_logical_axes,
    param_shapes,
    stacked_logical_axes,
)
from dlrover_tpu_torch.ops import quantization
from dlrover_tpu_torch.optimizers import optax_ports as ox
from dlrover_tpu_torch.optimizers import zero1 as zero1_lib
from dlrover_tpu_torch.parallel import overlap as overlap_lib
from dlrover_tpu_torch.parallel import quantized_collectives as qc
from dlrover_tpu_torch.parallel import rules as lr
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.wire import Pending, Wire
from dlrover_tpu_torch.runtime import mesh as mesh_lib
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device

_ACCUM_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def make_schedule(learning_rate: float, warmup_steps: int = 0,
                  decay_steps: int = 0) -> ox.ScalarOrSchedule:
    """The LR schedule ``make_optimizer`` installs (a float when
    constant)."""
    if warmup_steps and not decay_steps:
        # Warmup-only: ramp to peak then hold.
        return ox.linear_schedule(0.0, learning_rate, max(1, warmup_steps))
    if warmup_steps or decay_steps:
        return ox.warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=learning_rate,
            warmup_steps=max(1, warmup_steps),
            decay_steps=max(decay_steps, warmup_steps + 1),
            end_value=learning_rate * 0.1,
        )
    return learning_rate


def make_optimizer(
    name: str = "adamw",
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    **kwargs,
) -> ox.GradientTransformation:
    """``adamw``, ``adafactor``, ``sgd`` (momentum 0.9), ``lion``,
    ``agd``, ``q8_adam`` or ``q4_adam`` behind an optional global-norm
    clip, as the JAX ``make_optimizer`` composes them."""
    schedule = make_schedule(learning_rate, warmup_steps, decay_steps)
    if name == "adamw":
        opt = ox.adamw(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                       **kwargs)
    elif name == "adafactor":
        opt = ox.adafactor(schedule)
    elif name == "sgd":
        opt = ox.sgd(schedule, momentum=0.9)
    elif name in ("q8_adam", "q4_adam"):
        low_bit = (quantization.q8_adam if name == "q8_adam"
                   else quantization.q4_adam)
        opt = low_bit(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                      **kwargs)
    elif name == "lion":
        # optax.lion gets the schedule and the decay alone: it keeps its
        # own b1=0.9, b2=0.99, as the reference's call does.
        opt = ox.lion(schedule, weight_decay=weight_decay)
    elif name == "agd":
        from dlrover_tpu_torch.optimizers.agd import agd

        opt = agd(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                  **kwargs)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if grad_clip:
        opt = ox.chain(ox.clip_by_global_norm(grad_clip), opt)
    return opt


def _token_loss(logits32: torch.Tensor, targets: torch.Tensor,
                z_loss: float) -> torch.Tensor:
    log_z = torch.logsumexp(logits32, dim=-1)
    label = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
    loss = log_z - label
    if z_loss:
        loss = loss + z_loss * log_z.square()
    return loss


def _tokens(logits32, targets, z_loss, tp):
    if tp is None:
        return _token_loss(logits32, targets, z_loss)
    return sharding.vocab_parallel_token_loss(logits32, targets, z_loss, tp)


def cross_entropy_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    z_loss: float = 0.0,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level softmax CE in fp32; returns ``(mean_loss,
    num_tokens)``.  With a tensor group (``tp``) ``logits`` are this
    rank's vocabulary columns (vocab-parallel)."""
    loss = _tokens(logits.float(), targets, z_loss, tp)
    if weights is None:
        weights = torch.ones_like(loss)
    weights = weights.float()
    total_weight = torch.clamp(weights.sum(), min=1.0)
    return (loss * weights).sum() / total_weight, total_weight


def chunked_cross_entropy_loss(
    hidden: torch.Tensor,
    head: torch.Tensor,
    targets: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    num_chunks: int = 8,
    z_loss: float = 0.0,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax CE from final hidden states ``[B, S, D]`` and the output
    head ``[V, D]`` without holding the ``[B, S, V]`` fp32 logits: each
    sequence chunk's logits are computed inside a checkpoint, so the
    backward recomputes them.  With a tensor group (``tp``) the head is
    this rank's ``[V / size, D]`` rows (vocab-parallel)."""
    b, s, _ = hidden.shape
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32,
                             device=hidden.device)
    num_chunks = max(1, min(num_chunks, s))
    while s % num_chunks:
        num_chunks -= 1
    c = s // num_chunks

    def chunk_sum(x_c, t_c, w_c):
        # bf16 products accumulated and returned in fp32, as the JAX
        # einsum's preferred_element_type=float32: both operands upcast
        # (a bf16 product is exact in fp32), on every device.
        logits = x_c.to(head.dtype).float() @ head.float().t()
        return (_tokens(logits, t_c, z_loss, tp) * w_c.float()).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(num_chunks):
        sl = slice(i * c, (i + 1) * c)
        args = (hidden[:, sl], targets[:, sl], weights[:, sl])
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_sum, *args, use_reentrant=False)
        else:
            total = total + chunk_sum(*args)
    total_weight = torch.clamp(weights.float().sum(), min=1.0)
    return total / total_weight, total_weight


def output_head(model: TransformerLM) -> torch.Tensor:
    """``[V, D]`` output projection: the tied embedding table, or the
    ``lm_head`` kernel transposed."""
    if hasattr(model, "lm_head"):
        kernel = model.lm_head.kernel  # [D, V]
        return kernel.reshape(kernel.shape[0], -1).t()
    return model.embed.embedding


@dataclasses.dataclass
class TrainState:
    """``step`` / the model (holding the params) / ``opt_state`` (under
    ZeRO-1, this rank's shards of it)."""

    step: int
    model: TransformerLM
    opt_state: Any

    def params(self) -> Dict[str, torch.Tensor]:
        # ``state_dict`` detaches each tensor already.
        return dict(self.model.state_dict())

    def checkpoint_tree(self) -> Dict[str, Any]:
        """What Flash Checkpoint saves of the state (``checkpoint/``; the
        step rides in the checkpoint's meta): ``{"params": the state dict,
        "opt_state": the optimizer state}``, views of the live tensors."""
        return {"params": self.params(), "opt_state": self.opt_state}


class _Accum:
    """What the microbatches of one step accumulate: each leaf's gradient
    (the whole leaf, or under the overlap engine its shard), in the
    accumulator's dtype (None: as it comes, one microbatch)."""

    def __init__(self, dtype: Optional[torch.dtype]):
        self.dtype = dtype
        self.tree: Dict[str, torch.Tensor] = {}

    def add(self, name: str, g: torch.Tensor) -> None:
        if self.dtype is not None:
            g = g.to(self.dtype)
        if name in self.tree:
            self.tree[name].add_(g)
        else:
            self.tree[name] = g


@dataclasses.dataclass
class Train:
    """The training program of one rank: ``init``, ``step`` and
    ``eval_step`` for one (config, optimizer, batch shape, mesh)."""

    config: TransformerConfig
    optimizer: ox.GradientTransformation
    device: torch.device
    global_batch_size: int
    seq_len: int
    ce_chunks: int = 0
    grad_accum: int = 1
    accum_dtype: str = "float32"
    mesh: Any = None
    rules: Any = None
    reduce_quant: str = "none"
    zero1: bool = False
    overlap: bool = False
    overlap_bucket_mb: float = 0.0
    allgather_quant: str = "none"
    zero1_stats: Optional[Dict[str, Any]] = None
    overlap_plan: Optional[Dict[str, Any]] = None
    wire: Optional[Wire] = None
    wires: Optional[Dict[str, Wire]] = None
    parallel: Optional[sharding.ModelParallel] = None

    def __post_init__(self):
        #: The data axis (ZeRO-1, the overlap engine and the int8 wires
        #: ride it): its degree and this rank's index on it.
        self.dp = self.wire.size if self.wire is not None else 1
        self.rank = self.wire.rank if self.wire is not None else 0
        self.wires = dict(self.wires or {})
        par = self.parallel
        sizes, coords = par.sizes, par.coords
        #: The batch group (data x fsdp x expert): its ranks split the
        #: batch.
        self.batch_axes = lr.batch_group_axes(self.mesh, self.rules)
        #: The seq axis: its degree, this rank's slice of the sequence and
        #: the axes the token and loss sums run over.
        self.sp = par.seq
        #: The pipe axis (``parallel/sharding.PipeGroup``), None at 1.
        self.pipe = par.pipe
        self.sp_rank = coords.get(mesh_lib.SEQ_AXIS, 0)
        self.sum_axes = lr.grad_sum_axes(self.mesh, self.rules)
        self.batch_ranks, self.batch_rank = 1, 0
        for axis in self.batch_axes:
            self.batch_ranks *= sizes[axis]
            self.batch_rank = self.batch_rank * sizes[axis] + coords[axis]
        shapes = {name: shape for name, shape in _stacked_shapes(
            self.config).items()}
        #: The layer-stacked leaf names in the reference's tree order.
        self.leaf_names = sorted(shapes, key=lambda n: tuple(n.split(".")))
        #: Each stacked leaf's fsdp/tensor layout (None: one rank holds
        #: every leaf whole, apart from ZeRO-1's data split).
        self.layouts: Optional[Dict[str, sharding.LeafSplit]] = None
        if par.active:
            meta = TransformerLM(self.config, device="meta")
            self.layouts = par.layouts(
                stacked_logical_axes(param_logical_axes(meta),
                                     stages=self.config.pipeline_stages > 1),
                shapes)
            self._check_blocks()
        self.shards: Optional[zero1_lib.ShardPlan] = None
        if self.zero1:
            itemsize = torch.empty((), dtype=self.config.param_dtype
                                   ).element_size()
            specs = {n: tuple(lay.dim_axes(d) or None
                              for d in range(len(lay.shape)))
                     for n, lay in (self.layouts or {}).items()}
            self.shards = zero1_lib.ShardPlan(
                shapes, self.dp, block=self.optimizer.shard_block,
                itemsizes={n: itemsize for n in shapes}, specs=specs,
                mesh_sizes={a: n for a, n in sizes.items() if a != "data"})
        self._plan: Optional[overlap_lib.OverlapPlan] = None
        if self.overlap:
            self._plan = overlap_lib.plan_buckets(
                [shapes[n] for n in self.leaf_names], self.overlap_bucket_mb,
                dtype_bytes=torch.empty(
                    (), dtype=_ACCUM_DTYPES[self.accum_dtype]).element_size())
            self.overlap_plan = self._plan.describe()
        self._issuer = None
        self._hooked = None
        self._parts = None  # (model, its _layer_parts)
        self._armed = False  # the overlap engine's hooks issue buckets
        self._opt_layouts = self._leaf_layouts()
        self._shard_view = None
        if any(lay.splits for lay in self._opt_layouts.values()):
            self._shard_view = ox.ShardView(self._opt_layouts,
                                            self._reduce_over)
        self._state_layouts = None
        self._world_wire = None

    @property
    def state_wire(self) -> Optional[Wire]:
        """The group whose ranks hold the state between them (an SDC
        digest completes split leaves over it, a save's health vote runs
        over it): the data wire, or the world's on a mesh with an fsdp,
        tensor, expert or seq axis."""
        if not self.parallel.active and self.sp <= 1:
            return self.wire
        if self._world_wire is None:
            self._world_wire = Wire(axis="world")
        return self._world_wire

    @property
    def local_batch(self) -> int:
        """This rank's rows of the global batch."""
        return self.global_batch_size // self.batch_ranks

    @property
    def local_seq(self) -> int:
        """This rank's columns of each row (its seq slice)."""
        return self.seq_len // self.sp

    def _check_blocks(self) -> None:
        """A block-quantized optimizer needs each fsdp/tensor box of a
        quantized leaf to be whole blocks of the whole leaf."""
        block = self.optimizer.shard_block
        if not block:
            return
        for name, lay in self.layouts.items():
            if math.prod(lay.shape) < self.optimizer.block_min_size:
                continue
            if not sharding.runs_are_whole_blocks(lay, self.parallel.sizes,
                                                  block):
                raise NotImplementedError(
                    f"{name}: its {lay.splits} box is not whole "
                    f"{block}-value blocks of the whole leaf {lay.shape}; "
                    f"a block-quantized optimizer state would differ from "
                    f"the whole leaf's")

    # -- state ------------------------------------------------------------------

    def init(self, seed: int = 0,
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> TrainState:
        """A fresh state: parameters from ``init_params(seed)`` (or the
        given state dict, e.g. ``state_dict_from_jax``), optimizer state
        from the optimizer's ``init`` (on this rank's shards under
        ZeRO-1).  Every rank draws the same parameters from the seed."""
        model = TransformerLM(self.config, self.device,
                              parallel=self.parallel)
        if params is None:
            params = init_params(self.config, seed=seed, device=self.device)
        if model.layouts is not None:
            params = _local_params(model, params)
        model.load_state_dict(params)
        del params
        model.train()
        with torch.no_grad(), ox.sharded_update(self._shard_view):
            opt_state = self.optimizer.init(self._local(_param_tree(model)))
        return TrainState(step=0, model=model, opt_state=opt_state)

    def restore(self, step: int, tree: Mapping[str, Any]) -> TrainState:
        """The state a restored checkpoint tree (``TrainState.
        checkpoint_tree``'s layout, e.g. ``Checkpointer.load_checkpoint``
        with a fresh state's tree as the template) describes."""
        state = self.init(params=tree["params"])
        state.opt_state = tree["opt_state"]
        state.step = step
        return state

    def _reduce_over(self, t: torch.Tensor, axes) -> None:
        for axis in axes:
            self.wires[axis].all_reduce(t)

    def _leaf_layouts(self) -> Dict[str, sharding.LeafSplit]:
        """Each stacked leaf's layout for the optimizer: the fsdp/tensor
        splits and ZeRO-1's data split."""
        out = {}
        shapes = _stacked_shapes(self.config)
        for name in self.leaf_names:
            lay = (self.layouts[name] if self.layouts is not None else
                   sharding.LeafSplit(shapes[name]))
            if self.shards is not None and self.shards[name].dim is not None:
                lay = lay.with_split(self.shards[name].dim, "data")
            out[name] = lay
        return out

    def _local(self, tree: ox.Tree) -> ox.Tree:
        """This rank's shards of a whole (stacked) tree."""
        if self.shards is None:
            return tree
        return {n: self.shards[n].take(t, self.rank)
                for n, t in tree.items()}

    def checkpoint_layout(self, state: TrainState, rank: Optional[int] = None
                          ) -> Dict[Tuple[str, ...], shm_handler.LeafLayout]:
        """Where each leaf of ``state.checkpoint_tree()`` lies on process
        ``rank`` (default: this one): the whole leaf's shape, the rank's
        box of it and its replica id (0 on the one rank of each box that
        writes it).  A parameter's box comes from its fsdp/tensor layout
        (replicated over the data axis: its data rank 0 writes it).  An
        optimizer-state leaf's splits are found per axis: the state the
        optimizer's ``init`` gives for the whole tree, on the meta device,
        against the state it gives for the tree split by that axis alone;
        each dimension that shrinks is that axis's.  A block-quantized
        moment of a leaf split on an inner dimension is not one box of the
        whole leaf's blocks and is refused."""
        coords, sizes = self._coords(rank), self.parallel.sizes
        params = self.param_layout(rank)
        state_splits = self._state_splits()
        out: Dict[Tuple[str, ...], shm_handler.LeafLayout] = {}
        for path, leaf in shm_handler.tree_flatten_with_path(
                state.checkpoint_tree()):
            if path[0] == "['params']":
                out[path] = params[path[1][2:-2]]
                continue
            shape = tuple(getattr(leaf, "shape", ()))
            lay = state_splits.get(path, sharding.LeafSplit(shape))
            if lay.local_shape(sizes) != shape:
                raise ValueError(
                    f"{''.join(path)}: a {shape} piece of a {lay.shape} leaf "
                    f"laid out as {lay.splits}")
            out[path] = shm_handler.LeafLayout(
                lay.shape, lay.index(coords, sizes),
                lay.replica_id(coords, sizes))
        return out

    def _coords(self, rank: Optional[int]) -> Dict[str, int]:
        if rank is None:
            return self.parallel.coords
        return mesh_lib.mesh_coords(self.mesh, rank)

    def param_layout(self, rank: Optional[int] = None
                     ) -> Dict[str, shm_handler.LeafLayout]:
        """Where each parameter of the model's state dict lies on process
        ``rank`` (default: this one): its fsdp/tensor box, replicated over
        the data axis (data rank 0 writes it).  A block's leaf under
        ``pipe`` is whole on the stage that holds the layer, which alone
        writes it (its box's other replicas, over data, write nothing)."""
        coords, sizes = self._coords(rank), self.parallel.sizes
        out = {}
        for name, shape in param_shapes(self.config).items():
            lay = sharding.LeafSplit(tuple(shape))
            on = sizes
            if self.layouts is not None:
                stacked = self.layouts[_block_leaf(name)]
                # The layers dimension of a block's leaf: pipe's split.
                shift = len(stacked.shape) - len(shape)
                lay = sharding.LeafSplit(lay.shape, tuple(
                    (d - shift, a) for d, a in stacked.splits
                    if d >= shift))
                if shift and stacked.dim_axes(0):
                    on = dict(sizes, **{mesh_lib.PIPE_AXIS: 1})
            out[name] = shm_handler.LeafLayout(
                lay.shape, lay.index(coords, on),
                lay.replica_id(coords, on))
        return out

    def _state_splits(self) -> Dict[Tuple[str, ...], sharding.LeafSplit]:
        """Each split optimizer-state leaf's layout (see
        :meth:`checkpoint_layout`), once per train."""
        if self._state_layouts is not None:
            return self._state_layouts
        plan = self._opt_layouts
        sizes = self.parallel.sizes

        def flat(shapes, view):
            meta = {n: torch.empty(s, dtype=self.config.param_dtype,
                                   device="meta") for n, s in shapes.items()}
            with ox.sharded_update(view):
                return {p: tuple(getattr(v, "shape", ())) for p, v in
                        shm_handler.tree_flatten_with_path(
                            {"opt_state": self.optimizer.init(meta)})}

        whole = flat({n: lay.shape for n, lay in plan.items()}, None)
        found: Dict[Tuple[str, ...], Dict[int, List[str]]] = {}
        axes = [a for a in mesh_lib.MESH_AXES
                if any(a in lay.axes for lay in plan.values())]
        for axis in sorted(axes, key=lambda a: a == "data"):
            cut = {}
            for n, lay in plan.items():
                shape = list(lay.shape)
                d = lay.dim_of(axis)
                if d is not None:
                    shape[d] //= sizes[axis]
                cut[n] = tuple(shape)
            view = ox.ShardView(plan, lambda t, a: None)
            for path, shape in flat(cut, view).items():
                for d, (a, b) in enumerate(zip(whole[path], shape)):
                    if a == b:
                        continue
                    if a != b * sizes[axis]:
                        raise ValueError(
                            f"{''.join(path)}: {shape} of {whole[path]} is "
                            f"not a {sizes[axis]}-way split of one "
                            f"dimension")
                    found.setdefault(path, {}).setdefault(d, []).append(axis)
        out = {}
        for path, dims in found.items():
            lay = sharding.LeafSplit(whole[path], tuple(
                (d, tuple(a)) for d, a in sorted(dims.items())))
            name = next((c[2:-2] for c in path if c[2:-2] in plan), None)
            if path[-1] in (".q", ".scales") and name is not None:
                dims = [d for d, _ in plan[name].splits]
                if len(dims) != 1 or math.prod(
                        plan[name].shape[:dims[0]]) != 1:
                    raise NotImplementedError(
                        f"{''.join(path)}: the block-quantized moment of "
                        f"{name}, split {plan[name].splits}, is not one "
                        f"range of the whole leaf's blocks")
            out[path] = lay
        self._state_layouts = out
        return out

    # -- one step -------------------------------------------------------------

    def _batch(self, batch: Mapping[str, Any]):
        def dev(x, dtype):
            return torch.as_tensor(x, device=self.device).to(dtype)

        inputs = dev(batch["inputs"], torch.long)
        targets = dev(batch["targets"], torch.long)
        if batch.get("weights") is None:
            weights = torch.ones(targets.shape, dtype=torch.float32,
                                 device=self.device)
        else:
            weights = dev(batch["weights"], torch.float32)
        if tuple(inputs.shape) != (self.local_batch, self.local_seq):
            raise ValueError(
                f"batch inputs {tuple(inputs.shape)} != (global_batch_size"
                f" / dp, seq_len / sp) = {(self.local_batch, self.local_seq)}"
            )
        return inputs, targets, weights

    def _forward_sums(self, model, inputs, targets, weights):
        """One forward pass -> (weighted CE sum, token count, aux loss).
        A pipe stage before the last has no head: its CE sum is the
        pipeline's 0-d zero (its backward runs the stage's reverse
        schedule)."""
        tp = model.tp
        if not model.last_stage:
            anchor, aux = model.forward_aux(inputs)
            return anchor, weights.float().sum(), aux
        with model.gathered():
            if self.ce_chunks:
                hidden, aux = model.forward_aux(inputs, return_hidden=True)
                if tp is not None:
                    hidden = tp.enter(hidden)
                ce, total_weight = chunked_cross_entropy_loss(
                    hidden, output_head(model), targets, weights,
                    num_chunks=self.ce_chunks, tp=tp,
                )
            else:
                logits, aux = model.forward_aux(inputs)
                ce, total_weight = cross_entropy_loss(logits, targets,
                                                      weights, tp=tp)
        return ce * total_weight, total_weight, aux

    # -- the step ---------------------------------------------------------------

    def _layer_parts(self, model: TransformerLM,
                     named: Dict[str, torch.Tensor]) -> Dict[str, List[str]]:
        """Each stacked leaf's per-layer parameter names, in layer order
        (once per model)."""
        if self._parts is not None and self._parts[0] is model:
            return self._parts[1]
        parts: Dict[str, List[Tuple[int, str]]] = {}
        for name in named:
            m = ox._BLOCK_NAME.match(name)
            key = f"blocks.{m.group(2)}" if m else name
            parts.setdefault(key, []).append((int(m.group(1)) if m else 0,
                                              name))
        out = {k: [n for _, n in sorted(v)] for k, v in parts.items()}
        self._parts = (model, out)
        return out

    def _leaf_grad(self, named, parts: List[str], stacked: bool
                   ) -> torch.Tensor:
        grads = [_grad(named[n]) for n in parts]
        for n in parts:
            named[n].grad = None
        return torch.stack(grads) if stacked else grads[0]

    def _algo(self, nbytes: int) -> str:
        return qc.select_reduce_algo(
            self.dp, payload_bytes=nbytes,
            crosses_dcn=qc.axis_crosses_dcn(self.wire))

    def _scatter(self, name: str, g: torch.Tensor, async_op: bool,
                 then) -> Optional[Pending]:
        """Reduce one leaf's gradient to its ZeRO-1 shard (all of it when
        the leaf is not split), fp or int8; ``then(shard)`` receives the
        result."""
        leaf = self.shards[name]
        nbytes = g.numel() * g.element_size()
        if self.reduce_quant == "int8":
            if leaf.dim is None:
                out = qc.quantized_all_reduce(g, self.wire, mean=False,
                                              algo=self._algo(nbytes))
            else:
                out = qc.quantized_reduce_scatter(
                    g, self.wire, dim=leaf.dim, mean=False,
                    algo=self._algo(nbytes))
            then(out)
            return None
        if leaf.dim is None:
            g = g.contiguous()
            return self.wire.all_reduce(g, async_op=async_op).then(
                lambda: then(g))
        moved = torch.movedim(g, leaf.dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // self.dp,) + tuple(
            moved.shape[1:]), dtype=g.dtype, device=g.device)
        pending = self.wire.reduce_scatter(out, moved, async_op=async_op)
        result = torch.movedim(out, 0, leaf.dim)
        return pending.then(lambda: then(result))

    def _gather(self, name: str, shard: torch.Tensor, async_op: bool,
                then) -> Optional[Pending]:
        """Re-replicate one updated leaf from its shards (fp, or int8 under
        the overlap engine with ``allgather_quant``)."""
        leaf = self.shards[name]
        if leaf.dim is None:
            then(shard)
            return None
        if self.overlap and self.allgather_quant == "int8":
            nbytes = shard.numel() * shard.element_size()
            then(qc.quantized_all_gather(shard, self.wire, dim=leaf.dim,
                                         algo=self._algo(nbytes)))
            return None
        moved = torch.movedim(shard, leaf.dim, 0).contiguous()
        out = torch.empty((moved.shape[0] * self.dp,) + tuple(
            moved.shape[1:]), dtype=shard.dtype, device=shard.device)
        pending = self.wire.all_gather(out, moved, async_op=async_op)
        whole = torch.movedim(out, 0, leaf.dim)
        return pending.then(lambda: then(whole))

    def _hook(self, model: TransformerLM, named) -> None:
        """The overlap engine's gradient hooks (once per model): each
        parameter's hook marks a part of its stacked leaf ready, and the
        issuer sends every complete bucket in plan order."""
        if self._hooked is model:
            return
        parts = self._layer_parts(model, named)
        index = {name: i for i, name in enumerate(self.leaf_names)}
        owner = {p: index[leaf] for leaf, ps in parts.items() for p in ps}

        def issue(_bucket, leaves):
            out = []
            for i in leaves:
                name = self.leaf_names[i]
                g = self._leaf_grad(named, parts[name],
                                    name.startswith("blocks."))
                out.append(self._scatter(
                    name, g, True,
                    lambda shard, name=name: self._acc.add(name, shard)))
            return out

        self._issuer = overlap_lib.BucketIssuer(
            self._plan, [len(parts[n]) for n in self.leaf_names], issue)
        self._armed = False

        def ready(pname):
            def fn(_p):
                if self._armed:
                    self._issuer.ready(owner[pname])
            return fn

        for pname, p in named.items():
            p.register_post_accumulate_grad_hook(ready(pname))
        self._hooked = model

    def _global_sum(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` (fp32) summed over the batch group's ranks and the
        seq group's (the tokens of every rank)."""
        if not self.sum_axes:
            return values
        values = values.clone()
        for axis in reversed(self.sum_axes):
            self.wires[axis].all_reduce(values)
        return values

    def _pipe_sum(self, values: torch.Tensor) -> torch.Tensor:
        """Loss sums (fp32) summed over ``pipe``, where the last stage
        alone holds them (as they are without a pipe axis)."""
        if self.pipe is None:
            return values
        values = values.clone()
        self.pipe.wire.all_reduce(values)
        return values

    def _axis_sums(self, grads: Dict[str, torch.Tensor]) -> None:
        """In place: over each axis that also splits leaves or tokens
        (fsdp, expert, seq), the gradients of the leaves it does not split
        (each rank's share from its rows or tokens) summed over its group,
        one all-reduce for all of them.  The leaves fsdp splits were
        reduce-scattered in the backward; the leaves expert splits hold
        every chunk routed to the rank's experts already; seq splits no
        leaf; pipe splits the stages' leaves, and each stage's share of
        the others (the embedding's, the head's) is summed."""
        for axis in (mesh_lib.FSDP_AXIS, mesh_lib.EXPERT_AXIS,
                     mesh_lib.SEQ_AXIS, mesh_lib.PIPE_AXIS):
            if self.parallel.sizes.get(axis, 1) <= 1:
                continue
            names = [n for n in self.leaf_names if n in grads
                     and (self.layouts is None
                          or self.layouts[n].dim_of(axis) is None)]
            if not names:
                continue
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            self.wires[axis].all_reduce(flat)
            at = 0
            for n in names:
                k = grads[n].numel()
                grads[n] = flat[at:at + k].view(grads[n].shape).to(
                    grads[n].dtype)
                at += k

    def step(self, state: TrainState, batch: Mapping[str, Any]
             ) -> Tuple[TrainState, Dict[str, Any]]:
        """One optimizer step on ``batch`` (``inputs``/``targets`` int
        ``[global_batch / dp, seq_len]``, this rank's rows, optional fp
        ``weights``).  At one data rank the collectives are no-ops and
        the step is the plain microbatched step."""
        model = state.model
        inputs, targets, weights = self._batch(batch)
        named = dict(model.named_parameters())
        for p in named.values():
            p.grad = None
        parts = self._layer_parts(model, named)
        n_micro = self.grad_accum
        micro = self.local_batch // n_micro
        w_total = torch.clamp(self._global_sum(weights.float().sum()),
                              min=1.0)
        self._acc = _Accum(_ACCUM_DTYPES[self.accum_dtype]
                           if (n_micro > 1 or self.overlap) else None)
        if self.overlap:
            self._hook(model, named)
        pending: List[Optional[Pending]] = []
        ce_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        aux_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(n_micro):
            sl = slice(i * micro, (i + 1) * micro)
            ce_sum, _, aux = self._forward_sums(
                model, inputs[sl], targets[sl], weights[sl])
            # The previous microbatch's reduce-scatters ran under this
            # forward; land them before the backward issues the next.
            for p in pending:
                if p is not None:
                    p.wait()
            pending = []
            self._armed = self.overlap
            # The aux loss is the same on every rank of the batch group
            # (an MoE layer's router means are the group's), and its
            # backward leaves each rank its own share: as the reference's,
            # a per-microbatch mean.
            (ce_sum / w_total + aux / n_micro).backward()
            self._armed = False
            with torch.no_grad():
                if self.overlap:
                    for issued in self._issuer.finish():
                        pending += issued
                else:
                    for name in self.leaf_names:
                        self._acc.add(name, self._leaf_grad(
                            named, parts[name], name.startswith("blocks.")))
                ce_acc += ce_sum.detach()
                aux_acc += aux.detach()
        for p in pending:
            if p is not None:
                p.wait()
        with torch.no_grad():
            sums = self._pipe_sum(self._global_sum(
                torch.stack([ce_acc, aux_acc])))
            params = _param_tree(model)
            grads = self._reduce(self._acc.tree, params)
            self._acc = None
            with ox.sharded_update(self._shard_view):
                local = self._local(params)
                grad_norm = ox.global_norm(grads)
                updates, state.opt_state = self.optimizer.update(
                    grads, state.opt_state, local)
                del grads
                # optax.apply_updates: the sum in the param dtype, which
                # is also the all-gather's wire dtype.
                new = {n: (local[n] + updates[n]).to(local[n].dtype)
                       for n in updates}
            del updates
            self._replicate(named, parts, new)
        state.step += 1
        metrics = {
            "loss": sums[0] / w_total,
            "aux_loss": sums[1] / (n_micro * self.batch_ranks * self.sp),
            "tokens": w_total,
            "grad_norm": grad_norm,
            "step": state.step,
        }
        return state, metrics

    def _reduce(self, acc: Dict[str, torch.Tensor], params: ox.Tree
                ) -> ox.Tree:
        """The accumulated partial gradients summed over the data ranks,
        in the params' dtype: whole leaves (replicated update) or this
        rank's ZeRO-1 shards."""
        out: Dict[str, torch.Tensor] = {}
        if self.overlap:
            return {n: acc[n].to(params[n].dtype) for n in self.leaf_names}
        self._axis_sums(acc)
        if self.wire is None:
            return {n: acc[n].to(params[n].dtype) for n in self.leaf_names}
        if self.shards is None:
            for name in self.leaf_names:
                g = acc[name]
                if self.reduce_quant == "int8" and self.grad_accum > 1:
                    g = qc.quantized_all_reduce(
                        g, self.wire, mean=False,
                        algo=self._algo(g.numel() * g.element_size()))
                else:
                    g = g.contiguous()
                    self.wire.all_reduce(g)
                out[name] = g.to(params[name].dtype)
            return out
        for name in self.leaf_names:
            g = acc[name].to(params[name].dtype)
            self._scatter(name, g, False,
                          lambda shard, name=name: out.__setitem__(name,
                                                                   shard))
        return out

    def _replicate(self, named, parts, new: ox.Tree) -> None:
        """Copy the updated leaves into the model's parameters: whole
        leaves directly, ZeRO-1 shards through an all-gather (per bucket,
        in plan order, under the overlap engine)."""
        def land(name, whole):
            whole = whole.to(named[parts[name][0]].dtype)
            if name.startswith("blocks."):
                for i, pname in enumerate(parts[name]):
                    named[pname].copy_(whole[i])
            else:
                named[name].copy_(whole)

        if self.shards is None:
            for name in self.leaf_names:
                land(name, new[name])
            return
        buckets = (self._plan.buckets if self.overlap else
                   [tuple(range(len(self.leaf_names)))])
        for bucket in buckets:
            issued = [self._gather(self.leaf_names[i],
                                   new[self.leaf_names[i]], self.overlap,
                                   lambda w, n=self.leaf_names[i]: land(n, w))
                      for i in bucket]
            if not self.overlap:
                continue
            for p in issued:
                if p is not None:
                    p.wait()

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Mapping[str, Any]
                  ) -> Dict[str, torch.Tensor]:
        """Forward-only loss on one batch -> ``{"loss", "aux_loss",
        "tokens"}`` (over every data rank's rows)."""
        inputs, targets, weights = self._batch(batch)
        ce_sum, total_weight, aux = self._forward_sums(
            state.model, inputs, targets, weights)
        if self.sum_axes or self.pipe is not None:
            sums = self._global_sum(torch.stack([
                ce_sum.float(), weights.float().sum(), aux.float()]))
            # The CE sum is the last stage's alone.
            sums[0] = self._pipe_sum(sums[:1])[0]
            total_weight = torch.clamp(sums[1], min=1.0)
            return {"loss": sums[0] / total_weight,
                    "aux_loss": sums[2] / (self.batch_ranks * self.sp),
                    "tokens": total_weight}
        return {"loss": ce_sum / total_weight, "aux_loss": aux,
                "tokens": total_weight}


def _block_leaf(name: str) -> str:
    """A per-layer parameter name's stacked leaf (``blocks.<i>.<rest>`` ->
    ``blocks.<rest>``)."""
    m = ox._BLOCK_NAME.match(name)
    return f"blocks.{m.group(2)}" if m else name


def _local_params(model: TransformerLM, params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``params`` for ``model``'s state dict: each whole leaf cut to this
    rank's box (``models/from_jax.shard_state_dict``); a leaf already at
    its box's shape passes as it is."""
    from dlrover_tpu_torch.models.from_jax import shard_state_dict

    local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if all(tuple(params[k].shape) == s for k, s in local.items()):
        # Whole leaves, or boxes already (a pipe stage keeps its layers).
        return {k: params[k] for k in local}
    return shard_state_dict(params, model.layouts, model.parallel)


def _grad(p: torch.Tensor) -> torch.Tensor:
    """A parameter's gradient; zeros where the loss does not reach it, as
    ``jax.grad`` gives."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _param_tree(model: TransformerLM) -> ox.Tree:
    """The JAX-shaped parameter tree: block parameters stacked over
    layers."""
    return ox.stack_layers(
        {k: p.detach() for k, p in model.named_parameters()})


def _stacked_shapes(config: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of the layer-stacked parameter tree."""
    shapes = param_shapes(config)
    out: Dict[str, Tuple[int, ...]] = {}
    for name, shape in shapes.items():
        m = ox._BLOCK_NAME.match(name)
        if m:
            key = f"blocks.{m.group(2)}"
            layers = out.get(key, (0,))[0] + 1
            out[key] = (layers,) + tuple(shape)
        else:
            out[name] = tuple(shape)
    return out


def build_train(
    config: TransformerConfig,
    optimizer: ox.GradientTransformation,
    *,
    global_batch_size: int,
    seq_len: int,
    ce_chunks: int = 0,
    grad_accum: int = 1,
    accum_dtype: str = "float32",
    reduce_quant: str = "none",
    zero1: bool = False,
    overlap: bool = False,
    overlap_bucket_mb: float = 4.0,
    allgather_quant: str = "none",
    mesh: Any = None,
    rules: Any = None,
    device: DeviceLike = None,
) -> Train:
    """The counterpart of ``build_sharded_train``: one rank's step on
    ``mesh`` (its data, fsdp, tensor, expert, seq and pipe axes; :func:`runtime.mesh.
    single_device_mesh`, one rank, when None) under ``rules``
    (``parallel.rules.DEFAULT_RULES`` when None)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if accum_dtype not in _ACCUM_DTYPES:
        raise ValueError(
            f"accum_dtype {accum_dtype!r} not in {sorted(_ACCUM_DTYPES)}"
        )
    for name, value in (("reduce_quant", reduce_quant),
                        ("allgather_quant", allgather_quant)):
        if value not in ("none", "int8"):
            raise ValueError(f"{name} {value!r} must be 'none' or 'int8'")
    if config.decode:
        raise ValueError("training takes a config with decode=False")
    device = resolve_device(device)
    rules = list(rules if rules is not None else lr.DEFAULT_RULES)
    sizes = mesh_lib.mesh_axis_sizes(mesh)
    mesh_lib.check_axes(sizes)
    batch_axes = lr.batch_group_axes(mesh, rules)
    sp = lr.sequence_axis(mesh, rules)
    model_axes = [a for a in (mesh_lib.FSDP_AXIS, mesh_lib.TENSOR_AXIS,
                              mesh_lib.EXPERT_AXIS, mesh_lib.SEQ_AXIS,
                              mesh_lib.PIPE_AXIS)
                  if sizes.get(a, 1) > 1]
    if model_axes and (overlap or reduce_quant != "none"
                       or allgather_quant != "none"):
        raise NotImplementedError(
            f"the overlap engine and the int8 wires ride the data axis "
            f"alone; beside the {'/'.join(model_axes)} axis they are not "
            f"ported (ROADMAP Queue 1 items 5, 6 and 9's remainder)")
    if model_axes:
        check_parallel(config, sizes)
    if seq_len % sp:
        raise ValueError(
            f"seq_len {seq_len} does not divide by the seq degree {sp}")
    world = 1
    for n in sizes.values():
        world *= n
    wires = mesh_lib.axis_wires(mesh) if world > 1 else {}
    wire = wires.get(mesh_lib.DATA_AXIS)
    dp = wire.size if wire is not None else 1
    batch_ranks = 1
    for axis in batch_axes:
        batch_ranks *= sizes[axis]
    if global_batch_size % (batch_ranks * grad_accum):
        raise ValueError(
            f"global_batch_size {global_batch_size} must be divisible by "
            f"dp*grad_accum = {batch_ranks}*{grad_accum} = "
            f"{batch_ranks * grad_accum}"
        )
    parallel = sharding.ModelParallel(
        mesh if mesh is not None else mesh_lib.single_device_mesh(), rules,
        wires)
    zero1_active = bool(zero1) and dp > 1
    overlap_active = bool(overlap) and zero1_active
    train = Train(
        config=config, optimizer=optimizer, device=device,
        global_batch_size=global_batch_size, seq_len=seq_len,
        ce_chunks=ce_chunks, grad_accum=grad_accum, accum_dtype=accum_dtype,
        mesh=mesh, rules=rules, reduce_quant=reduce_quant,
        zero1=zero1_active, overlap=overlap_active,
        overlap_bucket_mb=overlap_bucket_mb if overlap_active else 0.0,
        allgather_quant=allgather_quant if overlap_active else "none",
        wire=wire, wires=wires, parallel=parallel,
    )
    if train.shards is not None:
        train.zero1_stats = dict(train.shards.stats)
        logger.info(
            "zero1 sharded update: dp=%d, %d/%d leaves sharded",
            dp, train.zero1_stats["sharded_leaves"],
            len(train.leaf_names))
    if train.overlap_plan is not None:
        logger.info(
            "overlap engine: %d bucket(s) of ~%.1f MB over %d leaves%s%s",
            train.overlap_plan["num_buckets"], overlap_bucket_mb,
            train.overlap_plan["num_leaves"],
            " [int8 reduce-scatter]" if reduce_quant == "int8" else "",
            " [int8 all-gather]" if allgather_quant == "int8" else "")
    return train


def build_moe_stats_fn(train: Train):
    """The router statistics' harvest (the reference's
    ``build_moe_stats_fn``): ``fn(state, placed_batch) -> [2 + E]`` fp32
    on the train's device, ``[entropy, drop_fraction, load_0..]`` of every
    MoE layer (over the batch group) averaged over layers.  A forward of
    its own with no gradient, apart from the step; every rank of the
    batch group calls it on its own rows, together (its means are
    collectives)."""
    from dlrover_tpu_torch.models import moe

    if not train.config.num_experts:
        raise ValueError("build_moe_stats_fn needs an MoE config")

    @torch.no_grad()
    def run(state: TrainState, batch: Mapping[str, Any]) -> torch.Tensor:
        inputs, _, _ = train._batch(batch)
        model = state.model
        with moe.collect_router_stats() as stats, model.gathered():
            model.hidden(inputs)
        return torch.stack(stats).mean(dim=0)

    return run


def elastic_grad_accum(
    ref_accum: int,
    ref_world: int,
    world: int,
    global_batch_size: int,
    dp: int,
) -> int:
    """Rescale grad_accum for a resized world, tokens/step invariant.

    The global batch (hence tokens/step and the optimizer trajectory) is a
    property of the step, not the world; what a resize changes is the
    per-device working set.  Scaling N by ``ref_world / world`` keeps each
    microbatch's per-device rows (so activation memory) about constant:
    half the devices, twice the microbatches, same step semantics.  The
    target is snapped to the nearest feasible N (one that keeps every
    microbatch divisible over the ``dp``-way batch split), preferring the
    next LARGER feasible N so the reference per-microbatch memory budget
    is never exceeded.
    """
    world = max(1, world)
    ref_world = max(1, ref_world) or world
    target = max(1, int(round(ref_accum * ref_world / world)))
    per_shard = max(1, global_batch_size // max(1, dp))
    feasible = [
        n for n in range(1, per_shard + 1)
        if global_batch_size % (max(1, dp) * n) == 0
    ]
    if not feasible:
        return 1
    larger = [n for n in feasible if n >= target]
    return min(larger) if larger else max(feasible)


# Modeled share of each zero1 collective leg the overlap engine hides
# under compute (parallel/overlap.py: per-microbatch reduce-scatter,
# per-bucket all-gather).  Starting points of the phase model.
OVERLAP_HIDDEN_RS = 0.75
OVERLAP_HIDDEN_AG = 0.5


def microbatch_phase_plan(
    grad_accum: int,
    reduce_quant: str,
    step_seconds: float,
    zero1: bool = False,
    overlap: bool = False,
) -> list:
    """Modeled accumulate/reduce/update breakdown of one microbatched step
    (the reference's cost model, unchanged).

    The phases run inside one step the host times as a whole; this
    apportions the measured step time by the reference's model (reduce
    ~8% of the step on the fp wire, ~3% on int8; update ~4%; the rest
    accumulates, split evenly over the N microbatches).  Rows are dicts
    ``{"phase", "micro", "t0", "dur"}`` with times relative to step start
    — the trainer emits them as telemetry (``source="modeled"``).

    ``zero1=True`` replaces the replicated reduce/update tail with the
    sharded-update phases: ``reduce_scatter``, ``shard_update`` and
    ``allgather``.  ``overlap=True`` (zero1 only) books only the exposed
    remainder of each collective leg (``1 - OVERLAP_HIDDEN_RS`` of the
    reduce-scatter, ``1 - OVERLAP_HIDDEN_AG`` of the all-gather).
    """
    if zero1:
        rs_frac = 0.015 if reduce_quant == "int8" else 0.04
        update_frac = 0.015
        ag_frac = 0.04
        if overlap:
            rs_frac *= 1.0 - OVERLAP_HIDDEN_RS
            ag_frac *= 1.0 - OVERLAP_HIDDEN_AG
        accum_total = step_seconds * (
            1.0 - rs_frac - update_frac - ag_frac
        )
        per_micro = accum_total / max(1, grad_accum)
        rows = [
            {
                "phase": "accumulate", "micro": i,
                "t0": i * per_micro, "dur": per_micro,
            }
            for i in range(grad_accum)
        ]
        t = accum_total
        for phase, frac in (
            ("reduce_scatter", rs_frac),
            ("shard_update", update_frac),
            ("allgather", ag_frac),
        ):
            rows.append({
                "phase": phase, "micro": -1,
                "t0": t, "dur": step_seconds * frac,
            })
            t += step_seconds * frac
        return rows
    reduce_frac = 0.03 if reduce_quant == "int8" else 0.08
    update_frac = 0.04
    accum_total = step_seconds * (1.0 - reduce_frac - update_frac)
    per_micro = accum_total / max(1, grad_accum)
    rows = []
    for i in range(grad_accum):
        rows.append({
            "phase": "accumulate", "micro": i,
            "t0": i * per_micro, "dur": per_micro,
        })
    rows.append({
        "phase": "reduce", "micro": -1,
        "t0": accum_total, "dur": step_seconds * reduce_frac,
    })
    rows.append({
        "phase": "update", "micro": -1,
        "t0": step_seconds * (1.0 - update_frac),
        "dur": step_seconds * update_frac,
    })
    return rows


#: The dtypes ``Train._batch`` takes; other keys keep their own.
BATCH_DTYPES = {"inputs": torch.long, "targets": torch.long,
                "weights": torch.float32}


def _on_device(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def _own_rows(value, train: Train):
    """This batch-group rank's rows of ``value`` when ``value`` holds the
    whole global batch (data-major over ``data x fsdp x expert``; the
    ranks of a tensor group take the same rows), ``value`` itself when it
    holds the rank's rows already (a rank's own loader).  The rows are
    those the reference computes there: microbatch ``i`` of a step is the
    global rows ``[i * B / N, (i + 1) * B / N)`` (its ``to_micro``), split
    over the batch group, so rank ``r`` takes the ``r``-th ``1 / n`` of
    each microbatch (with one microbatch, the block ``[r * B / n, (r + 1)
    * B / n)``).  A dense step's sums do not depend on how the rows are
    grouped; an MoE step's router means are taken per microbatch."""
    rows = int(value.shape[0]) if getattr(value, "shape", None) else 0
    if train.sp > 1 and len(value.shape) >= 2 \
            and value.shape[1] == train.seq_len:
        # The rank's slice of every row's columns (its seq slice).
        cols = train.local_seq
        value = value[:, train.sp_rank * cols:(train.sp_rank + 1) * cols]
    if train.batch_ranks <= 1 or rows != train.global_batch_size:
        return value
    accum, r = train.grad_accum, train.batch_rank
    m = train.local_batch // accum
    parts = [value[i * (rows // accum) + r * m:
                   i * (rows // accum) + (r + 1) * m] for i in range(accum)]
    if len(parts) == 1:
        return parts[0]
    if isinstance(value, torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def shard_batch(batch: Mapping[str, Any], train: Train
                ) -> Dict[str, torch.Tensor]:
    """Place a host batch on ``train``'s device the way ``Train._batch``
    takes it: ``inputs``/``targets`` int64, ``weights`` fp32 (all-ones
    when absent, made on the device).  A tensor already on the device in
    its dtype passes through untouched (no copy, no "place" event), so
    the trainer hands prefetched batches back through this function.

    Under a seq axis each rank takes its ``S / sp`` slice of the columns
    of a whole-length batch.  Over a batch group of ``n`` ranks (``data x
    fsdp x expert``) each rank
    takes its own rows: of a whole global batch, the block ``[r * B / n,
    (r + 1) * B / n)`` for its batch index ``r`` (the rows the JAX batch
    sharding puts there; with ``grad_accum`` microbatches, its ``1 / n``
    of each, :func:`_own_rows`); a batch of the rank's rows (its own
    loader's) passes as it is.

    On the CPU this is a plain move.  On the card each host array is
    converted on the host, pinned and copied with ``non_blocking=True``
    on the current stream (``data.loader.DevicePrefetcher`` makes that
    its copy stream), so placing never waits for the device; a failure
    to pin or to copy raises.
    """
    device = train.device
    out: Dict[str, torch.Tensor] = {}
    placed_any = False
    t0 = time.perf_counter()
    for key, value in batch.items():
        if value is None:
            continue
        dtype = BATCH_DTYPES.get(key)
        value = _own_rows(value, train)
        if isinstance(value, torch.Tensor) and _on_device(value, device) \
                and (dtype is None or value.dtype == dtype):
            out[key] = value  # already placed (prefetched): passthrough
            continue
        placed_any = True
        host = (value if isinstance(value, torch.Tensor)
                else torch.as_tensor(np.asarray(value)))
        if dtype is not None:
            host = host.to(dtype)
        if device.type == "cuda" and not host.is_cuda:
            host = host.pin_memory().to(device, non_blocking=True)
        else:
            host = host.to(device)
        out[key] = host
    if "weights" not in out:
        out["weights"] = torch.ones(tuple(out["targets"].shape),
                                    dtype=torch.float32, device=device)
    if placed_any:
        from dlrover_tpu_torch.utils.profiler import pipeline_counters

        pipeline_counters().record_place(time.perf_counter() - t0)
    return out

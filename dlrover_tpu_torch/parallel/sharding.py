"""The fsdp and tensor axes: what GSPMD does with ``parallel/rules.py``'s
table in the reference, done by hand on the axes' wires.

The reference names every parameter dimension (``kernel_axes``), maps
the names onto mesh axes with the rule table and lets XLA place the
pieces and insert the collectives.  Here one process drives one device,
and this module carries the table out:

* :func:`leaf_layouts` resolves every parameter's logical axes to its
  ``(dim, axes)`` splits (``rules.leaf_splits``), and :class:`LeafSplit`
  says which box of the whole leaf a rank holds (:meth:`LeafSplit.take`
  cuts it, :meth:`LeafSplit.index` names it for a checkpoint record).
* ``tensor`` (Megatron-style): the model is built with its local heads,
  MLP columns and vocabulary rows; :class:`TensorGroup` is the pair of
  operators around a column- then row-parallel pair of products
  (:meth:`~TensorGroup.enter`: identity forward, all-reduce of the
  gradient; :meth:`~TensorGroup.exit`: all-reduce forward, identity
  backward), the vocab-parallel lookup and the vocab-parallel cross
  entropy (:func:`vocab_parallel_token_loss`: max and log-sum-exp over the
  group).
* ``fsdp``: a rank stores its slice of each leaf's ``embed`` dimension.
  An :class:`FsdpUnit` (a block's leaves, or the leaves outside the
  blocks) is all-gathered in one collective before its forward
  (:meth:`FsdpUnit.run`) and freed after it; under a remat policy the
  backward's recompute gathers it again.  Its backward reduce-scatters
  the unit's gradients, in the unit's leaf order (one agreed order on
  every rank, whatever order the hooks fire in), to each rank's slice.

* ``expert``: a rank holds its ``E / ep`` experts of each MoE layer (the
  expert kernels' ``expert`` dimension; the router and every dense leaf
  whole).  :class:`ExpertGroup` is what the layer needs of the mesh: the
  expert axis's wire for the dispatch's all-to-all legs, and the batch
  group (``data x expert``) its router means and statistics are taken
  over.

* ``seq`` (Ulysses or ring attention): a rank holds the tokens ``[r * S
  / sp, (r + 1) * S / sp)`` of every sequence and every parameter whole.
  :class:`SeqGroup` is what the model needs of it: the wire that
  ``models/attention.ulysses_attention`` swaps sequence for heads over
  (or that ``parallel/ring_attention.py`` hops K and V around), and the
  offset of the rank's tokens (their positions).

* ``pipe``: a rank holds one pipeline stage, the layers ``[s * L / S,
  (s + 1) * L / S)`` (the layer-stacked leaves split on their leading
  dimension), and every leaf outside the blocks whole.
  :class:`PipeGroup` is what ``parallel/pipeline.py`` needs of it: the
  stage, the stage count, the wire of the handoffs and the layer range.

Every collective goes through the axis's :class:`~dlrover_tpu_torch.
parallel.wire.Wire` (a gloo group stages CUDA payloads through the host);
nothing here hands a tensor to a process group directly, and neither
DTensor nor FSDP2 is used.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel import rules as lr
from dlrover_tpu_torch.runtime import mesh as mesh_lib

Splits = Tuple[Tuple[int, Tuple[str, ...]], ...]


# -- layouts -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafSplit:
    """One leaf's layout: the whole leaf's ``shape`` and its splits,
    ``(dim, axes)`` with the axes of a dimension outermost first (a rank's
    block of that dimension is its coordinates' row-major position over
    those axes)."""

    shape: Tuple[int, ...]
    splits: Splits = ()

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for _, axes in self.splits for a in axes)

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        for d, axes in self.splits:
            if d == dim:
                return axes
        return ()

    def dim_of(self, axis: str) -> Optional[int]:
        for d, axes in self.splits:
            if axis in axes:
                return d
        return None

    def local_shape(self, sizes: Mapping[str, int]) -> Tuple[int, ...]:
        out = list(self.shape)
        for d, axes in self.splits:
            for a in axes:
                out[d] //= sizes[a]
        return tuple(out)

    def index(self, coords: Mapping[str, int], sizes: Mapping[str, int]
              ) -> Tuple[Tuple[int, int], ...]:
        """The box of the whole leaf at ``coords``: ``(start, stop)`` per
        dimension."""
        out = [(0, d) for d in self.shape]
        for d, axes in self.splits:
            pos, n = 0, 1
            for a in axes:
                pos, n = pos * sizes[a] + coords[a], n * sizes[a]
            chunk = self.shape[d] // n
            out[d] = (pos * chunk, (pos + 1) * chunk)
        return tuple(out)

    def take(self, t: torch.Tensor, coords: Mapping[str, int],
             sizes: Mapping[str, int]) -> torch.Tensor:
        """The box at ``coords`` of the whole leaf ``t`` (a view)."""
        for d, (b, e) in enumerate(self.index(coords, sizes)):
            if (b, e) != (0, t.shape[d]):
                t = t.narrow(d, b, e - b)
        return t

    def with_split(self, dim: int, axis: str) -> "LeafSplit":
        """This layout with ``axis`` added innermost on ``dim``."""
        splits = dict(self.splits)
        splits[dim] = splits.get(dim, ()) + (axis,)
        return LeafSplit(self.shape, tuple(sorted(splits.items())))

    def replica_id(self, coords: Mapping[str, int],
                   sizes: Mapping[str, int]) -> int:
        """The rank's replica id of its box: its row-major position over
        the mesh axes above 1 that do not split the leaf (0 on the one
        rank of each box that writes it)."""
        rid = 0
        for axis in mesh_lib.MESH_AXES:
            if sizes.get(axis, 1) > 1 and axis not in self.axes:
                rid = rid * sizes[axis] + coords[axis]
        return rid


def check_divisible(name: str, layout: LeafSplit,
                    sizes: Mapping[str, int]) -> None:
    for d, axes in layout.splits:
        n = 1
        for a in axes:
            n *= sizes[a]
        if layout.shape[d] % n:
            raise ValueError(
                f"{name}: dimension {d} of {layout.shape} does not divide "
                f"by the {'x'.join(axes)} degree {n}")


def leaf_layouts(logical: Mapping[str, Sequence[str]],
                 shapes: Mapping[str, Tuple[int, ...]], rules,
                 sizes: Mapping[str, int]) -> Dict[str, LeafSplit]:
    """``{name: LeafSplit}`` for leaves of the given logical axes and
    whole shapes on a mesh of ``sizes`` (only axes above 1 split)."""
    out = {}
    for name, shape in shapes.items():
        axes = tuple(logical[name])
        if len(axes) != len(shape):
            raise ValueError(f"{name}: logical axes {axes} for {shape}")
        out[name] = LeafSplit(tuple(shape),
                              lr.leaf_splits(axes, rules, sizes))
        check_divisible(name, out[name], sizes)
    return out


def runs_are_whole_blocks(layout: LeafSplit, sizes: Mapping[str, int],
                          block: int) -> bool:
    """Whether every contiguous run of a rank's box, in the whole leaf's
    flattened order, starts and ends on a ``block``-value boundary: then
    the box's blocks are whole blocks of the whole leaf (block-quantized
    state computed on the box equals the whole leaf's, block by
    block)."""
    if not layout.splits:
        return True
    local = layout.local_shape(sizes)
    inner_dim = max(d for d, _ in layout.splits)
    run = local[inner_dim]
    for d in range(inner_dim + 1, len(local)):
        run *= local[d]
    return run % block == 0


# -- the tensor axis -----------------------------------------------------------


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.group.wire.all_reduce(g)
        return g, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        group.wire.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorGroup:
    """The tensor axis as a model sees it: its ``size``, this rank's
    ``rank`` on it and its ``wire``."""

    def __init__(self, wire, size: int, rank: int):
        self.wire, self.size, self.rank = wire, size, rank

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Before a column-parallel product: identity; the gradient is
        summed over the group (each rank's part of it comes from its own
        columns)."""
        return _Enter.apply(x, self)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """After a row-parallel product: the partial products summed over
        the group; the gradient passes as it is."""
        return _Exit.apply(x, self)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
        """Vocab-parallel ``table[ids]``: this rank's rows of the table
        ``[V / size, d]``; ids outside them give zero rows, and the rows
        are summed over the group."""
        rows = table.shape[0]
        local = ids - self.rank * rows
        outside = (local < 0) | (local >= rows)
        out = table[local.clamp(0, rows - 1)].to(dtype)
        out = out.masked_fill(outside[..., None], 0)
        return self.exit(out)


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, z_loss, group):
        vocab = logits.shape[-1]
        top = logits.max(dim=-1).values
        group.wire.all_reduce(top, op=dist.ReduceOp.MAX)
        total = (logits - top[..., None]).exp().sum(dim=-1)
        group.wire.all_reduce(total)
        log_z = total.log() + top
        local = targets.long() - group.rank * vocab
        inside = (local >= 0) & (local < vocab)
        local = local.clamp(0, vocab - 1)
        label = torch.gather(logits, -1, local[..., None])[..., 0]
        label = torch.where(inside, label, torch.zeros_like(label))
        group.wire.all_reduce(label)
        loss = log_z - label
        if z_loss:
            loss = loss + z_loss * log_z.square()
        ctx.save_for_backward(logits, log_z, local, inside)
        ctx.z_loss = z_loss
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, log_z, local, inside = ctx.saved_tensors
        scale = g
        if ctx.z_loss:
            scale = g * (1 + 2 * ctx.z_loss * log_z)
        grad = (logits - log_z[..., None]).exp() * scale[..., None]
        hit = torch.where(inside, g, torch.zeros_like(g))
        grad.scatter_add_(-1, local[..., None], -hit[..., None])
        return grad, None, None, None


def vocab_parallel_token_loss(logits32: torch.Tensor, targets: torch.Tensor,
                              z_loss: float, group: TensorGroup
                              ) -> torch.Tensor:
    """Per-token softmax cross entropy (plus ``z_loss * log_z^2``) from
    this rank's vocabulary columns of the fp32 logits: the max, the sum of
    exponentials and the target's logit are completed over the tensor
    group, so every rank returns the whole loss."""
    return _VocabCE.apply(logits32, targets, z_loss, group)


# -- the fsdp axis -------------------------------------------------------------


@contextlib.contextmanager
def swapped_params(module: torch.nn.Module,
                   tensors: Mapping[str, torch.Tensor]) -> Iterator[None]:
    """Within the block, ``module``'s parameters named in ``tensors``
    (dotted names) read as those tensors."""
    saved = []
    try:
        for name, t in tensors.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name \
                else module
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, unit, *shards):
        ctx.unit = unit
        return tuple(unit.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.unit.scatter(grads))


class FsdpUnit:
    """The leaves of one module that the fsdp axis splits: ``names``
    (dotted, relative to the module, in the agreed order) and the
    dimension each is split on.  :meth:`gather` and :meth:`scatter` move
    all of them in one collective each."""

    def __init__(self, wire, names: Sequence[str], dims: Sequence[int]):
        self.wire = wire
        self.names = tuple(names)
        self.dims = tuple(dims)

    def gather(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = self.wire.size
        moved = [torch.movedim(s, d, 0) for s, d in zip(shards, self.dims)]
        flat = torch.cat([m.reshape(-1) for m in moved])
        out = torch.empty((n, flat.numel()), dtype=flat.dtype,
                          device=flat.device)
        self.wire.all_gather(out, flat)
        whole, at = [], 0
        for m, d in zip(moved, self.dims):
            k = m.numel()
            part = out[:, at:at + k].reshape((n * m.shape[0],)
                                             + tuple(m.shape[1:]))
            whole.append(torch.movedim(part, 0, d).contiguous())
            at += k
        return whole

    def scatter(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = self.wire.size
        moved = [torch.movedim(g, d, 0) for g, d in zip(grads, self.dims)]
        rows = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
        out = torch.empty(rows.shape[1], dtype=rows.dtype,
                          device=rows.device)
        self.wire.reduce_scatter(out, rows)
        shards, at = [], 0
        for m, d in zip(moved, self.dims):
            shape = (m.shape[0] // n,) + tuple(m.shape[1:])
            k = m.numel() // n
            shards.append(torch.movedim(out[at:at + k].reshape(shape), 0,
                                        d).contiguous())
            at += k
        return shards

    @contextlib.contextmanager
    def gathered(self, module: torch.nn.Module) -> Iterator[None]:
        """Within the block, ``module`` reads its whole leaves: gathered
        now, and the gradients reduce-scattered to the shards in the
        backward."""
        shards = [module.get_parameter(n) for n in self.names]
        whole = _Gather.apply(self, *shards)
        with swapped_params(module, dict(zip(self.names, whole))):
            yield

    def run(self, module: torch.nn.Module, *args):
        """``module(*args)`` on the gathered leaves (the function a remat
        policy re-runs, gather included)."""
        with self.gathered(module):
            return module(*args)


# -- the expert axis -----------------------------------------------------------


class _GroupMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group.batch_ranks
        out = x.contiguous().clone()
        for wire in group.batch_wires:
            wire.all_reduce(out)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        # Every rank's loss holds the mean: each keeps its own share of
        # the cotangent, and the gradients' sum over the group completes
        # it (no second sum here).
        return g / ctx.n, None


class ExpertGroup:
    """An MoE layer's view of the mesh: the expert axis (``ep`` ranks,
    this one's index ``rank`` on it, its ``wire``, None at 1) and the
    batch group (``batch_ranks`` ranks over ``batch_wires``, one wire a
    batch axis above 1) that gates the global batch between them."""

    def __init__(self, wires: Mapping[str, object], sizes: Mapping[str, int],
                 coords: Mapping[str, int], batch_axes: Sequence[str]):
        self.ep = sizes.get(mesh_lib.EXPERT_AXIS, 1)
        self.rank = coords.get(mesh_lib.EXPERT_AXIS, 0)
        self.wire = wires.get(mesh_lib.EXPERT_AXIS) if self.ep > 1 else None
        self.batch_wires = [wires[a] for a in batch_axes]
        self.batch_ranks = 1
        for a in batch_axes:
            self.batch_ranks *= sizes[a]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over the batch group; the backward gives each
        rank ``1 / batch_ranks`` of its cotangent."""
        return _GroupMean.apply(x, self)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch group (no gradient)."""
        out = x.detach().contiguous().clone()
        for wire in self.batch_wires:
            wire.all_reduce(out)
        return out


# -- the seq axis ----------------------------------------------------------------


class SeqGroup:
    """The seq axis as a model sees it: its ``size``, this rank's ``rank``
    on it and its ``wire``.  Each sequence is split into ``size``
    contiguous slices, slice ``rank`` on this rank."""

    def __init__(self, wire, size: int, rank: int):
        self.wire, self.size, self.rank = wire, size, rank

    def offset(self, local_len: int) -> int:
        """The global position of this rank's first token, its slices
        being ``local_len`` tokens long."""
        return self.rank * local_len

    def gather_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """``[B, S / size, ...]`` slices of every rank -> the whole ``[B,
        S, ...]`` on each (no gradient: segment ids)."""
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        self.wire.all_gather(out, t.contiguous())
        out = out.movedim(0, 1)
        return out.reshape((t.shape[0], self.size * t.shape[1])
                           + tuple(t.shape[2:]))


# -- the pipe axis ---------------------------------------------------------------


class PipeGroup:
    """The pipe axis as a model sees it: ``size`` stages over its
    ``wire``, this rank's ``stage``.  Stage ``s`` holds the layers
    ``[s * L / size, (s + 1) * L / size)`` (:meth:`layers`), whatever the
    schedule: the circular one borrows the others it runs for a step."""

    def __init__(self, wire, size: int, stage: int):
        self.wire, self.size, self.stage = wire, size, stage

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1

    def layers(self, num_layers: int) -> range:
        per = num_layers // self.size
        return range(self.stage * per, (self.stage + 1) * per)


# -- the model's view of the mesh --------------------------------------------


class ModelParallel:
    """What a model and its step need of a mesh's fsdp, tensor, expert,
    seq and pipe axes: the axis sizes, this rank's coordinates, the axes'
    wires, the rule table and the batch group."""

    def __init__(self, mesh, rules, wires: Optional[Dict[str, object]] = None,
                 rank: Optional[int] = None):
        self.sizes = mesh_lib.mesh_axis_sizes(mesh) or dict.fromkeys(
            mesh_lib.MESH_AXES, 1)
        self.coords = mesh_lib.mesh_coords(mesh, rank)
        self.rules = list(rules)
        self.wires = dict(wires or {})
        self.fsdp = self.sizes.get(mesh_lib.FSDP_AXIS, 1)
        self.tensor = self.sizes.get(mesh_lib.TENSOR_AXIS, 1)
        self.expert = self.sizes.get(mesh_lib.EXPERT_AXIS, 1)
        self.pipe_size = self.sizes.get(mesh_lib.PIPE_AXIS, 1)
        self.seq = lr.sequence_axis(mesh, self.rules)
        self.batch_axes = lr.batch_group_axes(mesh, self.rules)
        self.sp = None
        if self.seq > 1:
            self.sp = SeqGroup(self.wires.get(mesh_lib.SEQ_AXIS), self.seq,
                               self.coords[mesh_lib.SEQ_AXIS])
        #: The pipe axis (:class:`PipeGroup`), None at 1.
        self.pipe = None
        if self.pipe_size > 1:
            if lr.logical_to_mesh_axes([lr.STAGES], self.rules)[0] != \
                    mesh_lib.PIPE_AXIS:
                raise NotImplementedError(
                    "under a pipe axis the port splits the stages over it, "
                    "as the default rules do; the rules map 'stages' "
                    "elsewhere")
            self.pipe = PipeGroup(self.wires.get(mesh_lib.PIPE_AXIS),
                                  self.pipe_size,
                                  self.coords[mesh_lib.PIPE_AXIS])
        self.tp = None
        if self.tensor > 1:
            for name in (lr.HEADS, lr.MLP, lr.VOCAB):
                if lr.logical_to_mesh_axes([name], self.rules)[0] != \
                        mesh_lib.TENSOR_AXIS:
                    raise NotImplementedError(
                        f"under a tensor axis the port splits heads, mlp "
                        f"and vocab over it, as the default rules do; the "
                        f"rules map {name!r} elsewhere")
            self.tp = TensorGroup(self.wires.get(mesh_lib.TENSOR_AXIS),
                                  self.tensor,
                                  self.coords[mesh_lib.TENSOR_AXIS])
        if self.expert > 1 and lr.logical_to_mesh_axes(
                [lr.EXPERT], self.rules)[0] != mesh_lib.EXPERT_AXIS:
            raise NotImplementedError(
                "under an expert axis the port splits the experts over it, "
                "as the default rules do; the rules map 'expert' elsewhere")

    @property
    def active(self) -> bool:
        """Whether a rank holds boxes of some leaves (not whole ones; a
        pipe rank holds its stage's layers): the seq axis splits none."""
        return (self.fsdp > 1 or self.tensor > 1 or self.expert > 1
                or self.pipe_size > 1)

    def expert_group(self) -> Optional[ExpertGroup]:
        """The MoE layers' :class:`ExpertGroup` (None at one batch rank
        and one expert rank: the layer's own tokens are the batch)."""
        if not self.batch_axes and self.expert <= 1:
            return None
        return ExpertGroup(self.wires, self.sizes, self.coords,
                           self.batch_axes)

    def layouts(self, logical: Mapping[str, Sequence[str]],
                shapes: Mapping[str, Tuple[int, ...]]
                ) -> Dict[str, LeafSplit]:
        return leaf_layouts(logical, shapes, self.rules, self.sizes)

    def unit(self, layouts: Mapping[str, LeafSplit],
             prefix: str = "") -> Optional[FsdpUnit]:
        """The :class:`FsdpUnit` of the leaves of ``layouts`` under
        ``prefix`` that the fsdp axis splits (names relative to the
        prefix, in sorted order), or None."""
        names, dims = [], []
        for name in sorted(layouts):
            if not name.startswith(prefix):
                continue
            d = layouts[name].dim_of(mesh_lib.FSDP_AXIS)
            if d is not None:
                names.append(name[len(prefix):])
                dims.append(d)
        if not names:
            return None
        return FsdpUnit(self.wires[mesh_lib.FSDP_AXIS], names, dims)

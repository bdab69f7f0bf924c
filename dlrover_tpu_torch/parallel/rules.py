"""Logical-axis sharding rules (port of ``dlrover_tpu/parallel/rules.py``,
as data).

The reference annotates every parameter and activation with logical axis
names and maps them onto mesh axes with a rule table; XLA then inserts
the collectives.  The tables here are the reference's, entry for entry
(``make_rules``, ``DEFAULT_RULES``, ``DDP_RULES``, ``RING_RULES``).  The
port applies them itself: the batch rule splits the global batch into
each batch-group rank's rows (:func:`batch_axes`,
:func:`batch_shard_count`, :func:`batch_group_axes`: the ``data`` and
``fsdp`` axes, and the ``expert`` axis), and a parameter's logical axes
(``kernel_axes`` on the model's layers, ``models/layers.py``) resolve to
the ``(dim, axes)`` splits of :func:`leaf_splits`, which
``parallel/sharding.py`` carries out: ``embed`` over ``fsdp``, ``mlp``,
``heads`` and ``vocab`` over ``tensor``, ``expert`` over ``expert``.  At ``fsdp = tensor = seq = 1`` the default table collapses
to data parallelism: parameters replicated, the batch split over
``data``.

The ``seq`` axis (:func:`sequence_axis`): ``act_seq -> seq`` gives each
rank of a seq group its slice of every sequence.  Under Ulysses
(``context="ulysses"``) ``act_heads -> (seq, tensor)`` gives it its heads
inside attention, where ``models/attention.ulysses_attention`` swaps one
split for the other with two all-to-alls; under ring attention
(``context="ring"``, :data:`RING_RULES`, with ``attention_impl="ring"``)
``act_heads -> tensor`` and the sequence stays split through the layer,
K and V hopping around the seq ring (``parallel/ring_attention.py``).  The seq axis splits no parameter here
(:func:`leaf_splits` leaves it out): the reference's GSPMD also splits
the learned position table's rows over it (their logical name is
``act_seq``), which the port keeps whole, since a rank's positions reach
rows outside any box of it; the values are the same.  Parameters are
replicated over ``seq``, so their gradients are summed over ``data x
seq`` (:func:`grad_sum_axes`), as GSPMD sums them, under either
context.

The ``pipe`` axis: ``stages -> pipe`` splits the layer-stacked leaves'
leading dimension (the reference's ``[S, L / S, ...]`` stage dim; the
port's ``[L, ...]`` leaves carry the name ``stages`` there when the model
is pipelined), so a pipe rank holds its stage's layers
(``parallel/pipeline.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

from dlrover_tpu_torch.runtime.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
    mesh_axis_sizes,
)

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Sequence[Tuple[str, MeshAxes]]

# Logical axis names used by all models.
BATCH = "batch"            # activation batch dim
ACT_SEQ = "act_seq"        # activation sequence dim (sharded under SP)
ACT_HEADS = "act_heads"    # activation heads dim inside attention
ACT_EMBED = "act_embed"    # activation embedding dim
EMBED = "embed"            # param embedding dim (FSDP shard dim)
MLP = "mlp"                # param MLP hidden dim (TP col split)
HEADS = "heads"            # param attention heads dim (TP split)
KV = "kv"                  # param per-head dim
VOCAB = "vocab"            # param vocab dim (TP vocab split)
EXPERT = "expert"          # param expert dim (EP shard dim)
LAYERS = "layers"          # scanned layer dim (within one pipeline stage)
STAGES = "stages"          # pipeline stage dim
NORM = "norm"              # 1-D norm scales/biases
GATHERED = "gathered"      # force-unsharded dim


def make_rules(
    *,
    fsdp: bool = True,
    tensor: bool = True,
    sequence: bool = True,
    expert: bool = True,
    pipeline: bool = True,
    context: str = "ulysses",
) -> List[Tuple[str, MeshAxes]]:
    """The rule table for a strategy combination (the reference's,
    entry for entry).  Every rule is safe at an axis size of 1, so the
    mesh shape alone decides the real strategy.  ``context`` picks the
    sequence-parallel style inside attention: ``"ulysses"`` (heads
    sharded over seq and tensor) or ``"ring"`` (sequence stays
    seq-sharded)."""
    rules: List[Tuple[str, MeshAxes]] = [
        (BATCH, (DATA_AXIS, FSDP_AXIS)),
        (ACT_EMBED, TENSOR_AXIS),
        (KV, None),
        (NORM, None),
        (GATHERED, None),
    ]
    rules.append((ACT_SEQ, SEQ_AXIS if sequence else None))
    if context == "ring":
        rules.append((ACT_HEADS, TENSOR_AXIS if tensor else None))
    else:
        rules.append(
            (ACT_HEADS, ((SEQ_AXIS, TENSOR_AXIS) if sequence else TENSOR_AXIS)
             if tensor or sequence else None)
        )
    rules.append((EMBED, FSDP_AXIS if fsdp else None))
    if tensor:
        rules += [(MLP, TENSOR_AXIS), (HEADS, TENSOR_AXIS), (VOCAB, TENSOR_AXIS)]
    else:
        rules += [(MLP, None), (HEADS, None), (VOCAB, None)]
    rules.append((EXPERT, EXPERT_AXIS if expert else None))
    rules.append((STAGES, PIPE_AXIS if pipeline else None))
    rules.append((LAYERS, None))
    return rules


# The default "everything composable" rule table.
DEFAULT_RULES: List[Tuple[str, MeshAxes]] = make_rules()

# Pure data-parallel (DDP-equivalent): replicate params, shard batch.
DDP_RULES: List[Tuple[str, MeshAxes]] = make_rules(
    fsdp=False, tensor=False, sequence=False, expert=False
)

# Ring context-parallelism: pair with TransformerConfig.attention_impl="ring".
RING_RULES: List[Tuple[str, MeshAxes]] = make_rules(context="ring")


def _entry_names(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, tuple):
        return tuple(entry)
    return (entry,)


def logical_to_mesh_axes(logical: Sequence[str], rules: Rules
                         ) -> Tuple[MeshAxes, ...]:
    """A spec (one entry per dim) for the logical axis names: each name's
    first rule, as flax resolves it; an unknown name is unsharded."""
    table: Dict[str, MeshAxes] = {}
    for name, axes in rules:
        table.setdefault(name, axes)
    return tuple(table.get(name) for name in logical)


def batch_axes(rules: Rules) -> Tuple[str, ...]:
    """The mesh axes the batch rule splits the batch over."""
    return _entry_names(logical_to_mesh_axes([BATCH], rules)[0])


def batch_shard_count(mesh, rules: Rules) -> int:
    """How many ways the batch dim is split on ``mesh`` (product of the
    batch rule's axis sizes)."""
    sizes = mesh_axis_sizes(mesh)
    out = 1
    for axis in batch_axes(rules):
        out *= sizes.get(axis, 1)
    return out


def batch_group_axes(mesh, rules: Rules) -> Tuple[str, ...]:
    """The mesh axes above 1 whose ranks split the batch, outermost first:
    the batch group.  Under the default table that is ``data`` and
    ``fsdp``, and the ``expert`` axis: the reference keeps the trunk's
    batch replicated over ``expert`` and splits each chunk again over
    ``(data, fsdp, expert)`` inside its all-to-all dispatch
    (``dlrover_tpu/models/moe.py`` ``_a2a_forward``); the port splits the
    trunk's batch over it too, so no trunk is computed twice, and the
    gradients are the reference's (``parallel/sharding.py``'s
    ``ExpertGroup``, ``trainer/train_lib.py``).  A batch rule that splits
    over another axis above 1 is refused."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for axis in batch_axes(rules):
        if sizes.get(axis, 1) <= 1:
            continue
        if axis not in (DATA_AXIS, FSDP_AXIS):
            raise NotImplementedError(
                f"the batch rule splits over {axis!r} (size {sizes[axis]});"
                " the port splits the batch over the data, fsdp and expert"
                " axes")
        out.append(axis)
    if sizes.get(EXPERT_AXIS, 1) > 1:
        out.append(EXPERT_AXIS)
    return tuple(out)


def leaf_splits(logical: Sequence[str], rules: Rules,
                sizes: Dict[str, int]) -> Tuple[Tuple[int, Tuple[str, ...]],
                                                ...]:
    """A parameter's splits on a mesh of ``sizes``: ``(dim, axes)`` for
    each dimension whose logical name the rules map onto mesh axes above
    1 (``axes`` outermost first; never ``seq``, which splits
    activations only); the other dimensions are whole."""
    out = []
    for dim, entry in enumerate(logical_to_mesh_axes(logical, rules)):
        axes = tuple(a for a in _entry_names(entry)
                     if sizes.get(a, 1) > 1 and a != SEQ_AXIS)
        if axes:
            out.append((dim, axes))
    return tuple(out)


def sequence_axis(mesh, rules: Rules) -> int:
    """The seq degree the activations are split over on ``mesh`` (1 when
    the seq axis is 1).  Above 1 the rules must split ``act_seq`` over
    ``seq``; inside attention Ulysses splits the heads over it
    (``act_heads -> (seq, tensor)``) and ring attention keeps them on
    ``tensor`` (``context="ring"``): the model's ``attention_impl`` picks
    which runs.  A table that keeps the sequence off it is refused."""
    size = mesh_axis_sizes(mesh).get(SEQ_AXIS, 1)
    if size <= 1:
        return 1
    act_seq = _entry_names(logical_to_mesh_axes([ACT_SEQ], rules)[0])
    if SEQ_AXIS not in act_seq:
        raise NotImplementedError(
            f"a seq axis of {size} under rules that map act_seq to "
            f"{act_seq or None}: the port splits the sequence over it, as "
            f"the default rules do")
    return size


def grad_sum_axes(mesh, rules: Rules) -> Tuple[str, ...]:
    """The mesh axes above 1 over which a replicated parameter's gradient
    is summed: the batch group (:func:`batch_group_axes`) and the seq
    axis, whose ranks hold other tokens of the same rows (under Ulysses
    and ring attention alike).  The pipe axis is not one: its ranks hold
    other layers of the same tokens (``trainer/train_lib.py`` sums the
    leaves outside the stages over it)."""
    out = batch_group_axes(mesh, rules)
    if sequence_axis(mesh, rules) > 1:
        out += (SEQ_AXIS,)
    return out

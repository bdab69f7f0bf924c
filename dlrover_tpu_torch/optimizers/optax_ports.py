"""Hand ports of the optax pieces ``train_lib.make_optimizer`` composes.

The JAX trainer builds its optimizer from optax 0.2.6 (``adafactor``,
``adamw``, ``lion``, ``clip_by_global_norm``, ``linear_schedule``,
``warmup_cosine_decay_schedule``); the port may not import optax, so this
module carries its own copy of each, transformation by transformation, in
the same order and with the same dtype rules (state in the parameter's
dtype; an optax fp32 scalar that meets a bf16 array promotes the product
to fp32, so those products are taken in fp32 here too).

A tree is a flat ``{name: tensor}`` dict whose leaves are the JAX
model's leaves: the per-layer tensors of a block parameter are *stacked*
(``stack_layers``) into one ``[num_layers, ...]`` leaf, as the JAX model's
``nn.scan`` stacks them.  That matters for Adafactor, whose factored
dimensions are chosen on the stacked shape and whose ``clip_by_block_rms``
and ``scale_by_param_block_rms`` take one RMS over all layers together:
per-layer tensors would make it a different optimizer.  (Not
``torch.optim.Adafactor`` either, which has other epsilons, clipping and
decay.)  An MoE expert kernel stacks to a 4-D ``[layers, E, in, out]``
leaf, factored over its two largest axes as optax factors it.

A transformation is ``GradientTransformation(init, update)`` with
``update(updates, state, params) -> (updates, state)``; counts are host
integers.  ``shard_block`` > 0 says the state is block-quantized in
blocks of that many values of the flattened leaf, so a ZeRO-1 shard must
be whole blocks (``optimizers/zero1.ShardPlan``).

Under ZeRO-1 and the fsdp and tensor axes the update runs on each rank's
shard of every leaf (:func:`sharded_update`).  The reference's
``tx.update`` runs on sharded arrays too, and GSPMD keeps every
reduction over a leaf global.  Here each such reduction says so itself:
the global norm, Adafactor's factored row and column means, its
block-RMS clip and its parameter scale sum the shard and complete the
sum over the axes that split what they reduce (a mean over one
dimension over that dimension's axes only; a leaf no axis splits counts
once), one all-reduce per axis per pass, and the factored dimensions and
the low-bit quantization threshold are chosen on the whole leaf's
shape.  Elementwise
transformations need nothing.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, \
    Union

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]

_BLOCK_NAME = re.compile(r"^blocks\.(\d+)\.(.+)$")


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Optional[Tree]], Tuple[Tree, Any]]
    shard_block: int = 0
    # The least whole-leaf size whose state is block-quantized (under
    # ``shard_block``); smaller leaves keep unquantized state.
    block_min_size: int = 0


# -- the shard view (ZeRO-1, fsdp, tensor) --------------------------------------

#: The :class:`ShardView` of the update in progress, or None.
_VIEW = None


class ShardView(NamedTuple):
    """What a transformation needs to know of sharded leaves: ``plan``
    maps a leaf name to its ``parallel.sharding.LeafSplit`` (the whole
    shape, and the mesh axes that split each dimension: ``fsdp`` and
    ``tensor`` from the rules, ``data`` from ZeRO-1), and ``reduce(t,
    axes)`` sums ``t`` in place over the groups of ``axes``."""

    plan: Any
    reduce: Callable[[torch.Tensor, Tuple[str, ...]], Any]


@contextlib.contextmanager
def sharded_update(view: Optional[ShardView]):
    """Run ``init``/``update`` calls on shards under ``view``."""
    global _VIEW
    prev, _VIEW = _VIEW, view
    try:
        yield
    finally:
        _VIEW = prev


def _layout(name: str):
    if _VIEW is None:
        return None
    return _VIEW.plan.get(name)


def _leaf_axes(name: str) -> Tuple[str, ...]:
    """The mesh axes that split leaf ``name`` under the active view (none:
    the rank holds it whole)."""
    layout = _layout(name)
    return layout.axes if layout is not None else ()


def _dim_axes(name: str, dim: int) -> Tuple[str, ...]:
    """The mesh axes that split dimension ``dim`` of leaf ``name``."""
    layout = _layout(name)
    return layout.dim_axes(dim) if layout is not None else ()


def full_shape(name: str, t: torch.Tensor) -> Tuple[int, ...]:
    """The whole leaf's shape (``t`` is its shard under the view)."""
    layout = _layout(name)
    return tuple(layout.shape) if layout is not None else tuple(t.shape)


def _reduce_many(parts: List[torch.Tensor],
                 axes: List[Tuple[str, ...]]) -> List[torch.Tensor]:
    """Sum each fp32 tensor of ``parts`` over the groups of its ``axes``:
    one all-reduce per axis for all the parts of the same axes."""
    out = list(parts)
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, a in enumerate(axes):
        if a:
            groups.setdefault(tuple(a), []).append(i)
    for a, members in groups.items():
        flat = torch.cat([parts[i].reshape(-1) for i in members])
        _VIEW.reduce(flat, a)
        at = 0
        for i in members:
            out[i] = flat[at:at + parts[i].numel()].reshape(parts[i].shape)
            at += parts[i].numel()
    return out


def _mean_squares(tree: Tree) -> Dict[str, torch.Tensor]:
    """``{name: mean of x^2 over the whole leaf}``; a split leaf's sum of
    squares is completed over the axes that split it."""
    out = {name: x.square().mean() for name, x in tree.items()
           if not _leaf_axes(name)}
    split = [name for name in tree if _leaf_axes(name)]
    sums = _reduce_many([tree[n].float().square().sum().reshape(1)
                         for n in split], [_leaf_axes(n) for n in split])
    for name, total in zip(split, sums):
        x = tree[name]
        numel = math.prod(full_shape(name, x))
        out[name] = (total[0] / numel).to(x.dtype)
    return out


def _map(fn, *trees: Tree) -> Tree:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _f32(x: float) -> float:
    """A value as optax computes it: rounded to float32."""
    return float(np.float32(x))


# -- trees ----------------------------------------------------------------------


def stack_layers(named: Dict[str, torch.Tensor]) -> Tree:
    """``{"blocks.<i>.<rest>": t}`` -> ``{"blocks.<rest>": stack over i}``,
    the JAX model's scan-stacked leaf; other names pass through."""
    groups: Dict[str, List[Tuple[int, torch.Tensor]]] = {}
    out: Tree = {}
    for name, t in named.items():
        m = _BLOCK_NAME.match(name)
        if m:
            groups.setdefault(f"blocks.{m.group(2)}", []).append(
                (int(m.group(1)), t))
        else:
            out[name] = t
    for name, items in groups.items():
        items.sort(key=lambda it: it[0])
        out[name] = torch.stack([t for _, t in items])
    return out


def unstack_layers(tree: Tree) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layers`: stacked leaves back to per-layer
    names (views into the stacked tensor)."""
    out = {}
    for name, t in tree.items():
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(t.shape[0]):
                out[f"blocks.{i}.{rest}"] = t[i]
        else:
            out[name] = t
    return out


def global_norm(tree: Tree) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every leaf, in
    fp32 (over the whole leaves under a shard view: each leaf's sum is
    completed over the axes that split it, so a leaf every rank holds
    whole counts once)."""
    groups: Dict[Tuple[str, ...], List[str]] = {}
    for n in tree:
        if _leaf_axes(n):
            groups.setdefault(_leaf_axes(n), []).append(n)
    if not groups:
        total = sum(x.float().square().sum() for x in tree.values())
        return torch.sqrt(total)
    parts = _reduce_many(
        [sum(tree[n].float().square().sum() for n in names).reshape(1)
         for names in groups.values()], list(groups))
    total = sum(p[0] for p in parts) + sum(
        x.float().square().sum() for n, x in tree.items()
        if not _leaf_axes(n))
    return torch.sqrt(total)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``optax.apply_updates``: ``p + u`` in the param's dtype."""
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(
        init, update, max((tx.shard_block for tx in txs), default=0),
        max((tx.block_min_size for tx in txs), default=0))


def _stateless(fn: Callable[[Tree, Optional[Tree]], Tree]
               ) -> GradientTransformation:
    return GradientTransformation(
        lambda params: (), lambda u, s, p=None: (fn(u, p), s)
    )


# -- schedules ------------------------------------------------------------------


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` (no ``transition_begin``)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return _f32((init_value - end_value) * frac + end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(
            f"cosine_decay_schedule requires positive decay_steps, got "
            f"{decay_steps}"
        )

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return _f32(init_value * ((1 - alpha) * cosine ** exponent + alpha))

    return schedule


def join_schedules(schedules: List[Schedule],
                   boundaries: List[int]) -> Schedule:
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha, exponent)],
        [warmup_steps],
    )


# -- transformations ------------------------------------------------------------


def scale(step_size: float) -> GradientTransformation:
    return _stateless(lambda u, p: _map(lambda g: g * step_size, u))


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    def update(updates, count, params=None):
        step = step_size_fn(count)
        return _map(lambda g: g * step, updates), count + 1

    return GradientTransformation(lambda params: 0, update)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule, *,
                           flip_sign: bool = True) -> GradientTransformation:
    m = -1 if flip_sign else 1
    if callable(learning_rate):
        return scale_by_schedule(lambda count: m * learning_rate(count))
    return scale(m * learning_rate)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Unchanged below ``max_norm``; ``g / norm * max_norm`` at or above
    it (not ``torch.nn.utils.clip_grad_norm_``'s ``max / (norm + 1e-6)``).
    The comparison stays on the device: no host sync."""
    def fn(updates, params):
        norm = global_norm(updates)
        keep = norm < max_norm
        return _map(
            lambda t: torch.where(keep, t, t / norm.to(t.dtype) * max_norm),
            updates,
        )

    return _stateless(fn)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    def fn(updates, params):
        ms = _mean_squares(updates)
        out = {}
        for name, u in updates.items():
            denom = torch.clamp(ms[name].sqrt() / threshold, min=1.0)
            out[name] = u / denom
        return out

    return _stateless(fn)


def _safe_rms(mean_square: torch.Tensor, min_rms: float) -> torch.Tensor:
    rms = mean_square.sqrt()
    return torch.where(rms <= min_rms, torch.full_like(rms, min_rms), rms)


def scale_by_param_block_rms(min_scale: float = 1e-3
                             ) -> GradientTransformation:
    def fn(updates, params):
        if params is None:
            raise ValueError("scale_by_param_block_rms needs params")
        ms = _mean_squares({name: params[name] for name in updates})
        return {name: u * _safe_rms(ms[name], min_scale)
                for name, u in updates.items()}

    return _stateless(fn)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def fn(updates, params):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        return _map(lambda g, p: g + weight_decay * p, updates, params)

    return _stateless(fn)


def _factored_dims(shape: Tuple[int, ...], factored: bool,
                   min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """The two largest axes to factor over (optax's choice, ties broken
    by the same ``np.argsort``), or None."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def scale_by_factored_rms() -> GradientTransformation:
    """Adafactor's factored second-moment scaling with optax's defaults
    (decay rate 0.8, no step offset, factor dims of at least 128, epsilon
    1e-30); state ``{"count", "v_row", "v_col", "v"}`` in each param's
    dtype."""
    factored, decay_rate, step_offset = True, 0.8, 0
    min_dim_size_to_factor, epsilon = 128, 1e-30

    def init(params):
        v_row, v_col, v = {}, {}, {}
        for name, p in params.items():
            dims = _factored_dims(full_shape(name, p), factored,
                                  min_dim_size_to_factor)
            one = p.new_zeros((1,))
            if dims is not None:
                d1, d0 = dims
                v_row[name] = p.new_zeros(np.delete(p.shape, d0).tolist())
                v_col[name] = p.new_zeros(np.delete(p.shape, d1).tolist())
                v[name] = one
            else:
                v_row[name], v_col[name] = one, one.clone()
                v[name] = torch.zeros_like(p)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def update(grads, state, params):
        if params is None:
            raise ValueError("scale_by_factored_rms needs params")
        t = np.float32(state["count"] - step_offset + 1)
        decay_t = float(np.float32(1.0) - t ** np.float32(-decay_rate))
        dims_of = {name: _factored_dims(full_shape(name, g), factored,
                                        min_dim_size_to_factor)
                   for name, g in grads.items()}
        sqr = {name: g * g + epsilon for name, g in grads.items()}
        # The factored means; one over a split dimension of a sharded
        # leaf is a sum completed over the axes that split that dimension.
        means, pending = {}, []
        for name, dims in dims_of.items():
            if dims is None:
                continue
            d1, d0 = dims
            for key, d in (("row", d0), ("col", d1)):
                if _dim_axes(name, d):
                    pending.append((name, key, d))
                else:
                    means[name, key] = sqr[name].mean(d)
        sums = _reduce_many([sqr[n].float().sum(d) for n, _, d in pending],
                            [_dim_axes(n, d) for n, _, d in pending])
        for (name, key, d), total in zip(pending, sums):
            n = full_shape(name, sqr[name])[d]
            means[name, key] = (total / n).to(sqr[name].dtype)
        updates, v_row, v_col, v = {}, {}, {}, {}
        new_rows = {}
        for name, g in grads.items():
            dtype = params[name].dtype
            dims = dims_of[name]
            if dims is not None:
                new_rows[name] = (
                    decay_t * state["v_row"][name].float()
                    + (1.0 - decay_t) * means[name, "row"].float()
                ).to(dtype)
                v_col[name] = (
                    decay_t * state["v_col"][name].float()
                    + (1.0 - decay_t) * means[name, "col"].float()
                ).to(dtype)
            else:
                new_v = (decay_t * state["v"][name].float()
                         + (1.0 - decay_t) * sqr[name].float()).to(dtype)
                updates[name] = g * new_v ** -0.5
                v_row[name] = state["v_row"][name]
                v_col[name] = state["v_col"][name]
                v[name] = new_v
        # The row factor's mean over the column dimension: completed over
        # the axes that split the column dimension.
        row_means, pending = {}, []
        for name, new_row in new_rows.items():
            d1, d0 = dims_of[name]
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            if _dim_axes(name, d1):
                pending.append((name, reduced_d1))
            else:
                row_means[name] = new_row.mean(reduced_d1, keepdim=True)
        sums = _reduce_many([new_rows[n].float().sum(d, keepdim=True)
                             for n, d in pending],
                            [_dim_axes(n, dims_of[n][0]) for n, _ in pending])
        for (name, d), total in zip(pending, sums):
            n = full_shape(name, grads[name])[dims_of[name][0]]
            row_means[name] = (total / n).to(new_rows[name].dtype)
        for name, new_row in new_rows.items():
            d1, d0 = dims_of[name]
            row_factor = (new_row / row_means[name]) ** -0.5
            col_factor = v_col[name] ** -0.5
            updates[name] = (grads[name] * row_factor.unsqueeze(d0)
                             * col_factor.unsqueeze(d1))
            v_row[name] = new_row
            v[name] = state["v"][name]
        return updates, {"count": state["count"] + 1, "v_row": v_row,
                         "v_col": v_col, "v": v}

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    def init(params):
        return {"count": 0,
                "mu": _map(torch.zeros_like, params),
                "nu": _map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        mu = _map(lambda g, t: (1 - b1) * g + b1 * t, updates, state["mu"])
        nu = _map(lambda g, t: (1 - b2) * g ** 2 + b2 * t, updates,
                  state["nu"])
        count = state["count"] + 1
        c1 = _f32(1 - np.float32(b1) ** np.float32(count))
        c2 = _f32(1 - np.float32(b2) ** np.float32(count))
        out = _map(
            lambda m, v: (m / c1) / (torch.sqrt(v / c2 + eps_root) + eps),
            mu, nu,
        )
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_lion(b1: float = 0.9, b2: float = 0.99
                  ) -> GradientTransformation:
    """``optax.scale_by_lion`` (no ``mu_dtype``): the sign of the
    interpolation ``(1 - b1) g + b1 m``, then the moment ``(1 - b2) g +
    b2 m``; state ``{"count", "mu"}``, ``mu`` in each param's dtype."""
    def init(params):
        return {"count": 0, "mu": _map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        out = _map(lambda g, m: torch.sign((1.0 - b1) * g + b1 * m),
                   updates, state["mu"])
        mu = _map(lambda g, m: (1 - b2) * g + b2 * m, updates, state["mu"])
        return out, {"count": state["count"] + 1, "mu": mu}

    return GradientTransformation(init, update)


def trace(decay: float) -> GradientTransformation:
    """``optax.trace`` (no Nesterov): ``t = g + decay * t``, state in each
    param's dtype."""
    def init(params):
        return {"trace": _map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        new = _map(lambda g, t: g + decay * t, updates, state["trace"])
        return new, {"trace": new}

    return GradientTransformation(init, update)


# -- the optimizers (AGD, µP and WSAM: optimizers/{agd,mup,wsam}.py) -----------


def sgd(learning_rate: ScalarOrSchedule, momentum: Optional[float] = None
        ) -> GradientTransformation:
    """``optax.sgd``: an optional momentum trace, then the negated
    learning rate."""
    parts = [trace(momentum)] if momentum is not None else []
    return chain(*parts, scale_by_learning_rate(learning_rate))


def adafactor(learning_rate: ScalarOrSchedule) -> GradientTransformation:
    """``optax.adafactor(learning_rate)`` with its defaults (no momentum,
    no weight decay, multiply_by_parameter_scale): factored rms, block-rms
    clip at 1.0, learning rate, param block rms, then -1."""
    return chain(
        scale_by_factored_rms(),
        clip_by_block_rms(1.0),
        scale_by_learning_rate(learning_rate, flip_sign=False),
        scale_by_param_block_rms(),
        scale(-1),
    )


def adamw(learning_rate: ScalarOrSchedule, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw`` (no mask, no Nesterov): Adam, decoupled weight
    decay, then the negated learning rate."""
    return chain(
        scale_by_adam(b1, b2, eps, eps_root),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(learning_rate),
    )


def lion(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 1e-3) -> GradientTransformation:
    """``optax.lion`` (no mask): the sign update, decoupled weight decay,
    then the negated learning rate.  Elementwise, so a ZeRO-1 or fsdp
    shard updates on its own."""
    return chain(
        scale_by_lion(b1, b2),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(learning_rate),
    )

"""Hand ports of the optax pieces ``train_lib.make_optimizer`` composes.

The JAX trainer builds its optimizer from optax 0.2.6 (``adafactor``,
``adamw``, ``clip_by_global_norm``, ``linear_schedule``,
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
integers.
"""

from __future__ import annotations

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
    fp32."""
    total = sum(x.float().square().sum() for x in tree.values())
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

    return GradientTransformation(init, update)


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
    def clip(u):
        denom = torch.clamp(u.square().mean().sqrt() / threshold, min=1.0)
        return u / denom

    return _stateless(lambda u, p: _map(clip, u))


def _safe_rms(x: torch.Tensor, min_rms: float) -> torch.Tensor:
    rms = x.square().mean().sqrt()
    return torch.where(rms <= min_rms, torch.full_like(rms, min_rms), rms)


def scale_by_param_block_rms(min_scale: float = 1e-3
                             ) -> GradientTransformation:
    def fn(updates, params):
        if params is None:
            raise ValueError("scale_by_param_block_rms needs params")
        return _map(lambda u, p: u * _safe_rms(p, min_scale), updates,
                    params)

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
            dims = _factored_dims(tuple(p.shape), factored,
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
        updates, v_row, v_col, v = {}, {}, {}, {}
        for name, g in grads.items():
            dtype = params[name].dtype
            dims = _factored_dims(tuple(g.shape), factored,
                                  min_dim_size_to_factor)
            grad_sqr = g * g + epsilon
            if dims is not None:
                d1, d0 = dims
                new_row = (decay_t * state["v_row"][name].float()
                           + (1.0 - decay_t) * grad_sqr.mean(d0).float()
                           ).to(dtype)
                new_col = (decay_t * state["v_col"][name].float()
                           + (1.0 - decay_t) * grad_sqr.mean(d1).float()
                           ).to(dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = new_row.mean(reduced_d1, keepdim=True)
                row_factor = (new_row / row_col_mean) ** -0.5
                col_factor = new_col ** -0.5
                updates[name] = (g * row_factor.unsqueeze(d0)
                                 * col_factor.unsqueeze(d1))
                v_row[name], v_col[name] = new_row, new_col
                v[name] = state["v"][name]
            else:
                new_v = (decay_t * state["v"][name].float()
                         + (1.0 - decay_t) * grad_sqr.float()).to(dtype)
                updates[name] = g * new_v ** -0.5
                v_row[name] = state["v_row"][name]
                v_col[name] = state["v_col"][name]
                v[name] = new_v
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


# -- the optimizers -------------------------------------------------------------


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

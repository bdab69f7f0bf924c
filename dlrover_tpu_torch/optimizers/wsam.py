"""WSAM: sharpness-aware minimization with a weighted sharpness term
(port of ``dlrover_tpu/optimizers/wsam.py``).

One step takes two gradients: at the parameters ``w`` and at the ascent
point ``w + e(w)`` (``rho`` times the first gradient over its global
norm, times ``w^2`` elementwise when ``adaptive``), each through
``torch.autograd.grad`` of the caller's loss.  With ``decouple`` the base
optimizer steps on the first gradient and the sharpness component
``g2 - g1`` is applied as a separate step of ``learning_rate * alpha``;
otherwise the base optimizer steps on ``alpha g2 + (1 - alpha) g1``.
``alpha = gamma / (1 - gamma)``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from dlrover_tpu_torch.optimizers import optax_ports as ox


class WSAMConfig(NamedTuple):
    rho: float = 0.05
    gamma: float = 0.9        # sharpness weight alpha = gamma / (1 - gamma)
    sam_eps: float = 1e-12
    adaptive: bool = False
    decouple: bool = True
    learning_rate: float = 1e-3  # used by the decoupled sharpness term


def _grad(loss_fn: Callable, params: Dict[str, torch.Tensor], batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_wsam_step(
    loss_fn: Callable,
    base_tx: ox.GradientTransformation,
    config: Optional[WSAMConfig] = None,
) -> Callable:
    """``step(params, opt_state, *batch) -> (params, opt_state, loss)``
    for ``loss_fn(params, *batch) -> scalar`` over a ``{name: tensor}``
    tree.  ``params`` is not changed in place."""
    config = config if config is not None else WSAMConfig()
    alpha = config.gamma / (1.0 - config.gamma)

    @torch.no_grad()
    def step(params, opt_state, *batch):
        loss, g1 = _grad(loss_fn, params, batch)
        norm = ox.global_norm(g1)
        scale = config.rho / (norm + config.sam_eps)

        def ascend(p, g):
            factor = p * p if config.adaptive else 1.0
            return p + factor * g * scale

        w_adv = {k: ascend(params[k], g1[k]) for k in params}
        _, g2 = _grad(loss_fn, w_adv, batch)
        if config.decouple:
            updates, opt_state = base_tx.update(g1, opt_state, params)
            new = ox.apply_updates(params, updates)
            new = {k: p - config.learning_rate * alpha * (g2[k] - g1[k])
                   for k, p in new.items()}
        else:
            mixed = {k: alpha * g2[k] + (1.0 - alpha) * g1[k] for k in g1}
            updates, opt_state = base_tx.update(mixed, opt_state, params)
            new = ox.apply_updates(params, updates)
        return new, opt_state, loss

    return step

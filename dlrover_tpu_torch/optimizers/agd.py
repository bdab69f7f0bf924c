"""AGD: the auto-switchable optimizer preconditioned by the stepwise
gradient difference (port of ``dlrover_tpu/optimizers/agd.py``).

The second moment accumulates the difference of consecutive
bias-corrected first moments (a cheap curvature proxy) instead of the
squared gradient, so the step moves between SGD-like and Adam-like.  As
in the reference: at step 1 the difference is the corrected moment
itself, ``amsgrad`` keeps the running maximum of the second moment, the
weight decay is decoupled (folded into the update, times the learning
rate), and a schedule is read at the 0-based count (optax's convention)
while the bias corrections use the 1-based step.  The step's scalars are
float32, as the reference computes them; the count is a host integer.
Elementwise, so a ZeRO-1 or fsdp shard updates on its own.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from dlrover_tpu_torch.optimizers import optax_ports as ox


class AGDState(NamedTuple):
    count: int
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    max_exp_avg_sq: Optional[Dict[str, torch.Tensor]]


def _f32(x) -> float:
    return float(np.float32(x))


def agd(
    learning_rate: ox.ScalarOrSchedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    delta: float = 1e-5,
    weight_decay: float = 0.0,
    amsgrad: bool = False,
    clip: Optional[float] = None,
) -> ox.GradientTransformation:
    """Decoupled-weight-decay AGD, the reference's default configuration."""

    def init(params):
        return AGDState(
            count=0,
            exp_avg={k: torch.zeros_like(p) for k, p in params.items()},
            exp_avg_sq={k: torch.zeros_like(p) for k, p in params.items()},
            max_exp_avg_sq=({k: torch.zeros_like(p)
                             for k, p in params.items()}
                            if amsgrad else None),
        )

    def update(grads, state: AGDState, params=None):
        if params is None:
            raise ValueError("agd requires params (decoupled weight decay)")
        count = state.count + 1
        t = np.float32(count)
        scheduled = callable(learning_rate)
        lr = _f32(learning_rate(state.count) if scheduled
                  else learning_rate)
        bc1 = np.float32(1.0) - np.float32(b1) ** t
        bc1_old = np.float32(1.0) - np.float32(b1) ** (t - np.float32(1.0))
        bc2 = np.float32(1.0) - np.float32(b2) ** t
        root_bc2 = np.sqrt(bc2)
        delta_adjust = _f32(np.float32(delta) * root_bc2)
        lr_adjust = _f32(np.float32(lr) * root_bc2 / bc1)
        # lr * weight_decay: a float32 product when the schedule gives
        # lr, the Python product of two floats otherwise (the reference's
        # weak typing).
        decay = (_f32(np.float32(lr) * np.float32(weight_decay))
                 if scheduled else
                 (learning_rate * weight_decay))
        bc1, bc1_old = _f32(bc1), _f32(bc1_old)

        exp_avg, exp_avg_sq, max_sq, updates = {}, {}, {}, {}
        for name, g in grads.items():
            m_old = state.exp_avg[name]
            m = b1 * m_old + (1 - b1) * g
            if count == 1:
                diff = m / bc1
            else:
                diff = m / bc1 - m_old / bc1_old
            v = b2 * state.exp_avg_sq[name] + (1 - b2) * diff * diff
            if amsgrad:
                max_sq[name] = torch.maximum(state.max_exp_avg_sq[name], v)
                src = max_sq[name]
            else:
                src = v
            denom = torch.clamp(torch.sqrt(src), min=delta_adjust)
            u = m / denom
            if clip is not None:
                u = torch.clamp(u, -clip, clip)
            updates[name] = -(lr_adjust * u + decay * params[name])
            exp_avg[name], exp_avg_sq[name] = m, v
        return updates, AGDState(count, exp_avg, exp_avg_sq,
                                 max_sq if amsgrad else None)

    return ox.GradientTransformation(init, update)


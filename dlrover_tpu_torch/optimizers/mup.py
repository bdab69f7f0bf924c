"""µP, the maximal-update parametrization (port of
``dlrover_tpu/optimizers/mup.py``).

Widths are static facts of the config, so µP is (a) a logit multiplier
on the model (``TransformerConfig.logit_scale``, :func:`mup_config`) and
(b) an update scaling chained after any optimizer (:func:`mup_scale`):
relative to a ``base`` width, matrix-like hidden parameters (both fan
dimensions grow with the width) take their update divided by the width
multiplier; vector-like ones (embeddings, biases, norms) keep it.

The classification reads the leaf's name and its number of dimensions
on the tree the optimizer sees, the layer-stacked one (``optax_ports.
stack_layers``), as the reference reads its scan-stacked tree: a stacked
bias has two dimensions and is still vector-like by its name.
"""

from __future__ import annotations

import dataclasses

from dlrover_tpu_torch.models.transformer import TransformerConfig
from dlrover_tpu_torch.optimizers import optax_ports as ox

# Name fragments that are vector-like whatever the number of dimensions
# (an embedding table has two, but only one grows with the width).
_VECTOR_LIKE = ("embed", "pos_embedding", "scale", "bias", "ln_")


def is_matrix_like(path: str, ndim: int) -> bool:
    if ndim < 2:
        return False
    lowered = path.lower()
    return not any(frag in lowered for frag in _VECTOR_LIKE)


def mup_config(config: TransformerConfig,
               base_d_model: int) -> TransformerConfig:
    """A config's µP knobs relative to the tuning-width base."""
    width_mult = config.d_model / base_d_model
    return dataclasses.replace(config, logit_scale=1.0 / width_mult)


def mup_scale(width_mult: float) -> ox.GradientTransformation:
    """Chain after the base optimizer: divides matrix-like updates by
    ``width_mult`` (``ox.chain(ox.adamw(lr), mup_scale(d / base_d))``)."""

    def update(updates, state, params=None):
        return {name: u / width_mult if is_matrix_like(name, u.dim())
                else u for name, u in updates.items()}, state

    return ox.GradientTransformation(lambda params: (), update)

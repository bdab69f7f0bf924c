"""A speculative draft carved out of the target itself (port of
``make_draft`` and ``_damp_leaf`` of ``tools/serve_bench.py``).

The draft is the target's first ``draft_layers`` blocks with the target's
embedding, positions, final norm and head.  Both legs of a speculative
run serve a *damped* copy of the target: the output projections of its
later blocks (the attention's ``out`` and the MLP's ``wo``, kernels and
biases, an MoE layer's expert ``wo`` too) are scaled by ``damp``, pushing
those blocks toward residual pass-through, so the draft predicts the
damped target well (high acceptance) with no training in the loop.  The
leaves scaled are those the reference's keystr match picks: a parameter
of a block with an ``out`` or ``wo`` component in its name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from dlrover_tpu_torch.models.transformer import TransformerConfig


def _damped_layer(name: str) -> int:
    """The block index of a leaf the damping scales, or -1."""
    parts = name.split(".")
    if parts[0] != "blocks" or len(parts) < 3 or not parts[1].isdigit():
        return -1
    if "out" in parts[2:] or "wo" in parts[2:]:
        return int(parts[1])
    return -1


@torch.no_grad()
def make_draft(
    config: TransformerConfig,
    params: Mapping[str, torch.Tensor],
    draft_layers: int = 1,
    damp: float = 0.05,
) -> Tuple[TransformerConfig, Dict[str, torch.Tensor],
           Dict[str, torch.Tensor]]:
    """``(draft_config, draft_params, damped_params)`` from a state dict
    (``init_params`` or ``from_jax.state_dict_from_jax``): the damped
    target's leaves of the later blocks are new tensors (``leaf * damp``
    in the leaf's dtype), the others the inputs themselves; the draft
    shares the damped target's tensors."""
    if not 1 <= draft_layers <= config.num_layers:
        raise ValueError(f"draft_layers must be in [1, {config.num_layers}]"
                         f", got {draft_layers}")
    damped: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        layer = _damped_layer(name)
        if layer >= draft_layers:
            leaf = leaf * torch.tensor(damp, dtype=leaf.dtype,
                                       device=leaf.device)
        damped[name] = leaf
    draft = {
        name: leaf for name, leaf in damped.items()
        if not name.startswith("blocks.")
        or int(name.split(".")[1]) < draft_layers
    }
    return (dataclasses.replace(config, num_layers=draft_layers), draft,
            damped)

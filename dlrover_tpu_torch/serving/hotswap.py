"""Live weight hot-swap helpers (port of ``dlrover_tpu/serving/hotswap.py``):
checkpoint -> serving-model mapping and the digests.

The swap contract (``ServingEngine.swap_weights``) is *no drain, no
rebuild*: the model object, the KV pool and the slot state stay; the new
weights land in fresh tensors that are assigned into the model between
two decode steps.  Everything that could break that contract is checked
on the host before the engine commits:

* :func:`map_checkpoint_to_params` — match the flat ``{path: tensor}``
  records a :class:`~dlrover_tpu_torch.checkpoint.engine.
  StorageStepReader` reassembles (shard records already crc-verified)
  onto the serving model's state dict by name, tolerating the training
  state's leading ``params`` component (``train_lib.TrainState.
  checkpoint_tree`` saves ``{"params": state dict, ...}``).  A missing
  leaf, or one whose shape or dtype drifted, refuses the swap up front: a
  drifted tree is a different model.
* :func:`host_digest` — the reference's numpy fold (uint32 byte sum a
  leaf, ``acc = acc * 1000003 + leaf_sum`` mod 2^32) over the leaves in
  the reference's order: the layer-stacked leaves of
  ``trainer/state_digest._jax_order``, each the sum of its layers' byte
  sums.  So it is the JAX ``host_digest`` of the same weights.
* :func:`device_digest` — the same fold on the swapped model's tensors
  through ``trainer/state_digest.digest_leaves`` (one launch of the
  byte-sum kernel on the card), which must reproduce the host digest.
* :func:`flip_param_bit` — the ``serve.swap`` seam's corruption: one
  mantissa bit flipped in the landed tensors (the reference's first leaf,
  element 0), a torn weight push only the digest compare can see.
"""

from __future__ import annotations

import re
import types
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.trainer import state_digest

#: Leading path components a training checkpoint may wrap params in: a
#: dict state ``{"params": ...}`` keystrs to ``['params']``, a dataclass
#: attribute to ``.params``.
_PARAMS_PREFIXES = ("['params']", ".params")

_COMPONENT = re.compile(r"^\[(?:'(.*)'|\"(.*)\"|(-?\d+))\]$|^\.(.+)$")


def _component(key: str) -> str:
    """One keystr path component's bare name (``['wi']`` -> ``wi``)."""
    m = _COMPONENT.match(key)
    if m is None:
        return key
    return next(g for g in m.groups() if g is not None)


def _path_name(path: Tuple[str, ...]) -> str:
    return ".".join(_component(k) for k in path)


def _state_of(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.state_dict(keep_vars=False))
    return dict(params)


def leaf_paths(params) -> List[Tuple[str, List[str]]]:
    """The reference's parameter leaves in its order, each as ``(its name,
    the port names that make it up)``: a layer-stacked leaf
    ``blocks.<rest>`` is made of ``blocks.<i>.<rest>`` in layer order,
    every other leaf of itself.  ``params``: a state dict or a model."""
    names = list(_state_of(params))
    present = set(names)
    out = []
    for name in state_digest._jax_order(names):
        if name in present:
            out.append((name, [name]))
            continue
        rest = name[len("blocks."):]
        members = []
        while f"blocks.{len(members)}.{rest}" in present:
            members.append(f"blocks.{len(members)}.{rest}")
        out.append((name, members))
    return out


def map_checkpoint_to_params(
    arrays: Mapping[Tuple[str, ...], Any], params
) -> Dict[str, torch.Tensor]:
    """``{name: source tensor}`` for every serving parameter, in the
    state dict's order.

    Raises ``ValueError`` naming the first parameter the checkpoint lacks
    or holds at another shape or dtype: the caller must refuse the swap
    rather than land a partial model.
    """
    by_name: Dict[str, Any] = {}
    for path, arr in arrays.items():
        path = tuple(path)
        by_name[_path_name(path)] = arr
        if len(path) > 1 and path[0] in _PARAMS_PREFIXES:
            by_name.setdefault(_path_name(path[1:]), arr)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _state_of(params).items():
        src = by_name.get(name)
        if src is None:
            raise ValueError(
                f"checkpoint holds no tensor for decode param {name} "
                f"(checkpoint paths: "
                f"{sorted(''.join(p) for p in arrays)[:8]}...)"
            )
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.asarray(src))
        if tuple(src.shape) != tuple(leaf.shape) or src.dtype != leaf.dtype:
            raise ValueError(
                f"decode param {name} drifted: checkpoint "
                f"{src.dtype}{tuple(src.shape)} vs serving "
                f"{leaf.dtype}{tuple(leaf.shape)} — a different model "
                "needs a new engine, not a hot-swap"
            )
        out[name] = src
    return out


def _host_byte_sum(t: torch.Tensor) -> int:
    """The raw bytes of ``t`` summed on the host (numpy)."""
    t = t.detach()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    flat = t.reshape(-1).contiguous().cpu().view(torch.uint8).numpy()
    return int(flat.sum(dtype=np.uint64))


def host_digest(sources: Mapping[str, torch.Tensor]) -> int:
    """The reference's ``host_digest`` of the same weights, on the host:
    per reference leaf the byte sum of its layers, mod 2^32, folded as
    ``acc = acc * 1000003 + leaf_sum`` (mod 2^32)."""
    acc = 0
    for _, members in leaf_paths(sources):
        leaf_sum = sum(_host_byte_sum(sources[m]) for m in members)
        acc = (acc * state_digest.MULTIPLIER
               + (leaf_sum & state_digest.MASK)) & state_digest.MASK
    return acc


def device_digest(model: torch.nn.Module) -> torch.Tensor:
    """The same fold over the model's own tensors, where they lie, as a
    0-d int64 tensor (``state_digest.digest_leaves``: one launch of the
    byte-sum kernel on a CUDA device)."""
    state = _state_of(model)
    order = leaf_paths(state)
    leaves = [state[m] for _, members in order for m in members]
    return state_digest.digest_leaves(
        leaves, groups=[len(members) for _, members in order])


def flip_param_bit(model: torch.nn.Module) -> torch.nn.Module:
    """Flip one mantissa bit (``state_digest.flip_mantissa_bit``'s) of the
    reference's first parameter leaf (element 0), in place in the model's
    tensors; returns ``model``."""
    state_digest.flip_mantissa_bit(types.SimpleNamespace(model=model))
    return model

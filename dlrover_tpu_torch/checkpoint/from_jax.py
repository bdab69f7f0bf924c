"""Restore a train state that the JAX package's ``Checkpointer`` wrote.

The files are the same format (``checkpoint/shm_handler.py``), so the
port's :class:`~dlrover_tpu_torch.checkpoint.engine.StorageStepReader`
reads and verifies them, the meta pickle through the unpickler that maps
the JAX package's three meta classes onto the port's (nothing of the JAX
stack is imported) and bf16 leaves, recorded as ``'<V2'``, as
``torch.bfloat16``.  The leaves are then taken by path: the parameters
(under ``.params`` of a flax ``TrainState``, or ``['params']`` of a plain
dict) become the port's state dict through
:func:`~dlrover_tpu_torch.models.from_jax.state_dict_from_jax`, and a
``q8_adam``/``q4_adam`` state (``.count``, ``.m``, ``.v``, quantized
leaves as ``.q`` and ``.scales``) comes across through
``low_bit_state_from_jax``.  Other optimizer states have no converter and
are left out (``opt_state`` None): the JAX Adafactor and AdamW states are
optax trees the port's optimizers do not share.
"""

from __future__ import annotations

import ast
import dataclasses
import types
from typing import Any, Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.checkpoint.engine import StorageStepReader
from dlrover_tpu_torch.common.storage import CheckpointStorage
from dlrover_tpu_torch.models.from_jax import (
    low_bit_state_from_jax,
    state_dict_from_jax,
)
from dlrover_tpu_torch.models.transformer import TransformerConfig
from dlrover_tpu_torch.optimizers import optax_ports as ox
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device

_PARAM_ROOTS = ((".params",), ("['params']",))


@dataclasses.dataclass
class JaxCheckpoint:
    """A restored JAX train state: ``params`` is the port's state dict on
    the device, ``opt_state`` the low-bit Adam state or None."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    extra: Dict[str, Any]


def _key(part: str):
    """A path element's key: ``['name']`` -> name, ``[3]`` -> 3, ``.attr``
    -> attr (``jax.tree_util.keystr``'s spellings)."""
    if part.startswith("."):
        return part[1:]
    return ast.literal_eval(part[1:-1])


def _numpy(t: torch.Tensor):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _nested(flat: Dict[Tuple[str, ...], torch.Tensor],
            prefix: Tuple[str, ...]) -> Dict[str, Any]:
    """The leaves under ``prefix`` as nested dicts of numpy arrays; a
    quantized leaf's ``.q``/``.scales`` pair becomes one object with those
    attributes."""
    out: Dict[str, Any] = {}
    for path, tensor in flat.items():
        if path[:len(prefix)] != prefix:
            continue
        rest = path[len(prefix):]
        if rest and rest[-1] in (".q", ".scales"):
            node = out
            for part in rest[:-2]:
                node = node.setdefault(_key(part), {})
            pair = node.setdefault(_key(rest[-2]), types.SimpleNamespace())
            setattr(pair, _key(rest[-1]), _numpy(tensor))
            continue
        node = out
        for part in rest[:-1]:
            node = node.setdefault(_key(part), {})
        node[_key(rest[-1])] = _numpy(tensor)
    return out


def _low_bit_prefix(flat) -> Optional[Tuple[str, ...]]:
    """The path of a low-bit Adam state: the prefix whose ``.count``,
    ``.m`` and ``.v`` are all present."""
    for path in flat:
        if path[-1] == ".count":
            prefix = path[:-1]
            subs = {p[len(prefix)] for p in flat
                    if p[:len(prefix)] == prefix and len(p) > len(prefix)}
            if {".m", ".v"} <= subs:
                return prefix
    return None


def load_jax_checkpoint(
    checkpoint_dir: str,
    config: TransformerConfig,
    *,
    step: Optional[int] = None,
    storage: Optional[CheckpointStorage] = None,
    device: DeviceLike = None,
) -> Optional[JaxCheckpoint]:
    """The newest verified step (or ``step``) of a JAX checkpoint for the
    model ``config`` describes, on ``device``; None when none restores."""
    device = resolve_device(device)
    reader = StorageStepReader(checkpoint_dir, storage=storage, num_hosts=1,
                               device="cpu")
    found, flat = reader.load_from_storage(step=step)
    if found < 0:
        return None
    root = next((r for r in _PARAM_ROOTS
                 if any(p[:len(r)] == r for p in flat)), None)
    if root is None:
        raise KeyError(f"step {found} of {checkpoint_dir} holds no params")
    params = {k: v.to(device) for k, v in state_dict_from_jax(
        _nested(flat, root), config).items()}
    opt_state = None
    prefix = _low_bit_prefix(flat)
    if prefix is not None:
        state = types.SimpleNamespace(
            count=int(flat[prefix + (".count",)].item()),
            m=_nested(flat, prefix + (".m",)),
            v=_nested(flat, prefix + (".v",)))
        opt_state = low_bit_state_from_jax(state, ox.stack_layers(params))
    return JaxCheckpoint(step=found, params=params, opt_state=opt_state,
                         extra=dict(reader.last_restored_extra))

"""Map a ``dlrover_tpu`` parameter tree onto ``TransformerLM``'s state dict.

The input is the JAX model's unboxed parameter tree (``flax.linen.meta.
unbox`` of ``init(...)["params"]``) as nested dicts of numpy arrays; this
module needs neither JAX nor flax.  Kernel layouts are the same on both
sides, so the mapping is renaming plus un-stacking the scan-stacked
leading ``layers`` axis of ``blocks/...`` (``transformer.py:379-391``)
into ``blocks.<i>....``.  An unknown or missing key, or a shape that does
not match the config, raises: nothing is numbered by guesswork.  Floating
leaves are cast to the config's ``param_dtype``, the dtype the port's model
holds them in.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.models.transformer import (
    TransformerConfig,
    param_shapes,
)


def _flatten(tree: Mapping[str, Any],
             prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                             Any]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_jax(
    params_np: Mapping[str, Any], config: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """``{name: CPU tensor in config.param_dtype}`` for
    ``TransformerLM(config).load_state_dict``."""
    expected = param_shapes(config)
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params_np):
        arr = np.asarray(leaf)
        if path[0] == "blocks":
            if arr.shape[:1] != (config.num_layers,):
                raise ValueError(
                    f"{'/'.join(path)}: leading layers axis {arr.shape[:1]} "
                    f"!= num_layers {config.num_layers}"
                )
            items = [
                (".".join(("blocks", str(i)) + path[1:]), arr[i])
                for i in range(config.num_layers)
            ]
        else:
            items = [(".".join(path), arr)]
        for name, value in items:
            if name not in expected:
                raise KeyError(
                    f"JAX parameter {'/'.join(path)} has no counterpart "
                    f"{name!r} in the port's TransformerLM"
                )
            if tuple(value.shape) != expected[name]:
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} != expected "
                    f"{expected[name]}"
                )
            tensor = torch.from_numpy(np.array(value, copy=True))
            if tensor.is_floating_point():
                tensor = tensor.to(config.param_dtype)
            out[name] = tensor
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"JAX tree lacks parameters: {missing}")
    return out

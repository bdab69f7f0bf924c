"""Map a ``dlrover_tpu`` parameter tree onto ``TransformerLM``'s state dict.

The input is the JAX model's unboxed parameter tree (``flax.linen.meta.
unbox`` of ``init(...)["params"]``) as nested dicts of numpy arrays; this
module needs neither JAX nor flax.  Kernel layouts are the same on both
sides (a ``wo_transposed`` MLP's ``wo`` is ``[d_model, d_ff]`` in both),
so the mapping is renaming plus un-stacking the scan-stacked leading
``layers`` axis of ``blocks/...`` (``transformer.py:379-391``) into
``blocks.<i>....`` (an MoE block's ``moe/router/kernel`` ``[L, d, E]``
and ``moe/wi``, ``moe/wo``, ``moe/wg`` ``[L, E, ., .]`` included); the
unstacked ``block_<i>/...`` trees of ``scan_layers=False`` map onto the
same names, and so does the pipelined tree of ``pipeline_stages > 1``,
``blocks/ticks/stages/layers/...`` ``[S, L / S, ...]`` (the reference's
``parallel/pipeline.py``): stage ``s``'s layer ``j`` is ``blocks.<s L / S
+ j>``.
An unknown or missing key, or a shape that does
not match the config, raises: nothing is numbered by guesswork.  Floating
leaves are cast to the config's ``param_dtype``, the dtype the port's model
holds them in.

:func:`shard_state_dict` cuts such a whole state dict to one rank's boxes
under the fsdp and tensor axes (``parallel/sharding.py``), and gives a
pipe rank its stage's layers.

:func:`low_bit_state_from_jax` carries a ``q8_adam``/``q4_adam`` optimizer
state across the same way, dropping the TPU layout padding of its arrays.
:func:`rec_dense_from_jax` carries the CTR example's dense parameters
across (the embedding plane's state needs no conversion: the port's
``ShardedEmbeddingTable.restore`` reads the JAX plane's exports).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.models.transformer import (
    TransformerConfig,
    param_shapes,
)
from dlrover_tpu_torch.ops import quantization

_BLOCK_I = re.compile(r"^block_(\d+)$")
_LAYER = re.compile(r"^blocks\.(\d+)\.")
#: The pipelined stack's path prefix.
_STAGES = ("blocks", "ticks", "stages", "layers")


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
        unstacked = _BLOCK_I.match(path[0])
        if unstacked:
            # scan_layers=False: one tree a layer, named block_<i>.
            items = [(".".join(("blocks", unstacked.group(1)) + path[1:]),
                      arr)]
        elif path[:4] == _STAGES:
            # [S, L / S, ...]: the stages' layers in order.
            if arr.ndim < 2 or arr.shape[0] * arr.shape[1] != \
                    config.num_layers:
                raise ValueError(
                    f"{'/'.join(path)}: stage and layer axes "
                    f"{arr.shape[:2]} do not hold num_layers "
                    f"{config.num_layers}")
            arr = arr.reshape((config.num_layers,) + arr.shape[2:])
            items = [
                (".".join(("blocks", str(i)) + path[4:]), arr[i])
                for i in range(config.num_layers)
            ]
        elif path[0] == "blocks":
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


def shard_state_dict(state: Mapping[str, Any], layouts: Mapping[str, Any],
                     parallel) -> Dict[str, torch.Tensor]:
    """A whole state dict (``state_dict_from_jax``'s, or ``init_params``')
    cut to one rank's boxes: ``layouts`` is ``{name: parallel.sharding.
    LeafSplit}`` (a model's ``layouts``) and ``parallel`` the rank's
    ``ModelParallel`` (its axis sizes and coordinates).  Each box is a
    contiguous tensor on the whole leaf's device.  On a pipe axis the rank
    takes the layers of its stage (``parallel.pipe``) and drops the
    others'."""
    out: Dict[str, torch.Tensor] = {}
    held = None
    if parallel.pipe is not None:
        layers = 1 + max((int(m.group(1)) for m in map(_LAYER.match, state)
                          if m), default=-1)
        held = parallel.pipe.layers(layers)
    for name, value in state.items():
        m = _LAYER.match(name)
        if held is not None and m and int(m.group(1)) not in held:
            continue
        if name not in layouts:
            raise KeyError(f"{name!r} has no layout")
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
            np.asarray(value))
        lay = layouts[name]
        if tuple(t.shape) != tuple(lay.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != the whole "
                             f"leaf's {tuple(lay.shape)}")
        out[name] = lay.take(t, parallel.coords, parallel.sizes).contiguous()
    missing = sorted(set(layouts) - set(out))
    if missing:
        raise KeyError(f"state dict lacks parameters: {missing}")
    return out


def low_bit_state_from_jax(state: Any, params: Mapping[str, torch.Tensor]):
    """A JAX ``Q8AdamState``/``Q4AdamState`` as numpy (``count``, and ``m``
    and ``v`` as the parameter tree's nested dicts, each leaf an fp32 array
    or a ``(q, scales)`` pair) -> the port's state for ``params``, the
    layer-stacked parameter tree the port's optimizer sees (``{"blocks.
    <rest>": [layers, ...], ...}``), on the parameters' device.

    The JAX arrays carry TPU layout padding: ``q`` is ``[R_pad, 256]``
    (q4: ``[R_pad, 128]``) with rows padded to a multiple of 8 or 512, and
    ``scales`` is one value broadcast over 128 (q4: 8) lanes.  The rows
    past ``ceil(n / 256)`` and every lane but the first are dropped."""
    def moments(tree):
        out = {}
        for path, leaf in _flatten(tree):
            name = ".".join(path)
            if name not in params:
                raise KeyError(
                    f"JAX optimizer state {'/'.join(path)} has no "
                    f"counterpart {name!r} in the port's parameter tree")
            p = params[name]
            if hasattr(leaf, "q") and hasattr(leaf, "scales"):
                rows = quantization.num_blocks(p.numel())
                q, scales = np.asarray(leaf.q), np.asarray(leaf.scales)
                if q.shape[0] < rows or scales.shape[0] < rows:
                    raise ValueError(
                        f"{name}: {q.shape[0]} quantized rows for "
                        f"{p.numel()} values ({rows} blocks)")
                out[name] = quantization.QMoment(
                    torch.from_numpy(np.array(q[:rows], copy=True)).to(
                        p.device),
                    torch.from_numpy(np.array(scales[:rows, 0], copy=True)
                                     ).to(p.device))
            else:
                arr = np.asarray(leaf)
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{name}: moment shape {tuple(arr.shape)} != "
                        f"parameter shape {tuple(p.shape)}")
                out[name] = torch.from_numpy(np.array(arr, copy=True)).to(
                    p.device)
        missing = sorted(set(params) - set(out))
        if missing:
            raise KeyError(f"JAX optimizer state lacks leaves: {missing}")
        return out

    m, v = moments(state.m), moments(state.v)
    packed = {mom.q.shape[1] for mom in m.values()
              if isinstance(mom, quantization.QMoment)}
    if packed - {quantization.BLOCK, quantization.BLOCK // 2} or len(
            packed) > 1:
        raise ValueError(f"quantized moments of widths {sorted(packed)}")
    cls = (quantization.Q4AdamState
           if packed == {quantization.BLOCK // 2}
           else quantization.Q8AdamState)
    return cls(int(state.count), m, v)


def rec_dense_from_jax(dense_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The CTR example's dense dict (``examples/train_rec.py``: ``w1``
    ``[dim * fields, hidden]``, ``b1`` ``[hidden]``, ``w2`` ``[hidden, 1]``,
    ``b2`` ``[1]``, numpy) -> fp32 CPU tensors for
    ``dlrover_tpu_torch.examples.train_rec.run(dense=...)``."""
    want = ("w1", "b1", "w2", "b2")
    if set(dense_np) != set(want):
        raise KeyError(
            f"dense params {sorted(dense_np)} are not {sorted(want)}")
    out = {k: torch.from_numpy(np.array(dense_np[k], np.float32, copy=True))
           for k in want}
    width, hidden = tuple(out["w1"].shape) + (0,) * (2 - out["w1"].dim())
    shapes = {"w1": (width, hidden), "b1": (hidden,), "w2": (hidden, 1),
              "b2": (1,)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise ValueError(
                f"{k}: shape {tuple(out[k].shape)} != expected {shape}")
    return out

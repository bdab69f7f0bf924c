"""The train step on one device (port of
``dlrover_tpu/trainer/train_lib.py``).

``build_train`` is the single-device counterpart of the JAX
``build_sharded_train``: the same arguments and the same step.  The loss
is the token-weighted cross entropy normalised by the *global* token
count (with ``grad_accum`` microbatches each microbatch's CE sum is
divided by the whole batch's weight, so the accumulated gradient equals
the full-batch gradient), plus the model's aux loss; the gradient's
global norm is reported before clipping; the optimizer is a hand port of
the optax chain ``make_optimizer`` builds (``optimizers/optax_ports.py``)
applied to the JAX-shaped, layer-stacked parameter tree.  Metrics carry
the JAX names: ``loss``, ``aux_loss``, ``tokens``, ``grad_norm``,
``step``.  MoE configs (``num_experts > 0``) train through the same step:
``aux_loss`` is the blocks' load-balancing loss times ``moe_aux_weight``,
and the expert kernels ``[E, ., .]`` stack to ``[layers, E, ., .]``
leaves.

``make_optimizer`` builds ``adamw``, ``adafactor`` and the low-bit
``q8_adam``/``q4_adam`` (``ops/quantization.py``, whose per-leaf update is
one CUDA kernel on the card).

``shard_batch`` places a host batch on the train's device in the dtypes
``Train._batch`` takes (pinned, ``non_blocking`` on the card), so the step
passes it through with no copy; ``elastic_grad_accum`` is the elastic
trainer's microbatch accounting.

Not ported yet, and refused when asked for: a device mesh and logical
sharding rules, ZeRO-1, the overlap engine and the int8 gradient reduce
(ROADMAP Queue 1 item 4), and the ``sgd``, ``lion`` and ``agd``
optimizers (Queue 1 item 6).

PyTorch updates in place: ``step`` mutates the state it is given (the
JAX step donated it) and returns it.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_params,
)
from dlrover_tpu_torch.ops import quantization
from dlrover_tpu_torch.optimizers import optax_ports as ox
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device

_ACCUM_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def make_schedule(learning_rate: float, warmup_steps: int = 0,
                  decay_steps: int = 0) -> ox.ScalarOrSchedule:
    """The LR schedule ``make_optimizer`` installs (a float when
    constant)."""
    if warmup_steps and not decay_steps:
        # Warmup-only: ramp to peak then hold.
        return ox.linear_schedule(0.0, learning_rate, max(1, warmup_steps))
    if warmup_steps or decay_steps:
        return ox.warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=learning_rate,
            warmup_steps=max(1, warmup_steps),
            decay_steps=max(decay_steps, warmup_steps + 1),
            end_value=learning_rate * 0.1,
        )
    return learning_rate


def make_optimizer(
    name: str = "adamw",
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    **kwargs,
) -> ox.GradientTransformation:
    """``adamw``, ``adafactor``, ``q8_adam`` or ``q4_adam`` behind an
    optional global-norm clip, as the JAX ``make_optimizer`` composes
    them."""
    schedule = make_schedule(learning_rate, warmup_steps, decay_steps)
    if name == "adamw":
        opt = ox.adamw(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                       **kwargs)
    elif name == "adafactor":
        opt = ox.adafactor(schedule)
    elif name in ("q8_adam", "q4_adam"):
        low_bit = (quantization.q8_adam if name == "q8_adam"
                   else quantization.q4_adam)
        opt = low_bit(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                      **kwargs)
    elif name in ("sgd", "lion", "agd"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP Queue 1 item "
            "6); the training slice has adamw, adafactor, q8_adam and "
            "q4_adam"
        )
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if grad_clip:
        opt = ox.chain(ox.clip_by_global_norm(grad_clip), opt)
    return opt


def _token_loss(logits32: torch.Tensor, targets: torch.Tensor,
                z_loss: float) -> torch.Tensor:
    log_z = torch.logsumexp(logits32, dim=-1)
    label = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
    loss = log_z - label
    if z_loss:
        loss = loss + z_loss * log_z.square()
    return loss


def cross_entropy_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level softmax CE in fp32; returns ``(mean_loss,
    num_tokens)``."""
    loss = _token_loss(logits.float(), targets, z_loss)
    if weights is None:
        weights = torch.ones_like(loss)
    weights = weights.float()
    total_weight = torch.clamp(weights.sum(), min=1.0)
    return (loss * weights).sum() / total_weight, total_weight


def chunked_cross_entropy_loss(
    hidden: torch.Tensor,
    head: torch.Tensor,
    targets: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    num_chunks: int = 8,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax CE from final hidden states ``[B, S, D]`` and the output
    head ``[V, D]`` without holding the ``[B, S, V]`` fp32 logits: each
    sequence chunk's logits are computed inside a checkpoint, so the
    backward recomputes them."""
    b, s, _ = hidden.shape
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32,
                             device=hidden.device)
    num_chunks = max(1, min(num_chunks, s))
    while s % num_chunks:
        num_chunks -= 1
    c = s // num_chunks

    def chunk_sum(x_c, t_c, w_c):
        # bf16 products accumulated and returned in fp32, as the JAX
        # einsum's preferred_element_type=float32: both operands upcast
        # (a bf16 product is exact in fp32), on every device.
        logits = x_c.to(head.dtype).float() @ head.float().t()
        return (_token_loss(logits, t_c, z_loss) * w_c.float()).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(num_chunks):
        sl = slice(i * c, (i + 1) * c)
        args = (hidden[:, sl], targets[:, sl], weights[:, sl])
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_sum, *args, use_reentrant=False)
        else:
            total = total + chunk_sum(*args)
    total_weight = torch.clamp(weights.float().sum(), min=1.0)
    return total / total_weight, total_weight


def output_head(model: TransformerLM) -> torch.Tensor:
    """``[V, D]`` output projection: the tied embedding table, or the
    ``lm_head`` kernel transposed."""
    if hasattr(model, "lm_head"):
        kernel = model.lm_head.kernel  # [D, V]
        return kernel.reshape(kernel.shape[0], -1).t()
    return model.embed.embedding


@dataclasses.dataclass
class TrainState:
    """``step`` / the model (holding the params) / ``opt_state``."""

    step: int
    model: TransformerLM
    opt_state: Any

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def checkpoint_tree(self) -> Dict[str, Any]:
        """What Flash Checkpoint saves of the state (``checkpoint/``; the
        step rides in the checkpoint's meta): ``{"params": the state dict,
        "opt_state": the optimizer state}``, views of the live tensors."""
        return {"params": self.params(), "opt_state": self.opt_state}


@dataclasses.dataclass
class Train:
    """The training program on one device: ``init``, ``step`` and
    ``eval_step`` for one (config, optimizer, batch shape)."""

    config: TransformerConfig
    optimizer: ox.GradientTransformation
    device: torch.device
    global_batch_size: int
    seq_len: int
    ce_chunks: int = 0
    grad_accum: int = 1
    accum_dtype: str = "float32"

    def init(self, seed: int = 0,
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> TrainState:
        """A fresh state: parameters from ``init_params(seed)`` (or the
        given state dict, e.g. ``state_dict_from_jax``), optimizer state
        from the optimizer's ``init``."""
        model = TransformerLM(self.config, self.device)
        if params is None:
            params = init_params(self.config, seed=seed, device=self.device)
        model.load_state_dict(params)
        model.train()
        with torch.no_grad():
            opt_state = self.optimizer.init(_param_tree(model))
        return TrainState(step=0, model=model, opt_state=opt_state)

    def restore(self, step: int, tree: Mapping[str, Any]) -> TrainState:
        """The state a restored checkpoint tree (``TrainState.
        checkpoint_tree``'s layout, e.g. ``Checkpointer.load_checkpoint``
        with a fresh state's tree as the template) describes."""
        state = self.init(params=tree["params"])
        state.opt_state = tree["opt_state"]
        state.step = step
        return state

    # -- one step -------------------------------------------------------------

    def _batch(self, batch: Mapping[str, Any]):
        def dev(x, dtype):
            return torch.as_tensor(x, device=self.device).to(dtype)

        inputs = dev(batch["inputs"], torch.long)
        targets = dev(batch["targets"], torch.long)
        if batch.get("weights") is None:
            weights = torch.ones(targets.shape, dtype=torch.float32,
                                 device=self.device)
        else:
            weights = dev(batch["weights"], torch.float32)
        if tuple(inputs.shape) != (self.global_batch_size, self.seq_len):
            raise ValueError(
                f"batch inputs {tuple(inputs.shape)} != (global_batch_size, "
                f"seq_len) = {(self.global_batch_size, self.seq_len)}"
            )
        return inputs, targets, weights

    def _forward_sums(self, model, inputs, targets, weights):
        """One forward pass -> (weighted CE sum, token count, aux loss)."""
        if self.ce_chunks:
            hidden, aux = model.forward_aux(inputs, return_hidden=True)
            ce, total_weight = chunked_cross_entropy_loss(
                hidden, output_head(model), targets, weights,
                num_chunks=self.ce_chunks,
            )
        else:
            logits, aux = model.forward_aux(inputs)
            ce, total_weight = cross_entropy_loss(logits, targets, weights)
        return ce * total_weight, total_weight, aux

    def step(self, state: TrainState, batch: Mapping[str, Any]
             ) -> Tuple[TrainState, Dict[str, Any]]:
        """One optimizer step on ``batch`` (``inputs``/``targets`` int
        ``[global_batch, seq_len]``, optional fp ``weights``)."""
        model = state.model
        inputs, targets, weights = self._batch(batch)
        named = dict(model.named_parameters())
        for p in named.values():
            p.grad = None
        if self.grad_accum == 1:
            ce_sum, total_weight, aux = self._forward_sums(
                model, inputs, targets, weights)
            ce = ce_sum / total_weight
            (ce + aux).backward()
            grads = {k: _grad(p) for k, p in named.items()}
            loss, aux_loss = ce.detach(), aux.detach()
        else:
            grads, loss, aux_loss, total_weight = self._accumulate(
                model, named, inputs, targets, weights)
        with torch.no_grad():
            # The stacked copies cost less than per-layer trees: those ran
            # 30x more small launches, a 16% slower GPT-2 1.5B step on an
            # H100, and no lower peak memory (PERF.md).
            grad_tree = ox.stack_layers(grads)
            del grads
            for p in named.values():
                p.grad = None
            grad_norm = ox.global_norm(grad_tree)
            updates, state.opt_state = self.optimizer.update(
                grad_tree, state.opt_state, _param_tree(model))
            del grad_tree
            for name, u in ox.unstack_layers(updates).items():
                p = named[name]
                p.copy_(p + u)  # optax.apply_updates, in the param dtype
        state.step += 1
        metrics = {
            "loss": loss,
            "aux_loss": aux_loss,
            "tokens": total_weight.detach(),
            "grad_norm": grad_norm,
            "step": state.step,
        }
        return state, metrics

    def _accumulate(self, model, named, inputs, targets, weights):
        """``grad_accum`` microbatches, gradients summed in
        ``accum_dtype`` and handed to the optimizer in the params'
        dtype."""
        n = self.grad_accum
        micro = self.global_batch_size // n
        accum_dtype = _ACCUM_DTYPES[self.accum_dtype]
        w_total = torch.clamp(weights.float().sum(), min=1.0)
        acc = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
               for k, p in named.items()}
        ce_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        aux_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(n):
            sl = slice(i * micro, (i + 1) * micro)
            ce_sum, _, aux = self._forward_sums(
                model, inputs[sl], targets[sl], weights[sl])
            (ce_sum / w_total + aux / n).backward()
            with torch.no_grad():
                for k, p in named.items():
                    acc[k] += _grad(p).to(accum_dtype)
                    p.grad = None
                ce_acc += ce_sum.detach()
                aux_acc += aux.detach()
        grads = {k: acc[k].to(p.dtype) for k, p in named.items()}
        return grads, ce_acc / w_total, aux_acc / n, w_total

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Mapping[str, Any]
                  ) -> Dict[str, torch.Tensor]:
        """Forward-only loss on one batch -> ``{"loss", "aux_loss",
        "tokens"}``."""
        inputs, targets, weights = self._batch(batch)
        ce_sum, total_weight, aux = self._forward_sums(
            state.model, inputs, targets, weights)
        return {"loss": ce_sum / total_weight, "aux_loss": aux,
                "tokens": total_weight}


def _grad(p: torch.Tensor) -> torch.Tensor:
    """A parameter's gradient; zeros where the loss does not reach it, as
    ``jax.grad`` gives."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _param_tree(model: TransformerLM) -> ox.Tree:
    """The JAX-shaped parameter tree: block parameters stacked over
    layers."""
    return ox.stack_layers(
        {k: p.detach() for k, p in model.named_parameters()})


def build_train(
    config: TransformerConfig,
    optimizer: ox.GradientTransformation,
    *,
    global_batch_size: int,
    seq_len: int,
    ce_chunks: int = 0,
    grad_accum: int = 1,
    accum_dtype: str = "float32",
    reduce_quant: str = "none",
    zero1: bool = False,
    overlap: bool = False,
    mesh: Any = None,
    rules: Any = None,
    device: DeviceLike = None,
) -> Train:
    """The single-device counterpart of ``build_sharded_train``."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "a device mesh and sharding rules are a later slice of the port "
            "(ROADMAP Queue 1 item 4)"
        )
    if zero1 or overlap or reduce_quant != "none":
        raise NotImplementedError(
            "zero1, overlap and reduce_quant are later slices of the port "
            "(ROADMAP Queue 1 item 4)"
        )
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if accum_dtype not in _ACCUM_DTYPES:
        raise ValueError(
            f"accum_dtype {accum_dtype!r} not in {sorted(_ACCUM_DTYPES)}"
        )
    if global_batch_size % grad_accum:
        raise ValueError(
            f"global_batch_size {global_batch_size} must be divisible by "
            f"grad_accum {grad_accum}"
        )
    if config.decode:
        raise ValueError("training takes a config with decode=False")
    return Train(
        config=config, optimizer=optimizer, device=resolve_device(device),
        global_batch_size=global_batch_size, seq_len=seq_len,
        ce_chunks=ce_chunks, grad_accum=grad_accum, accum_dtype=accum_dtype,
    )


def elastic_grad_accum(
    ref_accum: int,
    ref_world: int,
    world: int,
    global_batch_size: int,
    dp: int,
) -> int:
    """Rescale grad_accum for a resized world, tokens/step invariant.

    The global batch (hence tokens/step and the optimizer trajectory) is a
    property of the step, not the world; what a resize changes is the
    per-device working set.  Scaling N by ``ref_world / world`` keeps each
    microbatch's per-device rows (so activation memory) about constant:
    half the devices, twice the microbatches, same step semantics.  The
    target is snapped to the nearest feasible N (one that keeps every
    microbatch divisible over the ``dp``-way batch split), preferring the
    next LARGER feasible N so the reference per-microbatch memory budget
    is never exceeded.
    """
    world = max(1, world)
    ref_world = max(1, ref_world) or world
    target = max(1, int(round(ref_accum * ref_world / world)))
    per_shard = max(1, global_batch_size // max(1, dp))
    feasible = [
        n for n in range(1, per_shard + 1)
        if global_batch_size % (max(1, dp) * n) == 0
    ]
    if not feasible:
        return 1
    larger = [n for n in feasible if n >= target]
    return min(larger) if larger else max(feasible)


#: The dtypes ``Train._batch`` takes; other keys keep their own.
BATCH_DTYPES = {"inputs": torch.long, "targets": torch.long,
                "weights": torch.float32}


def _on_device(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def shard_batch(batch: Mapping[str, Any], train: Train
                ) -> Dict[str, torch.Tensor]:
    """Place a host batch on ``train``'s device the way ``Train._batch``
    takes it: ``inputs``/``targets`` int64, ``weights`` fp32 (all-ones
    when absent, made on the device).  A tensor already on the device in
    its dtype passes through untouched (no copy, no "place" event), so
    the trainer hands prefetched batches back through this function.

    On the CPU this is a plain move.  On the card each host array is
    converted on the host, pinned and copied with ``non_blocking=True``
    on the current stream (``data.loader.DevicePrefetcher`` makes that
    its copy stream), so placing never waits for the device; a failure
    to pin or to copy raises.
    """
    device = train.device
    out: Dict[str, torch.Tensor] = {}
    placed_any = False
    t0 = time.perf_counter()
    for key, value in batch.items():
        if value is None:
            continue
        dtype = BATCH_DTYPES.get(key)
        if isinstance(value, torch.Tensor) and _on_device(value, device) \
                and (dtype is None or value.dtype == dtype):
            out[key] = value  # already placed (prefetched): passthrough
            continue
        placed_any = True
        host = (value if isinstance(value, torch.Tensor)
                else torch.as_tensor(np.asarray(value)))
        if dtype is not None:
            host = host.to(dtype)
        if device.type == "cuda" and not host.is_cuda:
            host = host.pin_memory().to(device, non_blocking=True)
        else:
            host = host.to(device)
        out[key] = host
    if "weights" not in out:
        out["weights"] = torch.ones(tuple(out["targets"].shape),
                                    dtype=torch.float32, device=device)
    if placed_any:
        from dlrover_tpu_torch.utils.profiler import pipeline_counters

        pipeline_counters().record_place(time.perf_counter() - t0)
    return out

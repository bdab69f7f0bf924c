"""Decoder-only Transformer LM (port of ``dlrover_tpu/models/transformer.py``).

One model covers GPT-2 (learned positions, LayerNorm, GELU, biases, tied
head) and Llama (RoPE, RMSNorm, SwiGLU, GQA, untied head).  The JAX model
stacks its layers under ``nn.scan``; here they are a plain Python loop
over ``blocks``, and parameter names follow the JAX tree with the stacked
``layers`` axis unrolled into ``blocks.<i>`` (``models/from_jax.py``).

Training: parameters are trainable and held in ``param_dtype`` (cast to
``dtype`` at use), each block runs under its ``remat`` policy (every
name of ``ops/remat_policy.py``'s registry and ``offload:<names>``; the
block emits the reference's sites ``qkv_proj``, ``attn_out``,
``mlp_wo``, ``mlp_out`` and, under flash, ``flash_out``/``flash_lse``),
and
:meth:`TransformerLM.forward_aux` returns what the JAX model's
``__call__`` returns, ``(logits or hidden, aux_loss)``: the blocks' MoE
aux losses summed and scaled by ``moe_aux_weight`` (0 for a dense model).

With ``num_experts > 0`` each block's MLP is a :class:`~dlrover_tpu_torch.
models.moe.MoEMlp` named ``moe``, as in the JAX ``Block``; at more than
one batch rank or on an expert axis it gets the mesh's
``parallel/sharding.ExpertGroup`` (on the expert axis a rank holds its
experts, and the router's means are taken over the batch group).

Two opt-in flags of the dense step, both off by default as in JAX:
``fused_ln`` gives the blocks' norms (not ``ln_final``) the one-pass
backward kernel of ``ops/fused_norm.py``, and ``pin_attn_layouts`` puts
``ops/layout_pin.pin_layout`` before and after each block's attention.

The fsdp and tensor axes: ``TransformerLM(config, device, parallel=
parallel.sharding.ModelParallel(mesh, rules, wires))`` builds this rank's
part of the model.  Under ``tensor`` the layers hold their local heads,
MLP columns and vocabulary rows (``models/layers.py``); under ``fsdp``
each parameter holds its slice of its ``embed`` dimension, and each
block's slices are gathered for its forward (and again for a remat
policy's recompute) and its gradients reduce-scattered in its backward;
the leaves outside the blocks are gathered once a forward
(:meth:`TransformerLM.gathered`, ``parallel/sharding.FsdpUnit``).
Under ``seq`` a rank runs its slice of every sequence, at the global
positions ``offset + arange(S / sp)`` (RoPE and the learned positions
read them), every parameter whole, and each block's attention through
``models/attention.ulysses_attention`` (or, under ``attention_impl=
"ring"``, ``parallel/ring_attention.ring_attention``).

With ``pipeline_stages > 1`` the blocks run as a pipeline of stages
(``parallel/pipeline.PipelinedBlocks``, GPipe or, with a
``pipeline_interleave``, the circular schedule), ``num_microbatches``
microbatches a forward.  On a ``pipe`` axis (one stage a pipe rank) the
model holds its stage's blocks (``blocks`` is then keyed by the global
layer index, so the state dict's names are the whole model's) and every
leaf outside them: the first stage embeds, the last stage runs the final
norm and the head (:attr:`TransformerLM.last_stage`); on the other
stages the forward returns a 0-d zero tied to the schedule.

:func:`check_parallel` refuses a config whose heads, KV heads, ``d_ff``
or vocabulary do not divide by the tensor degree, whose heads do not
divide by ``seq x tensor`` or whose KV heads per tensor rank do not
divide by the seq degree (Ulysses), whose ``d_model``
does not divide by the fsdp degree or whose experts do not divide by the
expert degree, an MoE config on the fsdp, tensor or seq axis
(ROADMAP Queue 1 item 6's remainder), and a pipe axis beside fsdp, seq
or expert, or one whose degree is not the config's stage count (item 9's
remainder).  An MoE config under pipelining is refused as the reference
refuses it (``parallel/pipeline.validate``).  :func:`param_logical_axes`
gives
every parameter's logical axes, the reference's ``kernel_axes``.

The config has every field of the reference's.  ``scan_layers`` only
names the JAX tree ``models/from_jax.py`` reads (stacked, or
``block_<i>``), ``scan_unroll`` is an XLA scheduling knob with nothing
to do in eager PyTorch, and ``wo_transposed`` stores the MLP's ``wo``
kernel ``[d_model, d_ff]`` with the axes ``(embed, mlp)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.models import layers
from dlrover_tpu_torch.models.attention import Attention, KVCache
from dlrover_tpu_torch.models import moe as moe_lib
from dlrover_tpu_torch.models.moe import MoEMlp
from dlrover_tpu_torch.ops import remat_policy
from dlrover_tpu_torch.ops.layout_pin import pin_layout
from dlrover_tpu_torch.parallel import pipeline as pipeline_lib
from dlrover_tpu_torch.parallel import rules as lr
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 0          # 0 -> same as num_heads (no GQA)
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 0                  # 0 -> 4*d_model (gelu) or 8/3*d_model (swiglu)
    max_seq_len: int = 1024
    position: str = "learned"      # "learned" (GPT-2) | "rope" (Llama)
    norm: str = "layernorm"        # "layernorm" | "rmsnorm"
    activation: str = "gelu"       # "gelu" | "swiglu"
    rope_theta: float = 10000.0
    use_bias: bool = True          # GPT-2 uses biases, Llama does not
    tie_embeddings: bool = True
    # MoE
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "einsum"   # "einsum" | "a2a" | "a2a_int8" (the
                                   # einsum without an expert axis) |
                                   # "grouped"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "xla"    # "xla" | "flash" | "ring"
    fused_qkv: bool = True         # one [d, H, 3*hd] kernel when no GQA
    # JAX's Pallas blocks; here they choose the flash backward kernel
    # (fused when the kv sequence fits one clamped block_kv, else split).
    flash_block_q: int = 1024
    flash_block_kv: int = 1024
    # Dense row-major copies of the attention's input and output, forward
    # and on the cotangent (ops/layout_pin.py).
    pin_attn_layouts: bool = False
    # One-pass LayerNorm/RMSNorm backward kernel for the blocks' norms
    # (ops/fused_norm.py).
    fused_ln: bool = False
    # Store the MLP wo kernel transposed [d_model, d_ff] (a
    # checkpoint-format change when True, as in the reference).
    wo_transposed: bool = False
    remat: str = "none"            # a registered ops/remat_policy.py name
                                   # or a selective "offload:<names>" list
    # The reference's layer stacking: True stacks the layers' parameters
    # under nn.scan ("blocks", a leading layers axis), False names them
    # "block_<i>".  Here the blocks are a Python loop either way; the
    # field picks the JAX tree models/from_jax.py reads.
    scan_layers: bool = True
    # Layers per scan iteration: an XLA scheduling knob of the
    # reference; eager PyTorch has no scan to unroll, so it changes
    # nothing here.
    scan_unroll: int = 1
    logits_dtype: torch.dtype = torch.float32
    logit_scale: float = 1.0       # the µP output multiplier
                                   # (optimizers/mup.py)
    # The pipeline (parallel/pipeline.py): stages, and the microbatches a
    # forward streams through them (0: as many as stages).
    pipeline_stages: int = 1
    num_microbatches: int = 0
    # Decode mode: attention reads and writes a KV cache that the caller
    # passes in ([B, max_seq_len, H_kv, hd] per layer); same parameters.
    decode: bool = False
    # The circular pipeline schedule's layer chunks per stage: v > 1
    # sends each microbatch v laps around the stages (vM + S - 1 ticks).
    pipeline_interleave: int = 1

    @property
    def resolved_kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_d_ff(self) -> int:
        if self.d_ff:
            return self.d_ff
        if self.activation == "swiglu":
            return ((8 * self.d_model // 3) + 127) // 128 * 128
        return 4 * self.d_model

    def __post_init__(self):
        """The reference's validation, in its order."""
        if self.attention_impl not in ("xla", "flash", "ring"):
            raise ValueError(
                f"attention_impl must be 'xla', 'flash' or 'ring', got "
                f"{self.attention_impl!r}"
            )
        remat_policy.validate(self.remat, self.attention_impl)
        if self.decode:
            if self.attention_impl == "ring":
                raise ValueError(
                    "decode=True requires attention_impl='xla' or 'flash' "
                    "(got 'ring'); ring streams K/V over a sharded "
                    "sequence axis a decode cache does not have"
                )
            if self.pipeline_stages > 1:
                raise ValueError("decode=True requires pipeline_stages=1")
        if self.pipeline_interleave < 1:
            raise ValueError("pipeline_interleave must be >= 1")
        if self.pipeline_interleave > 1:
            if self.pipeline_stages <= 1:
                raise ValueError(
                    "pipeline_interleave > 1 requires pipeline_stages > 1"
                )
            chunks = self.pipeline_stages * self.pipeline_interleave
            if self.num_layers % chunks:
                raise ValueError(
                    f"num_layers {self.num_layers} not divisible by "
                    f"stages*interleave {chunks}"
                )
            micro = self.num_microbatches or self.pipeline_stages
            if micro < self.pipeline_stages:
                raise ValueError(
                    f"circular schedule needs microbatches >= stages "
                    f"(got {micro} < {self.pipeline_stages}): lap L of a "
                    "microbatch re-enters stage 0 only after lap L-1 "
                    "cleared the ring"
                )

    def check_device(self, device: torch.device) -> None:
        """Refuse what the card's flash kernels have no build for: under
        ``attention_impl="flash"`` on ``cuda``, a head dim above 128 (those
        below run zero-padded to 64 or 128) or a compute dtype other than
        bf16 (ROADMAP Queue 3 item 7).  Nothing is cast silently."""
        if device.type != "cuda" or self.attention_impl != "flash":
            return
        if self.resolved_head_dim > 128:
            raise NotImplementedError(
                f"attention_impl='flash' on cuda takes head dims up to 128, "
                f"got {self.resolved_head_dim} (ROADMAP Queue 3 item 7)")
        if self.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"attention_impl='flash' on cuda computes in bf16 only, got "
                f"dtype {self.dtype} (ROADMAP Queue 3 item 7)")


def check_parallel(cfg: "TransformerConfig", sizes: Dict[str, int]) -> None:
    """Refuse a config the fsdp, tensor, seq, expert and pipe axes cannot
    split evenly, naming the dimension (the sequence length is the step's:
    ``train_lib.build_train`` checks it against the seq degree)."""
    pipe = sizes.get("pipe", 1)
    if pipe > 1:
        beside = [a for a in ("fsdp", "seq", "expert") if sizes.get(a, 1) > 1]
        if beside:
            raise NotImplementedError(
                f"a pipe axis beside the {'/'.join(beside)} axis is a later "
                f"slice of the port (ROADMAP Queue 1 item 9's remainder); "
                f"pipe composes with data and tensor")
        if cfg.pipeline_stages != pipe:
            raise NotImplementedError(
                f"a pipe axis of {pipe} under pipeline_stages "
                f"{cfg.pipeline_stages}: the port runs one stage a pipe "
                f"rank; other foldings are a later slice of the port "
                f"(ROADMAP Queue 1 item 9's remainder)")
    model_axes = [a for a in ("fsdp", "tensor", "seq")
                  if sizes.get(a, 1) > 1]
    if model_axes and cfg.num_experts:
        raise NotImplementedError(
            f"an MoE model on the {'/'.join(model_axes)} axis is a later "
            f"slice of the port (ROADMAP Queue 1 item 6's remainder); MoE "
            f"takes the data and expert axes")
    if sizes.get("expert", 1) > 1 and cfg.num_experts and \
            cfg.moe_dispatch == "grouped":
        raise ValueError(
            "moe_dispatch='grouped' cannot shard over an expert axis; use "
            "'einsum', 'a2a' or 'a2a_int8' under expert parallelism")
    for what, n, axis in (("heads", cfg.num_heads, "tensor"),
                          ("KV heads", cfg.resolved_kv_heads, "tensor"),
                          ("d_ff", cfg.resolved_d_ff, "tensor"),
                          ("vocab_size", cfg.vocab_size, "tensor"),
                          ("d_model", cfg.d_model, "fsdp"),
                          ("num_experts", cfg.num_experts, "expert")):
        k = sizes.get(axis, 1)
        if n % k:
            raise ValueError(
                f"{what} {n} does not divide by the {axis} degree {k}")
    sp, tp = sizes.get("seq", 1), sizes.get("tensor", 1)
    if sp > 1 and cfg.attention_impl != "ring":
        # Ulysses splits each tensor rank's heads again over seq.
        if cfg.num_heads % (sp * tp):
            raise ValueError(
                f"heads {cfg.num_heads} do not divide by the seq x tensor "
                f"degree {sp} x {tp}")
        if (cfg.resolved_kv_heads // tp) % sp:
            raise ValueError(
                f"KV heads per tensor rank {cfg.resolved_kv_heads // tp} "
                f"do not divide by the seq degree {sp} (the all-to-all "
                f"splits them)")


class Mlp(nn.Module):
    """The dense MLP; its ``wo`` product is the remat sites ``mlp_wo``
    and ``mlp_out`` (one tensor, both names, as in the reference), its
    kernel stored ``[d_model, d_ff]`` under ``wo_transposed``."""

    def __init__(self, d_model: int, d_ff: int, activation: str,
                 use_bias: bool, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: DeviceLike = None,
                 tp=None, wo_transposed: bool = False):
        super().__init__()
        if activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.tp = tp
        if tp is not None:
            d_ff //= tp.size
        dense = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                     device=device)
        column = (lr.EMBED, lr.MLP)
        self.wi = layers.DenseGeneral(d_model, d_ff, kernel_axes=column,
                                      **dense)
        if activation == "swiglu":
            self.wg = layers.DenseGeneral(d_model, d_ff, kernel_axes=column,
                                          **dense)
        self.wo = layers.DenseGeneral(
            d_ff, d_model,
            kernel_axes=((lr.EMBED, lr.MLP) if wo_transposed
                         else (lr.MLP, lr.EMBED)),
            reduce=tp.exit if tp is not None else None,
            transpose_kernel=wo_transposed,
            save_name=("mlp_wo", "mlp_out"), **dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        h = self.wi(x)
        if self.activation == "swiglu":
            h = F.silu(self.wg(x)) * h
        else:
            # flax nn.gelu defaults to the tanh form.
            h = F.gelu(h, approximate="tanh")
        return self.wo(h)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 tp=None, moe_group=None, sp=None):
        super().__init__()
        self.pin_attn_layouts = cfg.pin_attn_layouts
        self.ln_attn = layers.make_norm(cfg.norm, cfg.d_model, device,
                                        cfg.param_dtype,
                                        fused_backward=cfg.fused_ln)
        self.attn = Attention(
            cfg.d_model,
            cfg.num_heads,
            cfg.resolved_kv_heads,
            cfg.resolved_head_dim,
            use_rope=cfg.position == "rope",
            rope_theta=cfg.rope_theta,
            use_bias=cfg.use_bias,
            dtype=cfg.dtype,
            param_dtype=cfg.param_dtype,
            attention_impl=cfg.attention_impl,
            fused_qkv=cfg.fused_qkv,
            flash_block_q=cfg.flash_block_q,
            flash_block_kv=cfg.flash_block_kv,
            tp=tp,
            sp=sp,
            device=device,
        )
        self.ln_mlp = layers.make_norm(cfg.norm, cfg.d_model, device,
                                       cfg.param_dtype,
                                       fused_backward=cfg.fused_ln)
        if cfg.num_experts:
            self.moe = MoEMlp(
                cfg.d_model, cfg.num_experts, cfg.resolved_d_ff,
                top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                activation=cfg.activation, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype, dispatch=cfg.moe_dispatch,
                group=moe_group, device=device,
            )
        else:
            self.mlp = Mlp(
                cfg.d_model, cfg.resolved_d_ff, cfg.activation, cfg.use_bias,
                cfg.dtype, cfg.param_dtype, device, tp=tp,
                wo_transposed=cfg.wo_transposed,
            )

    def forward(self, x, positions, segment_ids=None, cache=None):
        """``(x, aux)``: the block's output and its MoE aux loss (None for
        a dense block)."""
        if self.pin_attn_layouts:
            x = pin_layout(x)
        y = self.attn(self.ln_attn(x), positions, segment_ids, cache)
        if self.pin_attn_layouts:
            y = pin_layout(y)
        x = x + y
        y = self.ln_mlp(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(y)
            return x + y, aux
        return x + self.mlp(y), None


class TransformerLM(nn.Module):
    """Decoder-only LM: ``forward(tokens) -> logits [B, S, V]`` in
    ``logits_dtype``; :meth:`forward_aux` for training.  Parameters are
    allocated uninitialised on ``device``; load a state dict
    (:func:`init_params`, ``models.from_jax.state_dict_from_jax``) before
    use.  With ``parallel`` (``parallel/sharding.ModelParallel``) the
    model is this rank's part of it: the state dict holds its boxes of
    the whole leaves (``layouts``), the logits its vocabulary columns."""

    def __init__(self, config: TransformerConfig,
                 device: DeviceLike = None, parallel=None):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        cfg.check_device(device)
        self.config = cfg
        moe_group = (parallel.expert_group() if parallel is not None
                     and cfg.num_experts else None)
        self.parallel = parallel if parallel is not None and \
            parallel.active else None
        tp = self.parallel.tp if self.parallel is not None else None
        self.tp = tp
        #: The seq axis (``parallel/sharding.SeqGroup``), None at 1.
        self.sp = parallel.sp if parallel is not None else None
        fsdp = self.parallel is not None and self.parallel.fsdp > 1
        if self.parallel is not None or self.sp is not None:
            check_parallel(cfg, parallel.sizes)
        if self.sp is not None and cfg.decode:
            raise ValueError("a decode-mode model takes no seq axis")
        # Under fsdp the modules are built on the meta device and each
        # parameter is then allocated at its slice's shape.
        build = torch.device("meta") if fsdp else device
        self.embed = layers.Embed(
            cfg.vocab_size, cfg.d_model, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, tp=tp, device=build,
        )
        if cfg.position == "learned":
            self.pos_embedding = nn.Parameter(
                torch.empty((cfg.max_seq_len, cfg.d_model),
                            dtype=cfg.param_dtype, device=build)
            )
        elif cfg.position != "rope":
            raise ValueError(f"unknown position {cfg.position!r}")
        #: The pipe axis (``parallel/sharding.PipeGroup``), None at 1.
        self.pipe = parallel.pipe if parallel is not None else None
        self.pipeline = None
        if cfg.pipeline_stages > 1:
            pipeline_lib.validate(cfg)
            self.pipeline = pipeline_lib.PipelinedBlocks(cfg, self.pipe)
            held = (self.pipe.layers(cfg.num_layers) if self.pipe is not None
                    else range(cfg.num_layers))
            # Keyed by the global layer index: a stage's state dict names
            # its layers as the whole model does.
            self.blocks = nn.ModuleDict({
                str(i): Block(cfg, build, tp=tp, moe_group=moe_group,
                              sp=self.sp) for i in held})
        else:
            self.blocks = nn.ModuleList(
                Block(cfg, build, tp=tp, moe_group=moe_group, sp=self.sp)
                for _ in range(cfg.num_layers)
            )
        self.ln_final = layers.make_norm(cfg.norm, cfg.d_model, build,
                                         cfg.param_dtype)
        if not cfg.tie_embeddings:
            self.lm_head = layers.DenseGeneral(
                cfg.d_model, cfg.vocab_size // (tp.size if tp else 1),
                kernel_axes=(lr.EMBED, lr.VOCAB), dtype=cfg.dtype,
                param_dtype=cfg.param_dtype, device=build,
            )
        self.layouts = None
        self._root_unit, self._block_units = None, []
        self._root_active = False
        if self.parallel is not None:
            logical = param_logical_axes(self)
            self.layouts = self.parallel.layouts(
                logical, {k: v for k, v in param_shapes(cfg).items()
                          if k in logical})
            for name, p in list(self.named_parameters()):
                local = self.layouts[name].local_shape(self.parallel.sizes)
                if fsdp:
                    owner, _, leaf = name.rpartition(".")
                    module = self.get_submodule(owner) if owner else self
                    module._parameters[leaf] = nn.Parameter(torch.empty(
                        local, dtype=p.dtype, device=device))
                elif tuple(p.shape) != local:
                    raise AssertionError(f"{name}: {tuple(p.shape)} built, "
                                         f"{local} laid out")
        if fsdp:
            self._root_unit = self.parallel.unit(
                {n: s for n, s in self.layouts.items()
                 if not n.startswith("blocks.")})
            self._block_units = [
                self.parallel.unit(self.layouts, f"blocks.{i}.")
                for i in range(cfg.num_layers)]

    @property
    def last_stage(self) -> bool:
        """Whether this rank runs the final norm and the head: every rank
        but a pipe axis's stages before the last."""
        return self.pipe is None or self.pipe.last

    @contextlib.contextmanager
    def gathered(self):
        """Under fsdp, the leaves outside the blocks (embedding, positions,
        head) read whole within the block: gathered once, their gradients
        reduce-scattered at the end of the backward.  Nests; a no-op
        without fsdp."""
        if self._root_unit is None or self._root_active:
            yield
            return
        self._root_active = True
        try:
            with self._root_unit.gathered(self):
                yield
        finally:
            self._root_active = False

    def hidden(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        caches: Optional[List[KVCache]] = None,
    ) -> torch.Tensor:
        """Final-norm hidden states ``[B, S, d]`` (before the head).
        ``caches`` (one ``(k, v)`` pair per layer) is required in decode
        mode and rejected otherwise.  Under autograd each block runs under
        the config's remat policy."""
        return self._hidden_aux(tokens, positions, segment_ids, caches)[0]

    def _hidden_aux(self, tokens, positions=None, segment_ids=None,
                    caches=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`hidden` and the blocks' summed aux loss (fp32, unscaled;
        0 for a dense model)."""
        cfg = self.config
        if (caches is not None) != cfg.decode:
            raise ValueError(
                "decode-mode configs take one (k, v) cache per layer; "
                "others take none"
            )
        if caches is not None and len(caches) != cfg.num_layers:
            raise ValueError(
                f"{len(caches)} caches for {cfg.num_layers} layers"
            )
        width = tokens.shape[1]
        seq_len = width * (self.sp.size if self.sp is not None else 1)
        if cfg.position == "learned" and seq_len > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {seq_len} exceeds max_seq_len "
                f"{cfg.max_seq_len} of the learned position table"
            )
        if positions is None:
            # Under seq the rank's tokens sit at their global positions.
            start = self.sp.offset(width) if self.sp is not None else 0
            positions = torch.arange(
                start, start + width, device=tokens.device
            )[None, :]
        if self.pipeline is not None:
            x = None
            if self.pipe is None or self.pipe.first:
                x = self._embed(tokens, positions)
            x = self.pipeline(
                {int(k): b for k, b in self.blocks.items()}, x, positions,
                segment_ids, (tokens.shape[0], width, cfg.d_model),
                tokens.device)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            if not self.last_stage:
                return x, aux
            return self.ln_final(x), aux
        x = self._embed(tokens, positions)
        aux = None
        for i, block in enumerate(self.blocks):
            if caches is not None:
                x, layer_aux = block(x, positions, segment_ids, caches[i])
            elif self._block_units:
                # The gather runs inside the checkpoint: a remat policy's
                # recompute gathers the block's leaves again.
                x, layer_aux = remat_policy.run(
                    cfg.remat, self._block_units[i].run, block, x,
                    positions, segment_ids)
            else:
                # The (x, aux) pair goes through the checkpoint together.
                x, layer_aux = remat_policy.run(cfg.remat, block, x,
                                                positions, segment_ids)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self.ln_final(x), aux

    def _embed(self, tokens, positions) -> torch.Tensor:
        cfg = self.config
        with self.gathered():
            x = self.embed(tokens)
            if cfg.position == "learned":
                x = x + self.pos_embedding[positions].to(cfg.dtype)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Head over hidden states, in ``logits_dtype`` (this rank's
        vocabulary columns under a tensor axis)."""
        cfg = self.config
        if self.tp is not None:
            x = self.tp.enter(x)
        with self.gathered():
            if cfg.tie_embeddings:
                out = self.embed.attend(x)
            else:
                out = self.lm_head(x)
        if cfg.logit_scale != 1.0:
            out = out * cfg.logit_scale
        return out.to(cfg.logits_dtype)

    def forward(self, tokens, positions=None, segment_ids=None, caches=None):
        """Logits ``[B, S, V]`` (a pipe stage before the last: its 0-d
        zero)."""
        with self.gathered():
            x = self.hidden(tokens, positions, segment_ids, caches)
            return self.logits(x) if self.last_stage else x

    def forward_aux(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX model's ``__call__``: ``(logits, aux_loss)``, or with
        ``return_hidden`` ``(hidden * logit_scale, aux_loss)`` for a caller
        that computes the head itself (chunked cross entropy).  ``aux_loss``
        is the fp32 sum of the MoE blocks' aux losses times
        ``moe_aux_weight``, 0 for a dense model.  A pipe stage before the
        last has no head: it returns the pipeline's 0-d zero in place of
        the logits (its backward drives the stage's reverse schedule)."""
        with self.gathered():
            x, aux = self._hidden_aux(tokens, positions, segment_ids)
            aux = aux * self.config.moe_aux_weight
            if not self.last_stage:
                return x, aux
            if return_hidden:
                scale = self.config.logit_scale
                return (x * scale if scale != 1.0 else x), aux
            return self.logits(x), aux


@torch.no_grad()
def init_params(
    config: TransformerConfig, seed: int = 0, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """A random state dict for ``TransformerLM(config)`` drawn from a
    ``torch.Generator`` seeded with ``seed``: dense kernels N(0, 1/fan_in),
    embeddings N(0, 0.02^2), biases 0, norm scales 1.  Same shapes and
    scales as the JAX init, not its bits.  An MoE expert kernel ``[E, in,
    out]`` has fan-in ``E * in``: flax's ``lecun_normal`` counts the
    leading expert axis as a receptive field."""
    device = resolve_device(device)
    model = TransformerLM(config, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, layers.DenseGeneral):
            layers.normal_(module.kernel, module.fan_in ** -0.5, gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, layers.Embed):
            layers.normal_(module.embedding, 0.02, gen)
        elif isinstance(module, MoEMlp):
            for p in module.expert_params():
                layers.normal_(p, (p.shape[0] * p.shape[1]) ** -0.5, gen)
    if config.position == "learned":
        layers.normal_(model.pos_embedding, 0.02, gen)
    return model.state_dict()


def param_logical_axes(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """``{parameter name: logical axes}`` of a model's state dict, the
    reference's names: the layers' ``kernel_axes``, ``("act_seq",
    "embed")`` for the learned positions, and an MoE layer's expert
    kernels ``("expert", "embed", "mlp")`` (``wo``: ``("expert", "mlp",
    "embed")``) beside its router's ``("embed", None)``."""
    out: Dict[str, Tuple[str, ...]] = {}
    for prefix, module in model.named_modules():
        at = f"{prefix}." if prefix else ""
        for name, axes in layers.logical_axes(module).items():
            out[at + name] = tuple(axes)
        if isinstance(module, MoEMlp):
            for name, _ in module.named_parameters(recurse=False):
                out[at + name] = moe_lib.KERNEL_AXES[name]
    if isinstance(model, TransformerLM) and \
            model.config.position == "learned":
        out["pos_embedding"] = (lr.ACT_SEQ, lr.EMBED)
    return out


def stacked_logical_axes(axes: Dict[str, Sequence],
                         stages: bool = False) -> Dict[str, Tuple]:
    """The per-layer names' axes -> the layer-stacked leaves' (a leading
    ``layers`` axis, as the reference's ``nn.scan`` adds; ``stages`` for
    a pipelined model, whose leading dimension splits over ``pipe`` as
    the reference's stage dim does)."""
    lead = lr.STAGES if stages else lr.LAYERS
    out: Dict[str, Tuple] = {}
    for name, a in axes.items():
        m = re.match(r"^blocks\.(\d+)\.(.+)$", name)
        if m:
            out[f"blocks.{m.group(2)}"] = (lead,) + tuple(a)
        else:
            out[name] = tuple(a)
    return out


def param_shapes(config: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of ``TransformerLM(config)``'s state dict, built
    on the meta device (no memory)."""
    model = TransformerLM(config, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}

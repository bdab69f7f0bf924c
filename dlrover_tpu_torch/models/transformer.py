"""Decoder-only Transformer LM (port of ``dlrover_tpu/models/transformer.py``).

One model covers GPT-2 (learned positions, LayerNorm, GELU, biases, tied
head) and Llama (RoPE, RMSNorm, SwiGLU, GQA, untied head).  The JAX model
stacks its layers under ``nn.scan``; here they are a plain Python loop
over ``blocks``, and parameter names follow the JAX tree with the stacked
``layers`` axis unrolled into ``blocks.<i>`` (``models/from_jax.py``).

Training: parameters are trainable and held in ``param_dtype`` (cast to
``dtype`` at use), each block runs under its ``remat`` policy
(``ops/remat_policy.py``: ``none``, ``full`` or ``flash_only``), and
:meth:`TransformerLM.forward_aux` returns what the JAX model's
``__call__`` returns, ``(logits or hidden, aux_loss)``: the blocks' MoE
aux losses summed and scaled by ``moe_aux_weight`` (0 for a dense model).

With ``num_experts > 0`` each block's MLP is a :class:`~dlrover_tpu_torch.
models.moe.MoEMlp` named ``moe``, as in the JAX ``Block``.

Two opt-in flags of the dense step, both off by default as in JAX:
``fused_ln`` gives the blocks' norms (not ``ln_final``) the one-pass
backward kernel of ``ops/fused_norm.py``, and ``pin_attn_layouts`` puts
``ops/layout_pin.pin_layout`` before and after each block's attention.

Not ported yet (ROADMAP Queue 1 items 2 and 7): pipeline stages, ring
attention and the remat policies other than those three; their config
values raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.models import layers
from dlrover_tpu_torch.models.attention import Attention, KVCache
from dlrover_tpu_torch.models.moe import MoEMlp
from dlrover_tpu_torch.ops import remat_policy
from dlrover_tpu_torch.ops.layout_pin import pin_layout
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
    moe_dispatch: str = "einsum"   # "einsum" | "a2a" | "a2a_int8" (run as
                                   # einsum: no expert axis) | "grouped"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "xla"    # "xla" | "flash"
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
    remat: str = "none"            # ops/remat_policy.py name
    logits_dtype: torch.dtype = torch.float32
    logit_scale: float = 1.0
    pipeline_stages: int = 1
    # Decode mode: attention reads and writes a KV cache that the caller
    # passes in ([B, max_seq_len, H_kv, hd] per layer); same parameters.
    decode: bool = False

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
        if self.attention_impl == "ring":
            raise NotImplementedError(
                "attention_impl='ring' (context parallelism) is a later "
                "slice of the port (long context)"
            )
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(
                f"attention_impl must be 'xla' or 'flash', got "
                f"{self.attention_impl!r}"
            )
        if self.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline_stages > 1 is a later slice of the port (pipeline)"
            )
        remat_policy.validate(self.remat, self.attention_impl)


class Mlp(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str,
                 use_bias: bool, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: DeviceLike = None):
        super().__init__()
        if activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        dense = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                     device=device)
        self.wi = layers.DenseGeneral(d_model, d_ff, **dense)
        if activation == "swiglu":
            self.wg = layers.DenseGeneral(d_model, d_ff, **dense)
        self.wo = layers.DenseGeneral(d_ff, d_model, **dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.wi(x)
        if self.activation == "swiglu":
            h = F.silu(self.wg(x)) * h
        else:
            # flax nn.gelu defaults to the tanh form.
            h = F.gelu(h, approximate="tanh")
        return self.wo(h)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None):
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
                device=device,
            )
        else:
            self.mlp = Mlp(
                cfg.d_model, cfg.resolved_d_ff, cfg.activation, cfg.use_bias,
                cfg.dtype, cfg.param_dtype, device,
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
    use."""

    def __init__(self, config: TransformerConfig,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        self.embed = layers.Embed(
            cfg.vocab_size, cfg.d_model, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device,
        )
        if cfg.position == "learned":
            self.pos_embedding = nn.Parameter(
                torch.empty((cfg.max_seq_len, cfg.d_model),
                            dtype=cfg.param_dtype, device=device)
            )
        elif cfg.position != "rope":
            raise ValueError(f"unknown position {cfg.position!r}")
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers)
        )
        self.ln_final = layers.make_norm(cfg.norm, cfg.d_model, device,
                                         cfg.param_dtype)
        if not cfg.tie_embeddings:
            self.lm_head = layers.DenseGeneral(
                cfg.d_model, cfg.vocab_size, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype, device=device,
            )

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
        if cfg.position == "learned" and tokens.shape[1] > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds max_seq_len "
                f"{cfg.max_seq_len} of the learned position table"
            )
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device
            )[None, :]
        x = self.embed(tokens)
        if cfg.position == "learned":
            x = x + self.pos_embedding[positions].to(cfg.dtype)
        aux = None
        for i, block in enumerate(self.blocks):
            if caches is not None:
                x, layer_aux = block(x, positions, segment_ids, caches[i])
            else:
                # The (x, aux) pair goes through the checkpoint together.
                x, layer_aux = remat_policy.run(cfg.remat, block, x,
                                                positions, segment_ids)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self.ln_final(x), aux

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Head over hidden states, in ``logits_dtype``."""
        cfg = self.config
        if cfg.tie_embeddings:
            out = self.embed.attend(x)
        else:
            out = self.lm_head(x)
        if cfg.logit_scale != 1.0:
            out = out * cfg.logit_scale
        return out.to(cfg.logits_dtype)

    def forward(self, tokens, positions=None, segment_ids=None, caches=None):
        return self.logits(
            self.hidden(tokens, positions, segment_ids, caches)
        )

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
        ``moe_aux_weight``, 0 for a dense model."""
        x, aux = self._hidden_aux(tokens, positions, segment_ids)
        aux = aux * self.config.moe_aux_weight
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


def param_shapes(config: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of ``TransformerLM(config)``'s state dict, built
    on the meta device (no memory)."""
    model = TransformerLM(config, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}

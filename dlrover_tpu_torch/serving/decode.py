"""Slotted KV-cache decode on the training model (port of
``dlrover_tpu/serving/decode.py``).

The device side of :mod:`dlrover_tpu_torch.serving.engine`: a fixed pool
of per-request cache *slots* and three operations —

* ``prefill(model, tokens[1, bucket], true_len, gen, temp, topk)`` — run
  one prompt (right-padded to a bucket; pads are causally inert, see
  ``serving/bucketing.py``) through the decode-mode model with a fresh
  batch-1 cache row, and sample its first token from the logits at
  ``true_len - 1``.  Under ``attention_impl="flash"`` every layer's
  attention is one launch of the flash kernel.
* ``insert(pool, row, slot)`` — overwrite the slot's *whole* cache row
  with the prefilled row, so a recycled slot never leaks the previous
  request's K/V.  In place in the pool (the JAX program donated the pool
  and returned a new one).
* ``decode_step(model, pool, tokens[S], positions[S], gen, temps,
  topks)`` — advance all slots one token, writing each slot's K/V in place
  at its own position and sampling per slot.  Free slots compute garbage
  that the host ignores and the next ``insert`` overwrites.

Not in this slice: the process-wide program memo and AOT (PyTorch runs
eagerly; ``warmup`` builds and loads the kernel library instead), tensor
parallelism, speculative decoding and MoE configs (``ServePrograms``
refuses ``num_experts > 0``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import torch

from dlrover_tpu_torch.models.attention import KVCache
from dlrover_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from dlrover_tpu_torch.ops import kernel_lib
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device

NEG_INF = -1e15

#: ``(k, v)``, each ``[layers, slots, max_seq_len, H_kv, head_dim]``.
Pool = Tuple[torch.Tensor, torch.Tensor]


def decode_config(config: TransformerConfig) -> TransformerConfig:
    """The decode-mode twin of a training config: same parameters, KV
    cache on, remat off (the port's configs cannot hold ring attention or
    pipeline stages, which the JAX twin also switches off here)."""
    return dataclasses.replace(config, decode=True, remat="none")


def sample_tokens(
    logits: torch.Tensor,
    generator: torch.Generator,
    temps: torch.Tensor,
    topks: torch.Tensor,
    max_top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row sampling: ``(tokens [N] int64, logprobs [N] fp32)``.

    ``temp == 0`` rows take the argmax; other rows sample from
    ``logits / temp``, filtered below their k-th largest value when
    ``topk > 0`` (``max_top_k`` is the ceiling on k).  Logprobs are of the
    returned token under the raw (unscaled, unfiltered) distribution.
    """
    logits32 = logits.float()
    greedy = logits32.argmax(dim=-1)
    scaled = logits32 / temps.clamp_min(1e-6)[:, None]
    if max_top_k > 0:
        kmax = min(max_top_k, logits32.shape[-1])
        vals = torch.topk(scaled, kmax, dim=-1).values
        idx = (topks.long() - 1).clamp(0, kmax - 1)
        kth = vals.gather(-1, idx[:, None])
        drop = (topks[:, None] > 0) & (scaled < kth)
        scaled = scaled.masked_fill(drop, NEG_INF)
    # Gumbel-max: argmax(scaled + Gumbel noise) is a categorical draw.
    noise = torch.empty_like(scaled).exponential_(generator=generator)
    sampled = (scaled - noise.log()).argmax(dim=-1)
    tokens = torch.where(temps > 0.0, sampled, greedy)
    logp = torch.log_softmax(logits32, dim=-1)
    return tokens, logp.gather(-1, tokens[:, None])[:, 0]


class ServePrograms:
    """Prefill / insert / decode for one (config, slots, buckets,
    max_top_k) on one device."""

    def __init__(
        self,
        config: TransformerConfig,
        slots: int,
        buckets: Sequence[int],
        max_top_k: int = 64,
        device: DeviceLike = None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if not buckets:
            raise ValueError("at least one prefill bucket is required")
        buckets = tuple(sorted(int(b) for b in buckets))
        if buckets[0] < 1:
            raise ValueError(f"bucket widths must be >= 1, got {buckets}")
        if config.num_experts > 0:
            raise NotImplementedError(
                "serving an MoE config (num_experts > 0) is a later slice "
                "of the port (MoE serving); this port trains MoE models only"
            )
        self.device = resolve_device(device)
        self.config = decode_config(config)
        if buckets[-1] >= self.config.max_seq_len:
            raise ValueError(
                f"largest bucket {buckets[-1]} must leave decode room "
                f"inside max_seq_len {self.config.max_seq_len}"
            )
        if max_top_k < 0 or max_top_k > self.config.vocab_size:
            raise ValueError(
                f"max_top_k must be in [0, vocab_size], got {max_top_k}"
            )
        self.slots = slots
        self.buckets = buckets
        self.max_top_k = max_top_k

    def place_params(self, params) -> TransformerLM:
        """The decode-mode model on this device, loaded from a state dict
        (``init_params`` or ``from_jax.state_dict_from_jax``); tensors are
        cast to the model's dtypes."""
        model = TransformerLM(self.config, self.device)
        model.load_state_dict(params)
        return model.eval()

    # -- cache pool -----------------------------------------------------------

    def _zeros(self, batch: int) -> Pool:
        cfg = self.config
        shape = (cfg.num_layers, batch, cfg.max_seq_len,
                 cfg.resolved_kv_heads, cfg.resolved_head_dim)
        return (
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
        )

    def init_cache(self) -> Pool:
        """A zeroed slot pool: K and V, ``[layers, slots, max_seq, H_kv,
        hd]`` each."""
        return self._zeros(self.slots)

    @staticmethod
    def _layer_caches(pool: Pool) -> List[KVCache]:
        k, v = pool
        return [(k[i], v[i]) for i in range(k.shape[0])]

    # -- the three operations -------------------------------------------------

    @torch.no_grad()
    def prefill_logits(self, model, tokens, true_len) -> Tuple[Pool,
                                                                torch.Tensor]:
        """``(row, logits [1, V])``: a fresh batch-1 pool filled with the
        prompt's K/V, and the next-token logits at the last real position
        (not the padded end)."""
        row = self._zeros(1)
        width = tokens.shape[1]
        positions = torch.arange(width, device=self.device)[None, :]
        hidden = model.hidden(
            tokens, positions, caches=self._layer_caches(row)
        )
        return row, model.logits(hidden[:, true_len - 1])

    def prefill(self, model, tokens, true_len, generator, temp, topk):
        """``(row, first [1], logp [1])``; ``row`` is a batch-1 pool."""
        row, last = self.prefill_logits(model, tokens, true_len)
        first, logp = sample_tokens(
            last, generator, temp, topk, self.max_top_k
        )
        return row, first, logp

    @torch.no_grad()
    def insert(self, pool: Pool, row: Pool, slot: int) -> None:
        """Overwrite slot ``slot``'s whole row of the pool, in place."""
        for pool_t, row_t in zip(pool, row):
            pool_t[:, slot].copy_(row_t[:, 0])

    @torch.no_grad()
    def decode_logits(self, model, pool, tokens, positions) -> torch.Tensor:
        """Next-token logits ``[S, V]`` of one token per slot at its
        position; each slot's K/V is written into the pool in place."""
        logits = model(
            tokens[:, None], positions[:, None],
            caches=self._layer_caches(pool),
        )
        return logits[:, 0]

    def decode_step(self, model, pool, tokens, positions, generator, temps,
                    topks):
        """``(next_tokens [S], logp [S])``; the pool is updated in
        place."""
        return sample_tokens(
            self.decode_logits(model, pool, tokens, positions),
            generator, temps, topks, self.max_top_k,
        )

    def warmup(self) -> float:
        """Build and load the kernel library this config's path launches
        (flash attention on a CUDA device).  Returns wall seconds: 0.0
        when the path launches no kernel, near 0 once it is loaded."""
        if self.device.type != "cuda" or self.config.attention_impl != (
                "flash"):
            return 0.0
        t0 = time.perf_counter()
        kernel_lib.load("flash_attention")
        return time.perf_counter() - t0

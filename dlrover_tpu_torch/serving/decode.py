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

An MoE config (``num_experts > 0``) serves through the same operations:
each block's ``models/moe.MoEMlp`` routes the prompt's or the step's
tokens, and under ``moe_dispatch="grouped"`` every expert product is one
launch of the grouped-matmul kernel (K8 on the card).

**Speculative decoding** (:class:`SpecPrograms`): a draft model proposes
γ greedy tokens a slot (γ single-token draft steps) and the target scores
the ``[S, γ+1]`` chunk in one decode-mode forward; each slot accepts the
longest prefix where the draft matched the target's argmax, plus one
bonus token from the target's own logits at the first divergence, so a
greedy slot's stream is the plain decode path's.  Sampled rows (temp > 0)
accept nothing and draw the bonus through :func:`sample_tokens`.

**Tensor parallelism** (``tp=serving.tp.ServeTPMesh``): the model of a
rank of the fold holds its heads, MLP columns and vocabulary rows, the
pool its ``H_kv / tp`` KV heads (per-rank pool bytes fall as 1/tp), and
the logits of every prefill and decode step are gathered whole over the
fold before sampling; the program memo keys on ``(logical_tp,
physical_tp)``.  Every rank of the fold runs the same operations in the
same order.

Program sets are memoized process-wide (:func:`get_programs`,
:func:`get_spec_programs`): fleet replicas of one configuration share
one :class:`ServePrograms`.  PyTorch runs eagerly, so there is nothing to
trace or compile ahead (the reference's ``aot_compile``); ``warmup``
builds and loads the kernel libraries the path launches instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.models.attention import KVCache
from dlrover_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from dlrover_tpu_torch.ops import kernel_lib
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device
from dlrover_tpu_torch.serving.tp import ServeTPMesh, validate_tp_config

NEG_INF = -1e15

#: Speculative proposal-length ceiling: the verify chunk is ``γ+1`` wide
#: and must stay below ``models/attention.FLASH_PREFILL_MIN`` (16), so a
#: verify step takes ``cached_attention`` over the whole cache and never
#: the flash kernel, which attends over the fresh chunk alone (a prefill
#: at position 0).
MAX_SPEC_TOKENS = 14

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


def _tp_key(tp: Optional[ServeTPMesh]) -> Tuple:
    return (tp.logical_tp, tp.physical_tp) if tp is not None else ()


def _programs_key(config: TransformerConfig, slots: int,
                  buckets: Sequence[int], max_top_k: int,
                  device: torch.device,
                  tp: Optional[ServeTPMesh] = None) -> Tuple:
    """The one spelling of a program set's memo key (used by both
    :func:`get_programs` and ``ServePrograms.__init__``); ``tp`` carries
    ``(logical, physical)``."""
    return ("serve", decode_config(config), int(slots),
            tuple(sorted(int(b) for b in buckets)), int(max_top_k),
            str(device), _tp_key(tp))


def _spec_key(target: "ServePrograms", draft: "ServePrograms",
              spec_tokens: int) -> Tuple:
    """The one spelling of a speculative pair's memo key (used by both
    :func:`get_spec_programs` and ``SpecPrograms.__init__``)."""
    return ("spec", target.cache_key, draft.cache_key, int(spec_tokens))


class ServePrograms:
    """Prefill / insert / decode for one (config, slots, buckets,
    max_top_k, tp) on one device.  Obtain through :func:`get_programs` so
    equal keys share one instance."""

    def __init__(
        self,
        config: TransformerConfig,
        slots: int,
        buckets: Sequence[int],
        max_top_k: int = 64,
        device: DeviceLike = None,
        tp: Optional[ServeTPMesh] = None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if not buckets:
            raise ValueError("at least one prefill bucket is required")
        buckets = tuple(sorted(int(b) for b in buckets))
        if buckets[0] < 1:
            raise ValueError(f"bucket widths must be >= 1, got {buckets}")
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
        self.tp = tp
        if tp is not None:
            validate_tp_config(self.config, tp.logical_tp)
            if self.config.num_experts:
                raise NotImplementedError(
                    "an MoE model on the tensor axis is a later slice of the "
                    "port (ROADMAP Queue 1 item 6's remainder); serve it at "
                    "tp <= 1")
        self.cache_key = _programs_key(config, slots, buckets, max_top_k,
                                       self.device, tp)

    @property
    def sharded(self) -> bool:
        """Whether a rank holds a slice of the model (a fold above 1)."""
        return self.tp is not None and self.tp.physical_tp > 1

    @property
    def kv_heads(self) -> int:
        """KV heads of this rank's pool."""
        if self.tp is None:
            return self.config.resolved_kv_heads
        return self.tp.kv_heads(self.config)

    def place_params(self, params) -> TransformerLM:
        """The decode-mode model on this device, loaded from a state dict
        (``init_params`` or ``from_jax.state_dict_from_jax``); tensors are
        cast to the model's dtypes.  On a fold above 1 the model is this
        rank's part of it and a whole state dict is cut to the rank's
        slices (``ServeTPMesh.split_params``)."""
        if not self.sharded:
            model = TransformerLM(self.config, self.device)
        else:
            model = TransformerLM(self.config, self.device,
                                  parallel=self.tp.parallel())
            params = self.tp.split_params(params, self.config)
        model.load_state_dict(params)
        return model.eval()

    # -- cache pool -----------------------------------------------------------

    def _zeros(self, batch: int) -> Pool:
        cfg = self.config
        shape = (cfg.num_layers, batch, cfg.max_seq_len, self.kv_heads,
                 cfg.resolved_head_dim)
        return (
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
        )

    def init_cache(self) -> Pool:
        """A zeroed slot pool: K and V, ``[layers, slots, max_seq, H_kv,
        hd]`` each (``H_kv / tp`` heads on a fold)."""
        return self._zeros(self.slots)

    @staticmethod
    def _layer_caches(pool: Pool) -> List[KVCache]:
        k, v = pool
        return [(k[i], v[i]) for i in range(k.shape[0])]

    def place_row(self, row: Pool) -> Pool:
        """A prefilled row (a host page streamed from a prefill replica)
        on this device; a row already here is returned as it is (on a
        fold, a page of a prefill rank of the same fold: its heads)."""
        return tuple(t.to(self.device, non_blocking=True) for t in row)

    def pool_device_bytes(self, pool: Optional[Pool]) -> int:
        """Bytes of ``pool`` on its device; on a fold, the largest per-rank
        count of this program set's slot pool (``pool`` is None on a
        parked rank)."""
        if self.tp is not None:
            return self.tp.pool_device_bytes(self.config, self.slots)
        return sum(t.numel() * t.element_size() for t in pool)

    def _whole(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits over the whole vocabulary (gathered over a fold)."""
        if self.sharded:
            return self.tp.gather_vocab(logits)
        return logits

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
        return row, self._whole(model.logits(hidden[:, true_len - 1]))

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
    def chunk_logits(self, model, pool, chunk, positions) -> torch.Tensor:
        """Logits ``[S, W, V]`` of a ``[S, W]`` chunk a slot, token ``j``
        of slot ``s`` at position ``positions[s] + j``; the chunk's K/V is
        written into the pool in place."""
        width = chunk.shape[1]
        grid = positions[:, None] + torch.arange(width,
                                                 device=positions.device)
        return self._whole(model(chunk, grid,
                                 caches=self._layer_caches(pool)))

    def decode_logits(self, model, pool, tokens, positions) -> torch.Tensor:
        """Next-token logits ``[S, V]`` of one token per slot at its
        position; each slot's K/V is written into the pool in place."""
        return self.chunk_logits(model, pool, tokens[:, None],
                                 positions)[:, 0]

    def decode_step(self, model, pool, tokens, positions, generator, temps,
                    topks):
        """``(next_tokens [S], logp [S])``; the pool is updated in
        place."""
        return sample_tokens(
            self.decode_logits(model, pool, tokens, positions),
            generator, temps, topks, self.max_top_k,
        )

    def warmup(self) -> float:
        """Build and load the kernel libraries this config's path launches
        on a CUDA device (flash attention under ``attention_impl="flash"``,
        the grouped matmul under ``moe_dispatch="grouped"``).  Returns wall
        seconds: 0.0 when the path launches no kernel or every library is
        already loaded."""
        if self.device.type != "cuda":
            return 0.0
        cfg = self.config
        names = []
        if cfg.attention_impl == "flash":
            names.append("flash_attention")
        if cfg.num_experts and cfg.moe_dispatch == "grouped":
            names.append("grouped_matmul")
        if all(kernel_lib.loaded(n) for n in names):
            return 0.0
        t0 = time.perf_counter()
        for name in names:
            kernel_lib.load(name)
        return time.perf_counter() - t0


def accept_chunk(
    logits: torch.Tensor,
    chunk: torch.Tensor,
    generator: torch.Generator,
    temps: torch.Tensor,
    topks: torch.Tensor,
    max_top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The verify rule over the target's chunk logits ``[S, γ+1, V]``:
    ``(emitted [S, γ+1], emit_len [S], logps [S, γ+1], accepted [S])``.

    ``accepted`` is the longest prefix of the proposals ``chunk[:, 1:]``
    equal to the target's argmax at the positions before them (0 for a
    sampled row); ``emitted[:, :n]`` are the accepted proposals and
    ``emitted[:, n]`` the bonus token: the target's argmax after them for
    a greedy row, a :func:`sample_tokens` draw from the first position's
    logits for a sampled row.  Entries past ``emit_len = n + 1`` are
    junk.  Logprobs are of the emitted tokens under the raw distribution.
    """
    logits32 = logits.float()
    s, width = chunk.shape
    target_greedy = logits32.argmax(dim=-1)                  # [S, γ+1]
    proposals = chunk[:, 1:]
    match = (proposals == target_greedy[:, :-1]).long()
    # Longest matching prefix: the cumulative product is 0 from the first
    # mismatch on.
    accepted = torch.cumprod(match, dim=1).sum(dim=1)        # [S]
    greedy_row = temps <= 0.0
    accepted = torch.where(greedy_row, accepted, torch.zeros_like(accepted))
    sampled0, _ = sample_tokens(logits32[:, 0], generator, temps, topks,
                                max_top_k)
    bonus = target_greedy.gather(1, accepted[:, None])[:, 0]
    bonus = torch.where(greedy_row, bonus, sampled0)
    idx = torch.arange(width, device=chunk.device)[None, :]
    prop_pad = torch.cat([proposals, torch.zeros_like(proposals[:, :1])],
                         dim=1)
    emitted = torch.where(idx < accepted[:, None], prop_pad, bonus[:, None])
    logps = torch.log_softmax(logits32, dim=-1).gather(
        -1, emitted[..., None])[..., 0]
    return emitted, accepted + 1, logps, accepted


class SpecPrograms:
    """Speculative-decoding pair over two :class:`ServePrograms`:

    * ``propose(draft_model, draft_pool, tokens[S], positions[S])`` — the
      draft greedily rolls γ tokens a slot (γ single-token steps, each a
      decode step of the draft), writing the draft's own pool as it goes;
      returns the proposals ``[S, γ]``.
    * ``verify(model, pool, chunk[S, γ+1], positions[S], gen, temps,
      topks)`` — the target scores the whole chunk (the current token and
      the γ proposals) in one decode-mode forward and
      :func:`accept_chunk` picks what each slot emits.

    Cache hygiene: verify writes K/V at all γ+1 chunk positions, but
    rejected positions are causally inert — ``cached_attention`` masks
    positions past each query's, and the committed stream's next writes
    land on (and overwrite) the stale rows, the argument that makes
    prefill right-padding safe (``serving/bucketing.py``).  The engine's
    admission keeps γ positions of headroom, so a verify write never
    reaches past ``max_seq_len`` (where ``write_cache`` would clamp it
    onto earlier rows).
    """

    def __init__(self, target: ServePrograms, draft: ServePrograms,
                 spec_tokens: int):
        if not 1 <= spec_tokens <= MAX_SPEC_TOKENS:
            raise ValueError(
                f"spec_tokens must be in [1, {MAX_SPEC_TOKENS}], got "
                f"{spec_tokens} (the γ+1-wide verify chunk must stay "
                "under the flash prefill threshold)"
            )
        if target.config.vocab_size != draft.config.vocab_size:
            raise ValueError(
                "draft and target must share a vocab: "
                f"{draft.config.vocab_size} != {target.config.vocab_size}"
            )
        if target.slots != draft.slots:
            raise ValueError(
                f"draft slots {draft.slots} != target slots {target.slots}"
            )
        if target.device != draft.device:
            raise ValueError(
                f"draft device {draft.device} != target device "
                f"{target.device}"
            )
        t_tp, d_tp = _tp_key(target.tp), _tp_key(draft.tp)
        if t_tp != d_tp:
            raise ValueError(
                f"draft tp {d_tp} != target tp {t_tp}: the draft shares "
                "the TP decode path"
            )
        self.target = target
        self.draft = draft
        self.spec_tokens = spec_tokens
        self.cache_key = _spec_key(target, draft, spec_tokens)

    @torch.no_grad()
    def propose(self, draft_model, draft_pool, tokens, positions
                ) -> torch.Tensor:
        tok, pos = tokens, positions
        proposed = []
        for _ in range(self.spec_tokens):
            logits = self.draft.decode_logits(draft_model, draft_pool, tok,
                                              pos)
            tok = logits.float().argmax(dim=-1)
            pos = pos + 1
            proposed.append(tok)
        return torch.stack(proposed, dim=1)

    def verify(self, model, pool, chunk, positions, generator, temps,
               topks):
        """``(emitted, emit_len, logps, accepted)`` of
        :func:`accept_chunk`; the pool holds the chunk's K/V after it."""
        logits = self.target.chunk_logits(model, pool, chunk, positions)
        return accept_chunk(logits, chunk, generator, temps, topks,
                            self.target.max_top_k)


# Process-wide program memo: equal keys share one program set, so fleet
# replicas of one configuration (and a rebuilt engine) share it.
_PROGRAMS: Dict[Any, Any] = {}


def get_programs(
    config: TransformerConfig,
    slots: int,
    buckets: Sequence[int],
    max_top_k: int = 64,
    device: DeviceLike = None,
    tp: Optional[ServeTPMesh] = None,
) -> ServePrograms:
    device = resolve_device(device)
    key = _programs_key(config, slots, buckets, max_top_k, device, tp)
    programs = _PROGRAMS.get(key)
    if programs is None:
        programs = ServePrograms(config, slots, buckets, max_top_k, device,
                                 tp)
        _PROGRAMS[key] = programs
    return programs


def get_spec_programs(target: ServePrograms, draft: ServePrograms,
                      spec_tokens: int) -> SpecPrograms:
    key = _spec_key(target, draft, spec_tokens)
    programs = _PROGRAMS.get(key)
    if programs is None:
        programs = SpecPrograms(target, draft, spec_tokens)
        _PROGRAMS[key] = programs
    return programs


def clear_programs() -> None:
    """Test hook: drop the process-wide program memo."""
    _PROGRAMS.clear()

"""Continuous-batching serving engine (port of
``dlrover_tpu/serving/engine.py``).

The host side of the serving plane: an admission queue in front of the
slotted decode operations (:mod:`dlrover_tpu_torch.serving.decode`).  Each
live request owns one KV-cache slot; one ``decode_step`` advances every
occupied slot one token, and a request that finishes frees its slot for
the next queued request on the very next step.  ``static_batching=True``
is the baseline: admission waits until the whole pool drains.

Three optional planes compose on top of the base loop:

* **Tensor parallelism** (``tp=N``): one logical model of ``N`` shards
  folded onto the first processes of the default ``torch.distributed``
  group (``serving/tp.py``), every process running the same engine on
  the same requests in lockstep: each holds its slice of the weights and
  its ``H_kv / N`` heads of the KV pool, and every rank samples the same
  tokens from the logits gathered whole.  :meth:`ServingEngine.fold_tp`
  re-folds a live engine onto another number of ranks: the shards and KV
  rows (and the draft's) move over the wire, queued and live requests
  carry on, and a rank the fold leaves out is parked until a fold takes
  it in again.

* **Disaggregated prefill** (``role=``): a ``"prefill"`` engine turns
  prompts into :class:`PrefilledPage` s — KV cache rows on the host — on
  its ``outbox``; a ``"decode"`` engine accepts pages through
  :meth:`ServingEngine.insert_page` and only runs the per-token step, so
  its decode steps never absorb a long prefill.  ``"mixed"`` (the
  default) is the colocated engine.
* **Speculative decoding** (``draft_config``/``draft_params``): a small
  draft model proposes γ greedy tokens a slot and the target verifies the
  whole chunk in one forward (``decode.SpecPrograms``): ``n+1`` tokens a
  round, the plain stream for greedy requests.

Admission is the ``serve.admit`` fault seam (``common/faults.py``), retried
under ``admit_policy`` (a :class:`~dlrover_tpu_torch.common.retry.
RetryPolicy`): an injected admission fault is retried with backoff under a
deadline instead of dropping the request.  The engine books a ``serve``
telemetry event every ``telemetry_every`` steps and at the end of each
drain, a ``compile`` event for its warm-up and a ``serve.swap`` event for
every live weight swap (:meth:`ServingEngine.swap_weights`, the
``serve.swap`` seam).  With no fault plan the seams are no-ops.

The engine registers its weights (target and draft) as the memory
registry's ``params`` pool and its KV pools as ``kv_pool``
(``utils/memory_profile``).  With a master client (``client=``,
``agent/master_client.MasterClient``) the engine also reports its
``serve.swap`` and ``compile`` events to the master as node events.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common import faults, telemetry
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.retry import RetryPolicy
from dlrover_tpu_torch.models.transformer import (
    TransformerConfig,
    param_shapes,
)
from dlrover_tpu_torch.rl.generation import SamplingParams
from dlrover_tpu_torch.runtime.device import DeviceLike
from dlrover_tpu_torch.serving.bucketing import (
    make_buckets,
    pad_to_bucket,
    pick_bucket,
)
from dlrover_tpu_torch.serving import hotswap
from dlrover_tpu_torch.serving.decode import (
    Pool,
    get_programs,
    get_spec_programs,
)
from dlrover_tpu_torch.serving.tp import ServeTPMesh, build_tp_mesh
from dlrover_tpu_torch.trainer.state_digest import format_digest

ROLES = ("mixed", "prefill", "decode")


@dataclasses.dataclass
class Request:
    """One generation request.  ``prompt`` is a 1-D int token array;
    ``eos_id < 0`` disables early stop."""

    uid: str
    prompt: np.ndarray
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams
    )
    eos_id: int = -1


@dataclasses.dataclass
class RequestResult:
    """A finished request: generated tokens (prompt excluded) and their
    logprobs under the raw next-token distribution."""

    uid: str
    prompt: np.ndarray
    tokens: np.ndarray
    logprobs: np.ndarray
    submit_t: float
    admitted_t: float
    done_t: float

    @property
    def latency_s(self) -> float:
        return self.done_t - self.submit_t

    @property
    def queue_s(self) -> float:
        return self.admitted_t - self.submit_t


@dataclasses.dataclass
class PrefilledPage:
    """One prefilled request in wire form: the batch-1 KV cache row as
    host tensors (plus the draft model's row when the decode pool
    speculates), the first sampled token, and what a decode engine needs
    to resume the request where prefill left it.  ``nbytes`` is the rows'
    exact byte count (``2 x L x max_seq_len x H_kv x head_dim x`` the
    element size for each row).  On a CUDA engine the rows are pinned, so
    the receiving engine's upload is one asynchronous copy."""

    request: Request
    submit_t: float
    admitted_t: float
    true_len: int
    first_token: int
    first_logp: float
    row: Pool
    draft_row: Optional[Pool] = None
    nbytes: int = 0


class _SlotState:
    __slots__ = (
        "request", "generated", "logps", "submit_t", "admitted_t", "target"
    )

    def __init__(self, request: Request, submit_t: float,
                 admitted_t: float):
        self.request = request
        self.generated: List[int] = []
        self.logps: List[float] = []
        self.submit_t = submit_t
        self.admitted_t = admitted_t
        self.target = request.sampling.max_new_tokens


def _boxes(tp: ServeTPMesh, layouts) -> List[Dict[str, Any]]:
    """Each rank of the fold's box of every leaf: ``[{name: slices}]``."""
    par = [tp.parallel(r) for r in range(tp.physical_tp)]
    return [{n: tuple(slice(b, e) for b, e in lay.index(p.coords, p.sizes))
             for n, lay in layouts.items()} for p in par]


def _gather_whole(programs, model, pool):
    """The whole state dict and pool on rank 0 of ``programs``' fold (None
    elsewhere): rank 0's own at a fold of 1, else every rank's slices
    gathered over the fold's wire (one collective a leaf) and put in
    place."""
    tp = programs.tp
    if tp.physical_tp == 1:
        return (model.state_dict(), pool) if tp.rank == 0 else (None, None)
    if not tp.member:
        return None, None
    root = tp.rank == 0
    n = tp.physical_tp
    layouts = tp.layouts(programs.config)
    boxes = _boxes(tp, layouts) if root else None
    params = {}
    for name, t in model.state_dict().items():
        got = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device) if root else None
        tp.wire.gather(got, t.contiguous())
        if root:
            whole = torch.empty(layouts[name].shape, dtype=t.dtype,
                                device=t.device)
            for r in range(n):
                whole[boxes[r][name]] = got[r]
            params[name] = whole
    whole_pool = None
    if pool is not None:
        whole_pool = []
        for t in pool:
            got = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device) if root else None
            tp.wire.gather(got, t)
            if root:
                # [n, L, S, T, h, D] -> [L, S, T, n * h, D], rank-major.
                whole_pool.append(got.movedim(0, -3).reshape(
                    tuple(t.shape[:-2]) + (n * t.shape[-2], t.shape[-1])))
        whole_pool = tuple(whole_pool) if root else None
    return (params, whole_pool) if root else (None, None)


def _scatter_fold(programs, params, pool, has_pool: bool):
    """This rank's model and pool at ``programs``' fold from rank 0's
    whole ``params`` and ``pool``: kept whole at a fold of 1, else cut to
    every rank's slices and scattered over the fold's wire (one
    collective a leaf).  ``(None, None)`` out of the fold."""
    tp = programs.tp
    if not tp.member:
        return None, None
    if tp.physical_tp == 1:
        return programs.place_params(params), pool
    root = tp.rank == 0
    n = tp.physical_tp
    layouts = tp.layouts(programs.config)
    boxes = _boxes(tp, layouts) if root else None
    sizes = tp.parallel().sizes
    device = programs.device
    local = {}
    for name, lay in layouts.items():
        # Every parameter is held in the config's param_dtype.
        out = torch.empty(lay.local_shape(sizes),
                          dtype=programs.config.param_dtype, device=device)
        inp = torch.stack([params[name][boxes[r][name]] for r in range(n)]) \
            if root else None
        tp.wire.scatter(out, inp)
        local[name] = out
    model = programs.place_params(local)
    if not has_pool:
        return model, None
    new_pool = programs.init_cache()
    h = new_pool[0].shape[-2]
    for i, out in enumerate(new_pool):
        inp = torch.stack([pool[i].narrow(-2, r * h, h) for r in range(n)]) \
            if root else None
        tp.wire.scatter(out, inp)
    return model, new_pool


def _refold(old, new, model, pool, has_pool: bool):
    """``(model, pool)`` of this rank at ``new``'s fold from its ``model``
    and ``pool`` at ``old``'s (None where the rank holds none; a pool
    moves when ``has_pool``): the old fold's slices are gathered whole on
    rank 0, which cuts and scatters the new fold's."""
    params, whole_pool = _gather_whole(old, model, pool)
    del model, pool
    return _scatter_fold(new, params, whole_pool, has_pool)


def _broadcast_bytes(wire, data: Optional[bytes], device) -> bytes:
    """``data`` of the wire's rank 0 on every rank of it."""
    size = torch.tensor([len(data) if data is not None else 0],
                        dtype=torch.int64, device=device)
    wire.broadcast(size, src=0)
    buf = torch.empty(int(size.item()), dtype=torch.uint8, device=device)
    if data is not None:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    wire.broadcast(buf, src=0)
    return buf.cpu().numpy().tobytes()


def _nearest_rank(sorted_values: Sequence[float], p: float) -> float:
    """The nearest-rank quantile (ceil(p*n)-th order statistic): an actual
    observed sample."""
    n = len(sorted_values)
    if n == 0:
        return 0.0
    return sorted_values[min(n - 1, max(0, math.ceil(p * n) - 1))]


#: What a fold that takes a parked rank in does not copy to it from rank
#: 0: the fold's device state, which each rank builds for itself, the
#: sampler's generator (its state goes apart) and the admission policy
#: (the same on every rank; it may hold callables).  Every other
#: attribute is the host scheduler's, and is copied.
_RANK_LOCAL_FIELDS = frozenset({
    "tp", "device", "programs", "model", "cache", "draft_programs",
    "draft_model", "draft_cache", "spec", "_gen", "admit_policy", "client",
})


class ServingEngine:
    """Slot-pool scheduler bound to one (config, params) pair on one
    device (``cuda`` unless ``device="cpu"`` is asked for); with ``tp`` >
    1, this process's rank of a tensor-parallel fold onto as many of the
    default group's processes as divide ``tp`` (``fold_tp`` changes it)."""

    def __init__(
        self,
        config: TransformerConfig,
        params,
        *,
        slots: int = 4,
        buckets: Optional[Sequence[int]] = None,
        max_top_k: int = 64,
        seed: int = 0,
        static_batching: bool = False,
        telemetry_every: int = 32,
        client=None,
        admit_policy: Optional[RetryPolicy] = None,
        tp: int = 0,
        role: str = "mixed",
        draft_config: Optional[TransformerConfig] = None,
        draft_params=None,
        spec_tokens: int = 4,
        device: DeviceLike = None,
    ):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if buckets is None:
            buckets = make_buckets(max(1, config.max_seq_len // 2))
        self._base_config = config
        self.role = role
        self.tp: Optional[ServeTPMesh] = (
            build_tp_mesh(tp) if tp and tp > 1 else None
        )
        self.programs = get_programs(
            config, slots, tuple(buckets), max_top_k, device=device,
            tp=self.tp,
        )
        self.device = self.programs.device
        self.slots = slots
        self.buckets = self.programs.buckets
        self.static_batching = static_batching
        self.client = client
        self.model = self.cache = None
        if not self.parked:
            self.model = self.programs.place_params(params)
            self.cache = self.programs.init_cache()
        # Speculative plane: the draft shares slots and buckets with the
        # target so its pool rows line up slot for slot.  A prefill-role
        # engine keeps the draft programs (to ship draft rows in its
        # pages) but no draft pool and no SpecPrograms: it never decodes.
        self._draft_base_config = draft_config
        self.spec = None
        self.draft_programs = None
        self.draft_model = None
        self.draft_cache: Optional[Pool] = None
        self.spec_tokens = spec_tokens
        if draft_config is not None:
            if draft_params is None:
                raise ValueError("draft_config requires draft_params")
            self.draft_programs = get_programs(
                draft_config, slots, tuple(buckets), max_top_k,
                device=self.device, tp=self.tp,
            )
            if not self.parked:
                self.draft_model = self.draft_programs.place_params(
                    draft_params)
            if role != "prefill":
                self.spec = get_spec_programs(
                    self.programs, self.draft_programs, spec_tokens
                )
                if not self.parked:
                    self.draft_cache = self.draft_programs.init_cache()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._slot_state: List[Optional[_SlotState]] = [None] * slots
        self._tokens = np.zeros((slots,), np.int64)
        self._positions = np.zeros((slots,), np.int64)
        self._temps = np.zeros((slots,), np.float32)
        self._topks = np.zeros((slots,), np.int64)
        self._queue: Deque[Tuple[Request, float]] = deque()
        # Disaggregation mailboxes: a prefill engine fills ``outbox``; a
        # decode-capable engine drains ``_page_queue`` into slots.
        self.outbox: Deque[PrefilledPage] = deque()
        self._page_queue: Deque[PrefilledPage] = deque()
        self._pages_in = 0
        self._pages_out = 0
        self._page_bytes_out = 0
        self.results: Dict[str, RequestResult] = {}
        self.telemetry_every = max(1, telemetry_every)
        # Injected admission faults (serve.admit) are retried with backoff
        # under a deadline instead of dropping the request on the floor.
        self.admit_policy = admit_policy or RetryPolicy(
            max_attempts=4, base_delay_s=0.05, max_delay_s=0.5,
            deadline_s=5.0, retryable=(faults.FaultInjected,),
            name="serve.admit", quiet=True,
        )
        self._step_i = 0
        self._completed: Deque[Tuple[float, float, int]] = deque(maxlen=512)
        self._occupancy: Deque[float] = deque(maxlen=256)
        # Wall seconds of each step that decoded at least one live slot:
        # the decode-interference signal disaggregation is judged by.
        self._step_lat: Deque[float] = deque(maxlen=512)
        self._requests_done = 0
        self._tokens_out = 0
        self._prefills = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rounds = 0
        # Weight provenance: bumped by every verified hot-swap.
        self.weights_version = 0
        # Classified device-memory accounting: serving params + the paged
        # KV pool (target and draft) register as bound methods, which the
        # registry holds via WeakMethod — a torn-down engine (fleet
        # replica kill, bench teardown) unregisters itself on collection.
        from dlrover_tpu_torch.utils import memory_profile

        memory_profile.registry().register(
            "params", f"serve.{id(self)}.params", self.memory_params
        )
        memory_profile.registry().register(
            "kv_pool", f"serve.{id(self)}.kv", self.memory_kv_pool
        )

    def memory_params(self):
        """Registry provider: this rank's weights (target + draft; none
        on a parked rank)."""
        return [dict(m.state_dict()) for m in (self.model, self.draft_model)
                if m is not None]

    def memory_kv_pool(self):
        """Registry provider: the paged KV pool (target + draft)."""
        return [p for p in (self.cache, self.draft_cache) if p is not None]

    @property
    def parked(self) -> bool:
        """Whether this rank is out of the current TP fold: it holds no
        weights and no pool, and its steps do nothing until a fold takes
        it in again."""
        return self.tp is not None and not self.tp.member

    # -- admission ------------------------------------------------------------

    def submit(self, request: Request) -> str:
        """Queue a request; raises ``ValueError`` for one that can never
        be admitted (and a decode-role engine takes no prompts)."""
        if self.role == "decode":
            raise ValueError(
                f"request {request.uid}: a decode-role engine admits "
                "prefilled pages (insert_page), not prompts"
            )
        prompt = np.asarray(request.prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError(f"request {request.uid}: empty prompt")
        n_new = request.sampling.max_new_tokens
        if n_new < 1:
            raise ValueError(
                f"request {request.uid}: max_new_tokens must be >= 1"
            )
        vocab = self.programs.config.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(
                f"request {request.uid}: token ids must lie in [0, {vocab})"
            )
        self._check_fits(request.uid, prompt.size, n_new)
        if request.sampling.top_k > max(1, self.programs.max_top_k):
            raise ValueError(
                f"request {request.uid}: top_k {request.sampling.top_k} "
                f"exceeds the engine's max_top_k {self.programs.max_top_k}"
            )
        request = dataclasses.replace(request, prompt=prompt)
        submit_t = time.perf_counter()

        def admit():
            faults.fire("serve.admit", uid=request.uid)
            self._queue.append((request, submit_t))

        self.admit_policy.call(admit)
        return request.uid

    def _check_fits(self, uid: str, prompt_len: int, n_new: int):
        """Refuse a request whose decode could write past its KV row.  A
        speculating engine (and a prefill engine that ships draft rows to
        one) reserves γ positions: a verify step writes K/V up to γ past
        the committed position, and ``write_cache`` would clamp a write
        that runs over back onto committed rows."""
        bucket = pick_bucket(prompt_len, self.buckets)
        max_seq = self.programs.config.max_seq_len
        headroom = self.spec_tokens if self.draft_programs is not None \
            else 0
        if bucket + n_new + headroom > max_seq:
            raise ValueError(
                f"request {uid}: bucket {bucket} + max_new_tokens {n_new}"
                + (f" + spec headroom {headroom}" if headroom else "")
                + f" exceeds max_seq_len {max_seq}"
            )

    def insert_page(self, page: PrefilledPage) -> None:
        """Accept a prefilled KV page from a prefill replica (the decode
        half of the disaggregated path); it lands in a slot on the next
        :meth:`step`.  Raises ``ValueError`` for a page this engine could
        not decode to its end: a speculating engine holds a page from a
        replica without a draft to its own γ headroom."""
        if self.role == "prefill":
            raise ValueError("a prefill-role engine cannot accept pages")
        self._check_fits(page.request.uid, page.true_len,
                         page.request.sampling.max_new_tokens)
        self._page_queue.append(page)
        self._pages_in += 1

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slot_state) if s is None]

    def _live_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slot_state) if s is not None]

    def _maybe_finish(self, slot: int, last_token: int) -> bool:
        state = self._slot_state[slot]
        if len(state.generated) >= state.target or (
            state.request.eos_id >= 0
            and last_token == state.request.eos_id
        ):
            self._finish(slot)
            return True
        return False

    def _prefill(self, request: Request):
        """The target's prefill of one prompt: ``(padded, true_len, row,
        first [1], logp [1])``."""
        padded, true_len = pad_to_bucket(request.prompt, self.buckets)
        s = request.sampling
        dev = self.device
        row, first, logp = self.programs.prefill(
            self.model,
            torch.as_tensor(padded[None, :], device=dev),
            true_len,
            self._gen,
            torch.full((1,), s.temperature, dtype=torch.float32, device=dev),
            torch.full((1,), s.top_k, dtype=torch.int64, device=dev),
        )
        self._prefills += 1
        return padded, true_len, row, first, logp

    def _draft_row(self, padded: np.ndarray, true_len: int) -> Pool:
        """The draft's own prefill of a prompt (its row only: proposals
        are argmax draws, so its first token is not needed)."""
        row, _ = self.draft_programs.prefill_logits(
            self.draft_model,
            torch.as_tensor(padded[None, :], device=self.device),
            true_len,
        )
        return row

    def _admit_draft_row(self, slot: int, padded: np.ndarray,
                         true_len: int, draft_row: Optional[Pool] = None):
        """Seed the draft pool's slot row: land a streamed row, or run the
        draft's own prefill."""
        if draft_row is not None:
            row = self.draft_programs.place_row(draft_row)
        else:
            row = self._draft_row(padded, true_len)
        self.draft_programs.insert(self.draft_cache, row, slot)

    def _occupy(self, slot: int, state: _SlotState, first_tok: int,
                first_logp: float, true_len: int):
        state.generated.append(first_tok)
        state.logps.append(first_logp)
        self._slot_state[slot] = state
        self._tokens[slot] = first_tok
        self._positions[slot] = true_len
        self._temps[slot] = state.request.sampling.temperature
        self._topks[slot] = state.request.sampling.top_k

    def _admit_one(self, slot: int, request: Request, submit_t: float):
        state = _SlotState(
            request, submit_t=submit_t, admitted_t=time.perf_counter()
        )
        padded, true_len, row, first, logp = self._prefill(request)
        self.programs.insert(self.cache, row, slot)
        first_tok = int(first[0])
        self._occupy(slot, state, first_tok, float(logp[0]), true_len)
        if self.spec is not None:
            self._admit_draft_row(slot, padded, true_len)
        self._maybe_finish(slot, first_tok)

    def _admit_page(self, slot: int, page: PrefilledPage):
        """Resume a remotely prefilled request: land its KV row in the slot
        and pick up decoding after its (already sampled) first token; no
        prefill runs here."""
        request = page.request
        state = _SlotState(
            request, submit_t=page.submit_t, admitted_t=page.admitted_t
        )
        self.programs.insert(self.cache, self.programs.place_row(page.row),
                             slot)
        self._occupy(slot, state, page.first_token, page.first_logp,
                     page.true_len)
        if self.spec is not None:
            padded, _ = pad_to_bucket(request.prompt, self.buckets)
            self._admit_draft_row(slot, padded, page.true_len,
                                  draft_row=page.draft_row)
        self._maybe_finish(slot, page.first_token)

    def _to_host(self, row: Pool) -> Pool:
        """A device row as host tensors (pinned on a CUDA engine; the
        copies are queued on the stream, and the caller's next host read
        of a device value waits for them)."""
        if self.device.type != "cuda":
            return tuple(t.to("cpu") for t in row)
        out = []
        for t in row:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            out.append(host)
        return tuple(out)

    def _prefill_page(self, request: Request,
                      submit_t: float) -> PrefilledPage:
        """The prefill half of the disaggregated path: one prompt -> one
        page on the host (the stream a fleet puts on the wire)."""
        padded, true_len, row, first, logp = self._prefill(request)
        host_row = self._to_host(row)
        draft_row = None
        if self.draft_programs is not None:
            draft_row = self._to_host(self._draft_row(padded, true_len))
        nbytes = sum(t.numel() * t.element_size()
                     for t in host_row + (draft_row or ()))
        first_tok, first_logp = int(first[0]), float(logp[0])
        self._pages_out += 1
        self._page_bytes_out += nbytes
        return PrefilledPage(
            request=request,
            submit_t=submit_t,
            admitted_t=time.perf_counter(),
            true_len=int(true_len),
            first_token=first_tok,
            first_logp=first_logp,
            row=host_row,
            draft_row=draft_row,
            nbytes=nbytes,
        )

    def _finish(self, slot: int):
        state = self._slot_state[slot]
        done_t = time.perf_counter()
        result = RequestResult(
            uid=state.request.uid,
            prompt=state.request.prompt,
            tokens=np.asarray(state.generated, np.int64),
            logprobs=np.asarray(state.logps, np.float32),
            submit_t=state.submit_t,
            admitted_t=state.admitted_t,
            done_t=done_t,
        )
        self.results[state.request.uid] = result
        self._completed.append(
            (done_t, result.latency_s, len(state.generated))
        )
        self._requests_done += 1
        self._tokens_out += len(state.generated)
        self._slot_state[slot] = None
        self._tokens[slot] = 0
        self._positions[slot] = 0
        self._temps[slot] = 0.0
        self._topks[slot] = 0

    # -- the step loop --------------------------------------------------------

    def _device_state(self):
        dev = self.device
        return (torch.as_tensor(self._tokens, device=dev),
                torch.as_tensor(self._positions, device=dev),
                torch.as_tensor(self._temps, device=dev),
                torch.as_tensor(self._topks, device=dev))

    def step(self) -> int:
        """One scheduler tick.  Mixed and decode roles: admit pages, then
        prompts, into free slots and advance every live slot (one token
        plain, up to γ+1 speculating).  Prefill role: turn up to ``slots``
        queued prompts into outbox pages.  Returns the number of live
        slots decoded."""
        if self.parked:
            return 0
        self._step_i += 1
        t0 = time.perf_counter()
        if self.role == "prefill":
            lanes = 0
            while self._queue and lanes < self.slots:
                request, submit_t = self._queue.popleft()
                self.outbox.append(self._prefill_page(request, submit_t))
                lanes += 1
            self._occupancy.append(0.0)
            if self._step_i % self.telemetry_every == 0:
                self._emit_telemetry()
            return 0
        if not self.static_batching or not self._live_slots():
            for slot in self._free_slots():
                if self._page_queue:
                    self._admit_page(slot, self._page_queue.popleft())
                elif self._queue:
                    request, submit_t = self._queue.popleft()
                    self._admit_one(slot, request, submit_t)
                else:
                    break
        live = self._live_slots()
        if live:
            if self.spec is not None:
                self._spec_step(live)
            else:
                tokens, positions, temps, topks = self._device_state()
                next_tokens, logps = self.programs.decode_step(
                    self.model, self.cache, tokens, positions, self._gen,
                    temps, topks,
                )
                next_np = next_tokens.cpu().numpy()
                logp_np = logps.cpu().numpy()
                for slot in live:
                    state = self._slot_state[slot]
                    tok = int(next_np[slot])
                    state.generated.append(tok)
                    state.logps.append(float(logp_np[slot]))
                    self._tokens[slot] = tok
                    self._positions[slot] += 1
                    self._maybe_finish(slot, tok)
            self._step_lat.append(time.perf_counter() - t0)
        self._occupancy.append(len(live) / self.slots)
        if self._step_i % self.telemetry_every == 0:
            self._emit_telemetry()
        return len(live)

    def _spec_step(self, live: List[int]):
        """One speculative round for every live slot: the draft proposes
        γ, the target verifies the γ+1 chunk, n+1 tokens commit a slot.
        Free slots compute (and write) garbage the next insert
        overwrites, as in the plain step."""
        gamma = self.spec.spec_tokens
        tokens, positions, temps, topks = self._device_state()
        proposals = self.spec.propose(self.draft_model, self.draft_cache,
                                      tokens, positions)
        chunk = torch.cat([tokens[:, None], proposals], dim=1)
        emitted, emit_len, logps, accepted = self.spec.verify(
            self.model, self.cache, chunk, positions, self._gen, temps,
            topks,
        )
        em = emitted.cpu().numpy()
        lens = emit_len.cpu().numpy()
        lp = logps.cpu().numpy()
        acc = accepted.cpu().numpy()
        self._spec_rounds += 1
        for slot in live:
            state = self._slot_state[slot]
            if self._temps[slot] <= 0.0:
                # Acceptance counts greedy rows only: sampled rows accept
                # nothing by construction, not by the draft's quality.
                self._spec_proposed += gamma
                self._spec_accepted += int(acc[slot])
            n_emit = int(lens[slot])
            last_tok = int(em[slot, 0])
            finished = False
            for j in range(n_emit):
                tok = int(em[slot, j])
                state.generated.append(tok)
                state.logps.append(float(lp[slot, j]))
                last_tok = tok
                if len(state.generated) >= state.target or (
                    state.request.eos_id >= 0
                    and tok == state.request.eos_id
                ):
                    finished = True
                    break
            self._tokens[slot] = last_tok
            self._positions[slot] += n_emit
            if finished:
                self._finish(slot)

    def run(
        self,
        requests: Sequence[Request],
        max_steps: Optional[int] = None,
    ) -> Dict[str, RequestResult]:
        """Submit ``requests`` and step until all complete."""
        for request in requests:
            self.submit(request)
        return self.drain(max_steps=max_steps)

    def drain(
        self, max_steps: Optional[int] = None
    ) -> Dict[str, RequestResult]:
        """Step until the queue, the pages and the live slots are empty;
        returns every result so far (at once on a parked rank, whose
        requests the serving ranks carry)."""
        if self.parked:
            return self.results
        if max_steps is None:
            pending = len(self._queue) + len(self._live_slots()) \
                + len(self._page_queue)
            max_steps = 64 + 2 * sum(
                s.request.sampling.max_new_tokens
                for s in self._slot_state if s is not None
            ) + 2 * sum(
                r.sampling.max_new_tokens for r, _ in self._queue
            ) + 2 * sum(
                p.request.sampling.max_new_tokens for p in self._page_queue
            ) + 4 * pending
        for _ in range(max_steps):
            if not self._queue and not self._live_slots() \
                    and not self._page_queue:
                break
            self.step()
        else:
            raise RuntimeError(
                f"drain did not converge within {max_steps} steps "
                f"(queue={len(self._queue)}, live={self._live_slots()})"
            )
        self._emit_telemetry()
        return self.results

    # -- TP re-fold -----------------------------------------------------------

    def fold_tp(self, physical_tp: int) -> None:
        """Re-fold a live TP engine onto ``physical_tp`` ranks (a resize):
        the programs of the new fold swap in, and the weights and both KV
        pools move to it over the wire: the old fold's shards are gathered
        whole on rank 0 and cut into the new fold's, which rank 0 scatters
        (a fold to 1 keeps the whole model on rank 0; ranks left out are
        parked and drop theirs).  Queued and live requests carry on: a
        fold that takes parked ranks in copies rank 0's scheduler state
        and generator state to them.  Every rank of the logical width
        calls it; a fold back to a width seen before reuses its programs
        (the memo keys on ``(logical, physical)``)."""
        if self.tp is None:
            raise ValueError("fold_tp requires an engine built with tp > 1")
        if physical_tp == self.tp.physical_tp:
            return
        old, new = self.tp, self.tp.fold_to(physical_tp)
        programs = get_programs(
            self._base_config, self.slots, self.buckets,
            self.programs.max_top_k, device=self.device, tp=new,
        )
        self.model, self.cache = _refold(
            self.programs, programs, self.model, self.cache, True)
        if self.draft_programs is not None:
            draft_programs = get_programs(
                self._draft_base_config, self.slots, self.buckets,
                self.programs.max_top_k, device=self.device, tp=new,
            )
            self.draft_model, self.draft_cache = _refold(
                self.draft_programs, draft_programs, self.draft_model,
                self.draft_cache, self.spec is not None)
            self.draft_programs = draft_programs
            if self.spec is not None:
                self.spec = get_spec_programs(
                    programs, draft_programs, self.spec_tokens)
        self.programs = programs
        self.tp = new
        if new.physical_tp > old.physical_tp and new.member:
            self._sync_scheduler(new)
        logger.info("serve TP re-folded: logical=%d physical=%d (rank %d%s)",
                    new.logical_tp, new.physical_tp, new.rank,
                    ", parked" if self.parked else "")

    def _sync_scheduler(self, tp: ServeTPMesh) -> None:
        """Rank 0's scheduler and generator state onto every rank of the
        fold (one broadcast of the pickled state)."""
        import pickle

        state = None
        if tp.rank == 0:
            state = pickle.dumps((
                {k: v for k, v in vars(self).items()
                 if k not in _RANK_LOCAL_FIELDS},
                self._gen.get_state()))
        state = _broadcast_bytes(tp.wire, state, self.device)
        fields, gen_state = pickle.loads(state)
        for k, v in fields.items():
            setattr(self, k, v)
        self._gen.set_state(gen_state)

    def kv_device_bytes(self) -> int:
        """Bytes of the target KV pool on its device; on a TP fold the
        largest per-rank count."""
        return self.programs.pool_device_bytes(self.cache)

    # -- stats / telemetry ----------------------------------------------------

    def stats(self) -> Dict[str, float]:
        latencies = sorted(lat for _, lat, _ in self._completed)
        if len(self._completed) >= 2:
            t_first = self._completed[0][0]
            t_last = self._completed[-1][0]
            qps = (
                (len(self._completed) - 1) / (t_last - t_first)
                if t_last > t_first else 0.0
            )
        else:
            qps = 0.0
        occupancy = (
            sum(self._occupancy) / len(self._occupancy)
            if self._occupancy else 0.0
        )
        steps = sorted(self._step_lat)
        spec_rate = (
            self._spec_accepted / self._spec_proposed
            if self._spec_proposed else 0.0
        )
        return {
            "qps": qps,
            "p50_s": _nearest_rank(latencies, 0.50),
            "p95_s": _nearest_rank(latencies, 0.95),
            "p95_n": float(len(latencies)),
            "decode_step_p50_s": _nearest_rank(steps, 0.50),
            "decode_step_p95_s": _nearest_rank(steps, 0.95),
            "decode_step_n": float(len(steps)),
            "occupancy": occupancy,
            "slots": float(self.slots),
            "requests": float(self._requests_done),
            "tokens": float(self._tokens_out),
            "steps": float(self._step_i),
            "prefills": float(self._prefills),
            "spec_accept_rate": spec_rate,
            "spec_proposed": float(self._spec_proposed),
            "spec_accepted": float(self._spec_accepted),
            "spec_rounds": float(self._spec_rounds),
            "pages_in": float(self._pages_in),
            "pages_out": float(self._pages_out),
            "page_bytes_out": float(self._page_bytes_out),
        }

    def _emit_telemetry(self):
        stats = self.stats()
        telemetry.event(
            "serve",
            qps=stats["qps"], p50_s=stats["p50_s"], p95_s=stats["p95_s"],
            p95_n=int(stats["p95_n"]),
            occupancy=stats["occupancy"], slots=int(stats["slots"]),
            requests=int(stats["requests"]), tokens=int(stats["tokens"]),
            spec_accept_rate=stats["spec_accept_rate"],
            spec_proposed=int(stats["spec_proposed"]),
            spec_accepted=int(stats["spec_accepted"]),
            decode_step_p95_s=stats["decode_step_p95_s"],
        )

    # -- live weight hot-swap -------------------------------------------------

    def swap_weights(self, checkpoint_dir: str) -> Dict[str, Any]:
        """Replace the target model's weights with the newest committed
        checkpoint in ``checkpoint_dir``, live.

        No drain and no rebuild: the weights land in fresh tensors on the
        engine's device that are assigned into the model between two
        steps; queued requests keep their places, live slots their KV rows,
        and the KV pool its memory.  The integrity chain: the
        :class:`~dlrover_tpu_torch.checkpoint.engine.StorageStepReader`
        yields only bytes whose digest sidecar and shard crcs verify; the
        records are folded into a host digest (``hotswap.host_digest``,
        the reference's); after landing, the model's tensors are digested
        where they lie (``hotswap.device_digest``: the byte-sum kernel on
        the card) and must reproduce it.  A mismatch — the ``serve.swap``
        seam injects one by flipping a landed mantissa bit — restores the
        prior tensors, which are kept until the compare passes.  Every
        outcome books a ``serve.swap`` telemetry event.

        On a TP fold each rank swaps its own slices of the weights and
        checks its digest against its own host copy of them; a parked rank
        swaps nothing (``parked`` in its report).

        Returns a report (``ok``, ``rolled_back``, ``version``, ``step``,
        ``digest``, ``seconds``); raises ``ValueError`` when the checkpoint
        cannot map onto the model (a missing leaf, or a drifted shape or
        dtype: an fp32 training checkpoint does not swap into bf16 serving
        weights) and ``RuntimeError`` when no verifiable step exists.
        """
        from dlrover_tpu_torch.checkpoint.engine import StorageStepReader

        if self.parked:
            # The fold that takes this rank in again brings rank 0's
            # weights and version.
            return {"ok": True, "rolled_back": False, "parked": True,
                    "version": self.weights_version, "step": None,
                    "digest": None, "seconds": 0.0}
        t0 = time.perf_counter()
        reader = StorageStepReader(checkpoint_dir, num_hosts=1,
                                   device="cpu")
        loaded_step, arrays = reader.load_from_storage()
        if arrays is None:
            raise RuntimeError(
                f"no verifiable committed step in {checkpoint_dir}")
        if self.programs.sharded:
            # Each rank of a fold swaps its own slices, checked against
            # its own host copy of them.
            cfg = self.programs.config
            whole = {n: torch.empty(shape, dtype=cfg.param_dtype,
                                    device="meta")
                     for n, shape in param_shapes(cfg).items()}
            sources = self.tp.split_params(
                hotswap.map_checkpoint_to_params(arrays, whole), cfg)
        else:
            sources = hotswap.map_checkpoint_to_params(arrays, self.model)
        reference = hotswap.host_digest(sources)
        prior = self.model.state_dict()
        landed = {name: torch.empty_like(t).copy_(sources[name],
                                                  non_blocking=True)
                  for name, t in prior.items()}
        self.model.load_state_dict(landed, assign=True)
        try:
            faults.fire("serve.swap", step=loaded_step)
        except faults.FaultInjected:
            # The scripted corruption: one flipped bit in the landed
            # tensors; the digest compare below must catch it.
            hotswap.flip_param_bit(self.model)
        device_digest = int(hotswap.device_digest(self.model))
        ok = device_digest == reference
        if self.programs.sharded:
            # One rank's mismatch rolls every rank of the fold back.
            vote = torch.tensor([int(ok)], dtype=torch.int64)
            self.tp.wire.all_reduce(vote, op=torch.distributed.ReduceOp.MIN)
            ok = bool(vote.item())
        rolled_back = False
        if not ok:
            # Corrupted weights never answer a request.
            self.model.load_state_dict(prior, assign=True)
            rolled_back = True
            logger.error(
                "hot-swap REJECTED: swapped digest %s != checkpoint "
                "reference %s; rolled back to version %d",
                format_digest(device_digest), format_digest(reference),
                self.weights_version,
            )
        else:
            self.weights_version += 1
            logger.info(
                "hot-swap: step %d live as weights version %d (digest %s)",
                loaded_step, self.weights_version,
                format_digest(device_digest),
            )
        del prior, landed
        seconds = time.perf_counter() - t0
        telemetry.event(
            "serve.swap", duration_s=seconds, ok=ok,
            rolled_back=rolled_back, version=self.weights_version,
            step=loaded_step, digest=format_digest(device_digest),
        )
        if self.client is not None:
            self.client.report_event("serve.swap", json.dumps({
                "ok": ok, "rolled_back": rolled_back,
                "version": self.weights_version, "step": loaded_step,
            }))
        return {
            "ok": ok, "rolled_back": rolled_back,
            "version": self.weights_version, "step": loaded_step,
            "digest": format_digest(device_digest),
            "seconds": seconds,
        }

    # -- warm-up --------------------------------------------------------------

    def aot_compile(self) -> float:
        """Build and load the kernels the serving path launches ahead of
        the first request (the target's and the draft's: the reference
        compiles its programs here; eager PyTorch has nothing to compile),
        booked as a ``compile`` telemetry event (``cached`` when nothing
        was left to load).  Returns wall seconds."""
        seconds = self.programs.warmup()
        if self.draft_programs is not None:
            seconds += self.draft_programs.warmup()
        telemetry.event("compile", duration_s=seconds,
                        cached=seconds == 0.0, phase="serve_aot")
        if self.client is not None:
            self.client.report_event("compile", json.dumps({
                "seconds": round(seconds, 6), "restart": False,
                "cached": seconds == 0.0, "phase": "serve_aot",
            }))
        return seconds

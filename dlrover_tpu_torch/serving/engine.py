"""Continuous-batching serving engine (port of
``dlrover_tpu/serving/engine.py``, ``role="mixed"``).

The host side of the serving plane: an admission queue in front of the
slotted decode operations (:mod:`dlrover_tpu_torch.serving.decode`).  Each
live request owns one KV-cache slot; one ``decode_step`` advances every
occupied slot one token, and a request that finishes frees its slot for
the next queued request on the very next step.  ``static_batching=True``
is the baseline: admission waits until the whole pool drains.

Not in this slice: tensor parallelism and re-folding, disaggregated
prefill (``role="prefill"``/``"decode"``, pages), speculative decoding,
the fault-injection admission seam and its retry policy, telemetry
events, the memory registry and weight hot-swap.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.models.transformer import TransformerConfig
from dlrover_tpu_torch.rl.generation import SamplingParams
from dlrover_tpu_torch.runtime.device import DeviceLike
from dlrover_tpu_torch.serving.bucketing import (
    make_buckets,
    pad_to_bucket,
    pick_bucket,
)
from dlrover_tpu_torch.serving.decode import ServePrograms


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


def _nearest_rank(sorted_values: Sequence[float], p: float) -> float:
    """The nearest-rank quantile (ceil(p*n)-th order statistic): an actual
    observed sample."""
    n = len(sorted_values)
    if n == 0:
        return 0.0
    return sorted_values[min(n - 1, max(0, math.ceil(p * n) - 1))]


class ServingEngine:
    """Slot-pool scheduler bound to one (config, params) pair on one
    device (``cuda`` unless ``device="cpu"`` is asked for)."""

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
        device: DeviceLike = None,
    ):
        if buckets is None:
            buckets = make_buckets(max(1, config.max_seq_len // 2))
        self.programs = ServePrograms(
            config, slots, tuple(buckets), max_top_k, device=device
        )
        self.device = self.programs.device
        self.model = self.programs.place_params(params)
        self.slots = slots
        self.buckets = self.programs.buckets
        self.static_batching = static_batching
        self.cache = self.programs.init_cache()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._slot_state: List[Optional[_SlotState]] = [None] * slots
        self._tokens = np.zeros((slots,), np.int64)
        self._positions = np.zeros((slots,), np.int64)
        self._temps = np.zeros((slots,), np.float32)
        self._topks = np.zeros((slots,), np.int64)
        self._queue: Deque[Tuple[Request, float]] = deque()
        self.results: Dict[str, RequestResult] = {}
        self._step_i = 0
        self._completed: Deque[Tuple[float, float, int]] = deque(maxlen=512)
        self._occupancy: Deque[float] = deque(maxlen=256)
        # Wall seconds of each step that decoded at least one live slot.
        self._step_lat: Deque[float] = deque(maxlen=512)
        self._requests_done = 0
        self._tokens_out = 0
        self._prefills = 0

    # -- admission ------------------------------------------------------------

    def submit(self, request: Request) -> str:
        """Queue a request; raises ``ValueError`` for one that can never
        be admitted."""
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
        bucket = pick_bucket(prompt.size, self.buckets)
        max_seq = self.programs.config.max_seq_len
        if bucket + n_new > max_seq:
            raise ValueError(
                f"request {request.uid}: bucket {bucket} + max_new_tokens "
                f"{n_new} exceeds max_seq_len {max_seq}"
            )
        if request.sampling.top_k > max(1, self.programs.max_top_k):
            raise ValueError(
                f"request {request.uid}: top_k {request.sampling.top_k} "
                f"exceeds the engine's max_top_k {self.programs.max_top_k}"
            )
        request = dataclasses.replace(request, prompt=prompt)
        self._queue.append((request, time.perf_counter()))
        return request.uid

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

    def _admit_one(self, slot: int, request: Request, submit_t: float):
        padded, true_len = pad_to_bucket(request.prompt, self.buckets)
        state = _SlotState(
            request, submit_t=submit_t, admitted_t=time.perf_counter()
        )
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
        self.programs.insert(self.cache, row, slot)
        self._prefills += 1
        first_tok = int(first[0])
        state.generated.append(first_tok)
        state.logps.append(float(logp[0]))
        self._slot_state[slot] = state
        self._tokens[slot] = first_tok
        self._positions[slot] = true_len
        self._temps[slot] = s.temperature
        self._topks[slot] = s.top_k
        self._maybe_finish(slot, first_tok)

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

    def step(self) -> int:
        """One scheduler tick: admit queued prompts into free slots, then
        advance every live slot one token.  Returns the number of live
        slots decoded."""
        self._step_i += 1
        t0 = time.perf_counter()
        if not self.static_batching or not self._live_slots():
            for slot in self._free_slots():
                if not self._queue:
                    break
                request, submit_t = self._queue.popleft()
                self._admit_one(slot, request, submit_t)
        live = self._live_slots()
        if live:
            dev = self.device
            next_tokens, logps = self.programs.decode_step(
                self.model,
                self.cache,
                torch.as_tensor(self._tokens, device=dev),
                torch.as_tensor(self._positions, device=dev),
                self._gen,
                torch.as_tensor(self._temps, device=dev),
                torch.as_tensor(self._topks, device=dev),
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
        return len(live)

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
        if max_steps is None:
            pending = len(self._queue) + len(self._live_slots())
            max_steps = 64 + 2 * sum(
                s.request.sampling.max_new_tokens
                for s in self._slot_state if s is not None
            ) + 2 * sum(
                r.sampling.max_new_tokens for r, _ in self._queue
            ) + 4 * pending
        for _ in range(max_steps):
            if not self._queue and not self._live_slots():
                break
            self.step()
        else:
            raise RuntimeError(
                f"drain did not converge within {max_steps} steps "
                f"(queue={len(self._queue)}, live={self._live_slots()})"
            )
        return self.results

    # -- stats ----------------------------------------------------------------

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
        }

    def warmup(self) -> float:
        """Build and load the kernels the serving path launches ahead of
        the first request (the JAX engine's ``aot_compile``).  Returns
        wall seconds."""
        return self.programs.warmup()

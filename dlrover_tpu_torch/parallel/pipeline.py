"""The pipeline over the ``pipe`` axis (port of
``dlrover_tpu/parallel/pipeline.py``).

The reference keeps the layer stack as ``[S, L / S, ...]`` with the stage
dim on ``pipe`` and runs every stage in one SPMD program: at each tick all
stages compute and a rolling buffer shifts one slot (a collective-permute
over ICI), microbatches streaming in at stage 0 and out of stage ``S -
1``.  Here each process runs one stage.  :class:`PipelinedBlocks` holds
the schedule and runs this rank's part of it; the handoffs are neighbour
sends on the pipe axis's wire (``parallel/wire.Wire.send``/``recv``):
activations forward, gradients backward.

* GPipe (``pipeline_interleave=1``): ``M + S - 1`` ticks; at tick ``t``
  stage ``s`` runs microbatch ``t - s`` through its ``L / S`` layers.  The
  backward is the same schedule reversed, last stage first, as the
  reference's AD reverses its tick scan.
* Circular (``pipeline_interleave=v``): ``vM + S - 1`` ticks of one chunk
  of ``L / (S v)`` layers each.  At tick ``t`` stage ``s`` runs item ``i =
  t - s``: lap ``i // M`` of microbatch ``i % M``, global chunk ``(i //
  M) S + s``.  An item leaving stage ``S - 1`` re-enters stage 0 ``M - S +
  1`` ticks later: the reference's recirculation queue is here the sends
  waiting on stage 0's side of the wire.
* Storage is stage-contiguous under both (stage ``s`` holds the layers
  ``[s L / S, (s + 1) L / S)``), so checkpoint records are the same under
  every ``v``.  The circular schedule needs stage ``s`` to run the chunks
  ``{s, S + s, ...}``: each step the stages swap the layers they lend and
  borrow (the reference's per-step weight all-to-all), and the gradients
  of the borrowed layers go back to their owners after the backward.

A stage keeps the graph of each microbatch it ran (its input a leaf) until
the backward, as the reference's AD keeps its per-tick residuals; each
block runs under the config's remat policy.  The whole schedule is one
``torch.autograd.Function``: the last stage's output feeds the head and
the loss, the other stages return a 0-d zero tied to the schedule, so
every rank's ``backward()`` drives its part of the reverse schedule.
Without a pipe axis above 1 the stages all run here: the microbatches go
through every layer in turn (the same function).

:data:`COUNTS` books the schedule: ``passes`` (forward passes), ``ticks``
(``M + S - 1`` or ``vM + S - 1`` each), ``useful_ticks`` (ticks this rank
computed), ``handoff_bytes`` (activations and gradients sent to a
neighbour stage) and ``relayout_bytes`` (layers lent and their gradients
returned).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.ops import remat_policy
from dlrover_tpu_torch.parallel.sharding import swapped_params

COUNTS = {"passes": 0, "ticks": 0, "useful_ticks": 0, "handoff_bytes": 0,
          "relayout_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def validate(config) -> None:
    """The reference's checks of a pipelined stack, in its order (its
    ``PipelinedBlocks.__call__``); the batch is checked per call."""
    if config.num_layers % config.pipeline_stages:
        raise ValueError(
            f"num_layers {config.num_layers} not divisible by "
            f"pipeline_stages {config.pipeline_stages}")
    if config.num_experts:
        raise NotImplementedError(
            "MoE aux loss accounting inside bubble ticks is not defined; "
            "pipeline_stages>1 requires num_experts=0 (the reference "
            "refuses it too: not a remainder of the port)")


class _Borrowed:
    """A layer another stage stores, run in a stage's own block module
    (every block has the same structure) with its parameters swapped
    for the received ones."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.tensors = tensors

    def run(self, module, *args):
        with swapped_params(module, self.tensors):
            return module(*args)


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pipe, blocks, side, act, x):
        y, saved, borrowed = pipe._forward(blocks, x, side, act, grad=True)
        ctx.state = (pipe, blocks, saved, borrowed)
        return y

    @staticmethod
    def backward(ctx, gy):
        pipe, blocks, saved, borrowed = ctx.state
        ctx.state = None
        dx = pipe._backward(saved, gy)
        pipe._return_grads(blocks, borrowed)
        return None, None, None, None, dx


class PipelinedBlocks:
    """The blocks of a ``pipeline_stages > 1`` config as a schedule of
    stages; ``group`` (``parallel/sharding.PipeGroup``) is this rank's
    stage on the pipe axis, None when every stage runs here."""

    def __init__(self, config, group=None):
        self.config = config
        self.group = group if group is not None and group.size > 1 else None
        self.stages = config.pipeline_stages
        self.interleave = config.pipeline_interleave
        self.num_micro = config.num_microbatches or self.stages
        self.per_stage = config.num_layers // self.stages
        self.per_chunk = config.num_layers // (self.stages * self.interleave)

    @property
    def ticks(self) -> int:
        return self.interleave * self.num_micro + self.stages - 1

    @property
    def stage(self) -> int:
        return self.group.stage if self.group is not None else 0

    def chunk_layers(self, lap: int) -> range:
        """The global layers this stage runs on lap ``lap``."""
        c = lap * self.stages + self.stage
        return range(c * self.per_chunk, (c + 1) * self.per_chunk)

    def __call__(self, blocks: Dict[int, torch.nn.Module],
                 x: Optional[torch.Tensor], positions, segment_ids,
                 act_shape: Tuple[int, ...], device) -> torch.Tensor:
        """``blocks`` (global index -> block) held here; ``x`` the embedded
        batch ``[B, S, d]`` on the first stage (None elsewhere).  Returns
        the last layer's output on the last stage, a 0-d zero
        elsewhere."""
        batch = act_shape[0]
        if batch % self.num_micro:
            raise ValueError(
                f"batch {batch} not divisible by num_microbatches "
                f"{self.num_micro}")
        side = list(zip(self._side(positions, "positions", batch),
                        self._side(segment_ids, "segment_ids", batch)))
        COUNTS["passes"] += 1
        COUNTS["ticks"] += self.ticks
        COUNTS["useful_ticks"] += self.interleave * self.num_micro
        if self.group is None:
            return self._local(blocks, x, side)
        act = (tuple(act_shape), device)
        if not torch.is_grad_enabled():
            return self._forward(blocks, x, side, act, grad=False)[0]
        if x is None:
            # The stage's part of the graph hangs on this leaf.
            x = torch.zeros((), device=device, requires_grad=True)
        return _Schedule.apply(self, blocks, side, act, x)

    def _side(self, arr, name: str, batch: int) -> list:
        """A side input for each microbatch: ``arr`` itself when absent
        or broadcast (a leading dim of 1), else its rows of the
        microbatch."""
        if arr is None or arr.shape[0] == 1:
            return [arr] * self.num_micro
        if arr.shape[0] != batch:
            raise ValueError(
                f"{name} leading dim {arr.shape[0]} must be 1 or match the "
                f"batch {batch} under pipeline microbatching")
        return list(arr.split(batch // self.num_micro))

    def _run(self, block, h, pos, seg, borrowed=None):
        cfg = self.config
        if borrowed is not None:
            h, _ = remat_policy.run(cfg.remat, borrowed.run, block, h, pos,
                                    seg)
        else:
            h, _ = remat_policy.run(cfg.remat, block, h, pos, seg)
        return h

    def _microbatches(self, x, rows: int):
        """The batch's microbatches of ``rows`` rows, in order."""
        return x.split(rows)

    def _local(self, blocks, x, side):
        mb = x.shape[0] // self.num_micro
        outs = []
        for m, h in enumerate(self._microbatches(x, mb)):
            pos, seg = side[m]
            for i in sorted(blocks):
                h = self._run(blocks[i], h, pos, seg)
            outs.append(h)
        return torch.cat(outs)

    # -- the distributed schedule -------------------------------------------

    def _lent(self):
        """``(layer, owner, user)`` of each layer the circular schedule
        runs on another stage than the one that stores it."""
        for layer in range(self.config.num_layers):
            owner = layer // self.per_stage
            user = (layer // self.per_chunk) % self.stages
            if owner != user:
                yield layer, owner, user

    @staticmethod
    def _flat_like(params) -> torch.Tensor:
        return torch.empty(sum(p.numel() for p in params),
                           dtype=params[0].dtype, device=params[0].device)

    def _relayout(self, blocks, grad: bool) -> Dict[int, _Borrowed]:
        """Lend this stage's layers that another stage runs under the
        circular schedule, borrow those it runs and does not store: one
        exchange on the pipe wire.  Returns the borrowed layers."""
        if self.interleave == 1:
            return {}
        s = self.stage
        shell = blocks[min(blocks)]
        sends, recvs = [], {}
        for layer, owner, user in self._lent():
            if s == owner:
                flat = torch.cat([p.detach().reshape(-1)
                                  for p in blocks[layer].parameters()])
                sends.append((flat, user - s))
                COUNTS["relayout_bytes"] += _nbytes(flat)
            elif s == user:
                recvs[layer] = (self._flat_like(list(shell.parameters())),
                                owner - s)
        self.group.wire.exchange(sends, list(recvs.values()))
        out = {}
        for layer, (flat, _) in recvs.items():
            tensors, at = {}, 0
            for n, p in shell.named_parameters():
                t = flat[at:at + p.numel()].view(p.shape).detach()
                tensors[n] = t.requires_grad_(grad)
                at += p.numel()
            out[layer] = _Borrowed(tensors)
        return out

    def _return_grads(self, blocks, borrowed: Dict[int, _Borrowed]) -> None:
        """The borrowed layers' gradients back to the stages that store
        them, added to their parameters' gradients."""
        if self.interleave == 1:
            return
        s = self.stage
        sends, recvs = [], []
        for layer, owner, user in self._lent():
            if s == user:
                flat = torch.cat([
                    (t.grad if t.grad is not None else torch.zeros_like(t)
                     ).reshape(-1) for t in borrowed[layer].tensors.values()])
                sends.append((flat, owner - s))
                COUNTS["relayout_bytes"] += _nbytes(flat)
            elif s == owner:
                params = list(blocks[layer].parameters())
                recvs.append((self._flat_like(params), user - s, params))
        self.group.wire.exchange(sends, [(f, st) for f, st, _ in recvs])
        with torch.no_grad():
            for flat, _, params in recvs:
                at = 0
                for p in params:
                    g = flat[at:at + p.numel()].view(p.shape)
                    p.grad = g.clone() if p.grad is None else p.grad + g
                    at += p.numel()

    def _chunk(self, blocks, borrowed, lap, h, pos, seg):
        for layer in self.chunk_layers(lap):
            if layer in borrowed:
                h = self._run(blocks[min(blocks)], h, pos, seg,
                              borrowed[layer])
            else:
                h = self._run(blocks[layer], h, pos, seg)
        return h

    def _forward(self, blocks, x, side, act, grad: bool):
        """This stage's forward ticks: ``(output, saved graphs, borrowed
        layers)``; the output is the last layer's ``[B, S, d]`` on the
        last stage, a 0-d zero elsewhere.  ``act`` is the whole batch's
        activation shape and the device."""
        g, s = self.group, self.stage
        last = s == self.stages - 1
        m_count, v = self.num_micro, self.interleave
        act_shape, device = act
        mb = act_shape[0] // m_count
        mb_shape = (mb,) + tuple(act_shape[1:])
        dtype = self.config.dtype
        borrowed = self._relayout(blocks, grad)
        xs = self._microbatches(x, mb) if s == 0 else None
        saved: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        ys: List[Optional[torch.Tensor]] = [None] * m_count
        sends = []
        for t in range(self.ticks):
            i = t - s
            if not 0 <= i < v * m_count:
                continue
            lap, m = divmod(i, m_count)
            if s == 0 and lap == 0:
                inp = xs[m].detach()
            else:
                inp = torch.empty(mb_shape, dtype=dtype, device=device)
                g.wire.recv(inp, step=-1)
            pos, seg = side[m]
            ctx = torch.enable_grad() if grad else contextlib.nullcontext()
            with ctx:
                if grad:
                    inp.requires_grad_(True)
                out = self._chunk(blocks, borrowed, lap, inp, pos, seg)
            if grad:
                saved[i] = (inp, out)
            if last and lap == v - 1:
                ys[m] = out.detach()
            else:
                sent = out.detach().contiguous()
                sends.append((g.wire.send(sent, step=1), sent))
                COUNTS["handoff_bytes"] += _nbytes(sent)
        for pending, _ in sends:
            pending.wait()
        y = torch.cat(ys) if last else torch.zeros((), dtype=dtype,
                                                   device=device)
        return y, saved, borrowed

    def _backward(self, saved, gy) -> Optional[torch.Tensor]:
        """The reverse schedule: each saved graph's backward in reverse
        tick order, the input gradients handed to the previous stage;
        returns the first stage's gradient of ``x``."""
        g, s = self.group, self.stage
        last = s == self.stages - 1
        m_count, v = self.num_micro, self.interleave
        gys = gy.split(gy.shape[0] // m_count) if last else None
        dxs: List[Optional[torch.Tensor]] = [None] * m_count
        sends = []
        for t in reversed(range(self.ticks)):
            i = t - s
            if not 0 <= i < v * m_count:
                continue
            lap, m = divmod(i, m_count)
            inp, out = saved.pop(i)
            if last and lap == v - 1:
                grad_out = gys[m].contiguous()
            else:
                grad_out = torch.empty_like(out)
                g.wire.recv(grad_out, step=1)
            torch.autograd.backward(out, grad_out)
            grad_in = inp.grad
            if s == 0 and lap == 0:
                dxs[m] = grad_in
            else:
                sends.append((g.wire.send(grad_in, step=-1), grad_in))
                COUNTS["handoff_bytes"] += _nbytes(grad_in)
        for pending, _ in sends:
            pending.wait()
        return torch.cat(dxs) if s == 0 else None

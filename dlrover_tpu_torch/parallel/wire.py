"""The mesh axes' wires: the collectives the port issues, and what they
carry.

The reference's collectives ride mesh axes that XLA lowers onto the
interconnect.  Here a collective names a ``torch.distributed`` group.
:class:`Wire` wraps one and keeps two books in :data:`COUNTS`:

* ``bytes``: the payload handed to each kind of collective, by leg
  (``all_reduce``, ``reduce_scatter``, ``all_gather``, ``all_to_all``,
  ``send``, ``broadcast``, ``gather``, ``scatter``), each tensor counted
  once per call as its element count times its item size (a scatter's
  on its source only, a neighbour hop's on its sender only: ``shift``,
  ``send`` and the exchange of several tensors in one hop are one
  ``send`` call);
* ``axes``: the same bytes by axis and leg (``"fsdp/all_gather"``; the
  axis a :class:`Wire` was built for, ``"world"`` for one built without);
* ``calls``: the collectives issued, by axis and leg;
* ``staged``: host staging copies (and ``staged_axes``, by axis).  NCCL takes CUDA tensors; gloo, the
  CPU backend, takes host tensors.  A group whose backend is gloo gets a
  CUDA payload copied to the host before the collective and the result
  copied back after it, each copy counted here.  That is what runs two
  processes on one card: the compute stays on the card and the wire
  goes through the host.  The caller picks the backend; nothing here
  switches it.

Every call may be asynchronous (``async_op=True``): it returns a
:class:`Pending` whose ``wait()`` completes the collective and the copy
back.  While a capture window is armed (``utils/device_profile.armed``)
each call opens a host range ``wire:<axis>/<leg>`` at its issue and
closes it at its completion, which the window's parser books as the
collective's interval and leg: gloo's collectives never reach the card's
trace.  Issue order is the match order across ranks, so callers issue in
one agreed order (``parallel/overlap.py``'s plan).
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.utils import device_profile as _dp

#: Bytes handed to collectives by leg, and host staging copies; a run sets
#: them to 0 (:func:`reset_counts`) and reads them back.
COUNTS = {"bytes": collections.Counter(), "axes": collections.Counter(),
          "calls": collections.Counter(), "staged": 0,
          "staged_axes": collections.Counter()}


def reset_counts() -> None:
    COUNTS["bytes"].clear()
    COUNTS["axes"].clear()
    COUNTS["calls"].clear()
    COUNTS["staged"] = 0
    COUNTS["staged_axes"].clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Pending:
    """An issued collective: ``wait()`` completes it, copies staged
    results back to the card and runs the callbacks of ``then``."""

    def __init__(self, works, copies: List[Tuple[torch.Tensor, torch.Tensor]],
                 axis: str = "world", leg_range=None):
        self._works = [w for w in works if w is not None]
        self._copies = copies
        self._axis = axis
        self._range = leg_range
        self._thens: List[Callable[[], None]] = []
        self.done = False

    def then(self, fn: Callable[[], None]) -> "Pending":
        """Run ``fn()`` once the collective completes (now, if it has)."""
        if self.done:
            fn()
        else:
            self._thens.append(fn)
        return self

    def wait(self):
        if self.done:
            return
        for w in self._works:
            w.wait()
        for dst, host in self._copies:
            dst.copy_(host)
            COUNTS["staged"] += 1
            COUNTS["staged_axes"][self._axis] += 1
        self.done = True
        _dp.close_range(self._range)
        for fn in self._thens:
            fn()


class Wire:
    """One process group and its collectives.  ``group=None`` is the
    default group; ``axis`` names the mesh axis the group spans, for the
    counts."""

    def __init__(self, group=None, axis: str = "world"):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a Wire needs an initialized process group")
        self.group = group
        self.axis = axis
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self._hosts = None

    def _stage(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def _count(self, leg: str, t: torch.Tensor):
        """Book one call of ``leg``; returns its open host range, if a
        capture is armed."""
        COUNTS["bytes"][leg] += _nbytes(t)
        COUNTS["axes"][f"{self.axis}/{leg}"] += _nbytes(t)
        COUNTS["calls"][f"{self.axis}/{leg}"] += 1
        return _dp.leg_range(self.axis, leg)

    def _staged(self) -> None:
        COUNTS["staged"] += 1
        COUNTS["staged_axes"][self.axis] += 1

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        if self._stage(t):
            self._staged()
            return t.cpu()
        return t

    def _out(self, t: torch.Tensor, copies) -> torch.Tensor:
        if self._stage(t):
            host = torch.empty(t.shape, dtype=t.dtype)
            copies.append((t, host))
            return host
        return t

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   async_op: bool = False) -> Pending:
        """In place: ``t`` becomes the reduction over the group."""
        rng = self._count("all_reduce", t)
        copies: list = []
        if self._stage(t):
            self._staged()
            host = t.cpu()
            copies.append((t, host))
        else:
            host = t
        work = dist.all_reduce(host, op=op, group=self.group,
                               async_op=async_op)
        return self._finish(work, copies, async_op, rng)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor,
                       async_op: bool = False) -> Pending:
        """``out`` (contiguous, 1/n of ``inp``'s elements) becomes this
        rank's block of the flattened sum over the group."""
        rng = self._count("reduce_scatter", inp)
        copies: list = []
        work = dist.reduce_scatter_tensor(
            self._out(out, copies).view(-1), self._in(inp).reshape(-1),
            group=self.group, async_op=async_op)
        return self._finish(work, copies, async_op, rng)

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor,
                   async_op: bool = False) -> Pending:
        """``out`` (contiguous, n times ``inp``'s elements) becomes every
        rank's ``inp``, flattened, in rank order."""
        rng = self._count("all_gather", inp)
        copies: list = []
        work = dist.all_gather_into_tensor(
            self._out(out, copies).view(-1), self._in(inp).reshape(-1),
            group=self.group, async_op=async_op)
        return self._finish(work, copies, async_op, rng)

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor,
                   async_op: bool = False) -> Pending:
        """Block ``j`` of ``inp`` (dim 0 in n equal blocks) goes to rank
        ``j``; block ``j`` of ``out`` comes from rank ``j``."""
        rng = self._count("all_to_all", inp)
        copies: list = []
        work = dist.all_to_all_single(self._out(out, copies), self._in(inp),
                                      group=self.group, async_op=async_op)
        return self._finish(work, copies, async_op, rng)

    def gather(self, out: Optional[torch.Tensor],
               inp: torch.Tensor) -> None:
        """Every rank's ``inp`` to group rank 0: there ``out`` (``[n,
        *inp.shape]``) becomes them in rank order; elsewhere ``out`` is
        not read (None will do)."""
        rng = self._count("gather", inp)
        copies: list = []
        parts = None
        if self.rank == 0:
            parts = list(self._out(out, copies).unbind(0))
        dist.gather(self._in(inp).contiguous(), gather_list=parts,
                    dst=self._root(), group=self.group)
        self._finish(None, copies, False, rng)

    def scatter(self, out: torch.Tensor,
                inp: Optional[torch.Tensor]) -> None:
        """Row ``j`` of group rank 0's ``inp`` (``[n, *out.shape]``) to
        rank ``j``'s ``out``; ``inp`` is read on rank 0 only."""
        copies: list = []
        parts = None
        rng = None
        if self.rank == 0:
            rng = self._count("scatter", inp)
            parts = list(self._in(inp).contiguous().unbind(0))
        dist.scatter(self._out(out, copies), scatter_list=parts,
                     src=self._root(), group=self.group)
        self._finish(None, copies, False, rng)

    def _root(self) -> int:
        """The global rank of the group's rank 0."""
        if self.group is None:
            return 0
        return dist.get_global_rank(self.group, 0)

    def _peer(self, step: int) -> int:
        """The global rank of group rank ``rank + step`` (mod n)."""
        r = (self.rank + step) % self.size
        return dist.get_global_rank(self.group, r) \
            if self.group is not None else r

    def exchange(self, sends, recvs, async_op: bool = False) -> Pending:
        """Neighbour sends and receives posted at once: each ``(tensor,
        step)`` of ``sends`` goes to group rank ``rank + step``, each of
        ``recvs`` (contiguous) comes from ``rank + step`` (mod n).  One
        ``send`` call on the books, each sent tensor's bytes under it."""
        rng = None
        if sends:
            for t, _ in sends:
                COUNTS["bytes"]["send"] += _nbytes(t)
                COUNTS["axes"][f"{self.axis}/send"] += _nbytes(t)
            COUNTS["calls"][f"{self.axis}/send"] += 1
            rng = _dp.leg_range(self.axis, "send")
        copies: list = []
        ops = [dist.P2POp(dist.isend, self._in(t).contiguous(),
                          self._peer(step), self.group)
               for t, step in sends]
        ops += [dist.P2POp(dist.irecv, self._out(t, copies),
                           self._peer(step), self.group)
                for t, step in recvs]
        works = dist.batch_isend_irecv(ops) if ops else []
        pending = Pending(works, copies, self.axis, rng)
        if not async_op:
            pending.wait()
        return pending

    def shift(self, send, recv, step: int = 1,
              async_op: bool = False) -> Pending:
        """One ring hop: ``send`` (a tensor, or a list of them) goes to
        rank + ``step``, ``recv`` (as many, contiguous) comes from rank -
        ``step`` (mod n); ``step=-1`` hops the other way.  With
        ``async_op`` the hop is posted and the :class:`Pending` returned
        at once (ring attention posts its next hop before the chunk
        math)."""
        sends = list(send) if isinstance(send, (list, tuple)) else [send]
        recvs = list(recv) if isinstance(recv, (list, tuple)) else [recv]
        return self.exchange([(t, step) for t in sends],
                         [(t, -step) for t in recvs], async_op)

    def send(self, t: torch.Tensor, step: int = 1) -> Pending:
        """A neighbour send to rank + ``step`` (mod n), posted at once:
        the pipeline's stage handoff (activations forward, gradients
        backward).  The matching :meth:`recv` may come later."""
        return self.exchange([(t, step)], [], True)

    def recv(self, t: torch.Tensor, step: int = -1) -> None:
        """In place: ``t`` (contiguous) becomes what rank + ``step`` (mod
        n) sent it, in the order that rank's sends to this one were
        posted."""
        self.exchange([], [(t, step)], False)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> None:
        """In place, from group rank ``src``."""
        rng = self._count("broadcast", t)
        copies: list = []
        if self._stage(t):
            self._staged()
            host = t.cpu()
            copies.append((t, host))
        else:
            host = t
        root = (dist.get_global_rank(self.group, src)
                if self.group is not None else src)
        work = dist.broadcast(host, src=root, group=self.group)
        self._finish(work, copies, False, rng)

    def _finish(self, work, copies, async_op, rng=None) -> Pending:
        pending = Pending([work] if async_op else [], copies, self.axis, rng)
        if not async_op:
            pending.wait()
        return pending

    def host_names(self) -> Tuple[str, ...]:
        if self._hosts is None:
            from dlrover_tpu_torch.runtime.mesh import host_names

            self._hosts = host_names(self.group)
        return self._hosts

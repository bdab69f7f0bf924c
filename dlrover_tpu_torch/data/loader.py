"""Elastic host-side data pipeline: sampler + loader feeding the card
(port of ``dlrover_tpu/data/loader.py``).

Capability ref: ``dlrover/trainer/torch/elastic/sampler.py``
(``ElasticDistributedSampler`` with checkpointable position) and
``elastic/dataloader.py`` / ``atorch/data/elastic_dataset.py``.

Each host produces its *local slice* of the global batch;
``trainer.train_lib.shard_batch`` places it on the device.  Two sourcing
modes: a static checkpointable sampler (classic), or the master's dynamic
sharding via ``ShardingClient`` (elastic — dead hosts' shards requeue
automatically).

``DevicePrefetcher`` is the reference's async ``device_put`` made a CUDA
stream: host batches are pinned and copied with ``non_blocking=True`` on
one dedicated stream, in the dtypes the step takes, and the consumer's
stream waits on each batch's event before it reads the batch.
"""

from __future__ import annotations

import collections
import threading
import queue as _queue
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.runtime.device import DeviceLike


def batch_group_member(mesh, rules=None):
    """``(rank, count)`` of this process in the batch group of ``mesh``
    under ``rules`` (the default table when None): the ``data x fsdp x
    expert`` ranks that split the batch, data-major, as
    ``train_lib.shard_batch`` takes its rows."""
    from dlrover_tpu_torch.parallel import rules as lr
    from dlrover_tpu_torch.runtime import mesh as mesh_lib

    rules = lr.DEFAULT_RULES if rules is None else rules
    sizes = mesh_lib.mesh_axis_sizes(mesh)
    coords = mesh_lib.mesh_coords(mesh)
    rank, count = 0, 1
    for axis in lr.batch_group_axes(mesh, rules):
        rank, count = rank * sizes[axis] + coords[axis], count * sizes[axis]
    return rank, count


class ElasticDistributedSampler:
    """Deterministic logically-keyed sampler with save/restore of position.

    ``state_dict()`` records epoch + completed samples; after an elastic
    resize, ``load_state_dict`` on the new world skips what was consumed —
    semantics match ref ``ElasticDistributedSampler``.

    Virtual-mesh keying: positions past the ``completed`` watermark are
    assigned to LOGICAL shards round-robin over ``logical_world`` (the
    job's fixed reference world), and a physical member owns the logical
    shards ``s % num_replicas == rank`` — the same fold rule as
    ``runtime/virtual_mesh.VirtualMesh.owner`` (kept inline here so the
    data tier free of the runtime; the two must not diverge).  Which member
    *fetches* a sample therefore changes across resizes, but which
    logical shard it belongs to never does, so a ``rebind_world`` mid-run
    (live re-layout) leaves the global batch order invariant.  Default
    ``logical_world=0`` means "= num_replicas": one shard per member —
    exactly the legacy rank-stride, bit-for-bit.

    On a mesh with model-parallel axes (``mesh``, with ``rules``) the
    members are the batch group's ranks (``data x fsdp x expert``,
    :func:`batch_group_member`): the ranks of a tensor group draw the
    same samples.
    """

    def __init__(
        self,
        dataset_size: int,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        logical_world: int = 0,
        mesh=None,
        rules=None,
    ):
        # The member count and this member's rank default to the batch
        # group's on ``mesh``, else to the default process group's (1 and
        # 0 without one).
        group = torch.distributed.is_available() and \
            torch.distributed.is_initialized()
        if mesh is not None:
            member, members = batch_group_member(mesh, rules)
            num_replicas = members if num_replicas is None else num_replicas
            rank = member if rank is None else rank
        if num_replicas is None:
            num_replicas = torch.distributed.get_world_size() if group else 1
        if rank is None:
            rank = torch.distributed.get_rank() if group else 0
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.logical_world = logical_world
        self.epoch = 0
        self.completed = 0  # globally-consumed samples this epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed = 0

    def owned_logical_shards(self) -> List[int]:
        """Logical shards folded onto this member at the current binding
        (empty when the world grew past the logical mesh — member idles)."""
        world = self.logical_world or self.num_replicas
        return [
            s for s in range(world) if s % self.num_replicas == self.rank
        ]

    def rebind_world(self, rank: int = None, num_replicas: int = None):
        """Re-bind the physical membership after a live resize.

        Only the fold changes: the logical keying (frozen here on first
        rebind for legacy samplers constructed without one) is what keeps
        every global position's shard assignment — and therefore the
        batch order — invariant across the resize.  ``completed`` and
        ``epoch`` are deliberately untouched: the watermark is a global
        property, not a per-member one.
        """
        if not self.logical_world:
            self.logical_world = self.num_replicas
        if num_replicas is not None:
            self.num_replicas = max(1, int(num_replicas))
        if rank is not None:
            self.rank = int(rank)
        # A surviving member keeps its identity modulo the new world (the
        # virtual-mesh fold); without this a shrink would orphan ranks.
        self.rank %= self.num_replicas

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        world = self.logical_world or self.num_replicas
        owned = self.owned_logical_shards()
        # Shard indexing is RELATIVE to the completed watermark (position
        # completed+j belongs to logical shard j % world) — the resume
        # contract the shrink-skew test pins: after a resize at any
        # watermark, the members' union is exactly the unconsumed suffix.
        for base in range(self.completed, self.dataset_size, world):
            for shard in owned:
                i = base + shard
                if i < self.dataset_size:
                    yield int(order[i])

    def __len__(self) -> int:
        remaining = self.dataset_size - self.completed
        world = self.logical_world or self.num_replicas
        return max(0, (remaining * len(self.owned_logical_shards())) // world)

    def record_batch(self, global_batch_size: int):
        self.completed += global_batch_size

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "completed": self.completed}

    def load_state_dict(self, state: Dict):
        self.epoch = state.get("epoch", 0)
        self.completed = state.get("completed", 0)


class ElasticDataLoader:
    """Batched loader over ``sample_fn(index) -> dict[str, np.ndarray]``.

    ``source`` is either an ``ElasticDistributedSampler`` or a
    ``ShardingClient`` (dynamic mode).  Prefetches on a background thread so
    host data prep overlaps device compute.
    """

    def __init__(
        self,
        sample_fn: Callable[[int], Dict[str, np.ndarray]],
        batch_size: int,
        source=None,
        prefetch: int = 2,
        drop_last: bool = True,
    ):
        self.sample_fn = sample_fn
        self.batch_size = batch_size
        self.source = source
        self.prefetch = prefetch
        self.drop_last = drop_last
        # Generation token: bumped by every fresh iteration so a producer
        # thread that outlived its iterator (join timeout) can never keep
        # consuming the shared source on behalf of a successor iterator.
        self._generation = 0
        # The bump races a stale producer's ``live()`` check without it;
        # the producer's lock-free read then observes either the old or the
        # new token, both of which make it exit.
        self._gen_lock = threading.Lock()

    def _indexed_stream(self) -> Iterator:
        """Yields (index, completed_shards) — shards listed once all their
        indices have been emitted."""
        from dlrover_tpu_torch.data.sharding_client import ShardingClient

        if self.source is None:
            i = 0
            while True:
                yield i, []
                i += 1
        elif isinstance(self.source, ShardingClient):
            from dlrover_tpu_torch.data.sharding_client import task_sample_indices

            while True:
                task = self.source.fetch_shard()
                if task is None:
                    return
                indices = list(task_sample_indices(task))
                if not indices:
                    self.source.report_shard_done(task)
                    continue
                for index in indices[:-1]:
                    yield index, []
                yield indices[-1], [task]
        else:
            for index in self.source:
                yield index, []

    def _batches(self) -> Iterator:
        """Yields (collated_batch, completed_shards)."""
        batch: List[Dict[str, np.ndarray]] = []
        done: List = []
        for index, completed in self._indexed_stream():
            batch.append(self.sample_fn(index))
            done.extend(completed)
            if len(batch) == self.batch_size:
                yield _collate(batch), done
                batch, done = [], []
        if batch and not self.drop_last:
            yield _collate(batch), done

    def _ack(self, shards):
        for shard in shards:
            self.source.report_shard_done(shard)

    def _threaded_items(self) -> Iterator:
        """(batch, done_shards) pairs produced on a background thread.

        The producer captures this iteration's generation token; a stale
        producer (its consumer timed out the join and moved on) fails the
        ``live()`` check on its next queue interaction and exits — it can
        never enqueue into, or keep consuming the shared source for, a
        successor iterator.
        """
        with self._gen_lock:
            self._generation += 1
            gen = self._generation
        q: _queue.Queue = _queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def live() -> bool:
            return not stop.is_set() and gen == self._generation

        def put_retrying(item) -> bool:
            while live():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self._batches():
                    if not put_retrying(item):
                        return
            except BaseException as e:  # surfaced on the consumer side
                error.append(e)
            finally:
                # The sentinel must use the same stop-aware retry: dropping
                # it on a full queue would strand the consumer in q.get().
                put_retrying(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            # Consumer abandoned the iterator (break) or finished: stop the
            # producer so it doesn't park in q.put forever. Unacked shards
            # requeue via the master's timeout reassignment.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            thread.join(timeout=2.0)
            if thread.is_alive():
                logger.warning(
                    "loader producer thread (generation %d) outlived its "
                    "2s join; the generation token bars it from later "
                    "iterations, but it may still hold a source fetch",
                    gen,
                )

    def _items(self) -> Iterator:
        if self.prefetch <= 0:
            yield from self._batches()
        else:
            yield from self._threaded_items()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Shard-ack contract: a shard is acked only once the consumer has
        come back for the batch *after* the one that finished it — i.e. the
        covering batch was actually handed to (and presumably trained by)
        the caller, not merely prefetched.  A crash mid-batch leaves its
        shards unacked, so the master requeues them (at-least-once)."""
        pending: List = []
        for batch, done in self._items():
            self._ack(pending)
            pending = done
            yield batch
        self._ack(pending)

    def batches_with_acks(self) -> Iterator:
        """(batch, ack) pairs for consumers that know when a batch was
        *actually* trained — ``ack()`` marks the shards the batch finished.

        The device prefetcher needs this split: with N batches resident on
        device ahead of compute, "the consumer came back for the next
        batch" (the ``__iter__`` contract) would fire N batches early and a
        crash would silently skip device-buffered-but-untrained shards.
        An abandoned iterator leaves un-acked shards to the master's
        timeout requeue, exactly like ``__iter__``.
        """
        for batch, done in self._items():
            yield batch, (lambda shards=tuple(done): self._ack(shards))


class DevicePrefetcher:
    """Double-buffers device placement so H2D overlaps device compute.

    Wraps a host-batch iterable and keeps up to ``depth`` batches resident
    on device ahead of the consumer: before batch N is handed out, the
    ``place_fn`` (typically ``train_lib.shard_batch``) has already been
    issued for batches N+1..N+depth, so their H2D copies ride under step
    N's compute.

    On a CUDA ``device`` every ``place_fn`` call runs on one dedicated
    copy stream (``shard_batch`` pins the host arrays and copies them with
    ``non_blocking=True``), followed by an event.  Handing a batch out
    makes the consumer's current stream wait on that event and calls
    ``record_stream`` on each of its tensors, so the caching allocator
    cannot give their memory to another tensor while the consumer's
    stream may still read it.  A failure to pin or to copy raises.  On
    any other device (or ``device=None``) ``place_fn`` runs inline.

    Ack semantics: when the source exposes ``batches_with_acks`` (the
    elastic loader), each batch's ack fires only after the consumer comes
    back for the NEXT batch — i.e. the batch was actually consumed, not
    merely device-buffered.  A crash mid-pipeline leaves the in-flight and
    buffered batches unacked for the master to requeue.

    Re-iterable when the source is (each ``__iter__`` opens a fresh pass).

    Drain contract (live resize): ``drain()`` bumps a generation token;
    the active pass notices the stale token before handing out its next
    batch and re-issues ``place_fn`` for every buffered HOST batch.  The
    device-resident placements of the old generation are dropped, but no
    *data* is lost — the host copies are retained.  Same-thread only,
    like iteration.
    """

    def __init__(self, source, place_fn: Callable, depth: int = 2,
                 device: DeviceLike = None):
        self.source = source
        self.place_fn = place_fn
        self.depth = max(1, depth)
        self.device = None if device is None else torch.device(device)
        self._stream: Optional[torch.cuda.Stream] = None
        # Generation token (the loader's pattern, single-threaded here):
        # drain() bumps it; the active pass re-places on the mismatch.
        self._generation = 0
        self._buf = None  # the active pass's buffer, for drain() to size
        # Classified device-memory accounting: the device-resident
        # batches are the "prefetch" pool.  Registered under its own name
        # as a bound method, which the registry holds via WeakMethod: a
        # dropped prefetcher unregisters itself.
        from dlrover_tpu_torch.utils import memory_profile

        memory_profile.registry().register(
            "prefetch", f"prefetch.{id(self)}", self.device_buffers
        )

    def device_buffers(self):
        """Device-placed batches currently buffered (empty outside an
        active pass — ``_buf`` is only bound while iterating)."""
        buf = self._buf
        if not buf:
            return []
        return [placed for _, placed, _, _ in buf]

    def drain(self) -> int:
        """Invalidate device-buffered placements (keep their host data).

        Returns how many buffered batches the active pass will re-place.
        Idempotent and safe with no pass active (a fresh pass always
        places under the current program).
        """
        self._generation += 1
        return len(self._buf) if self._buf is not None else 0

    def _pairs(self) -> Iterator:
        if hasattr(self.source, "batches_with_acks"):
            yield from self.source.batches_with_acks()
        else:
            for batch in self.source:
                yield batch, None

    def _place(self, batch):
        """``(placed, event)``: on a CUDA device the placement is issued on
        the copy stream and ``event`` marks its end; else ``event`` is
        None."""
        if self.device is None or self.device.type != "cuda":
            return self.place_fn(batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            placed = self.place_fn(batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _hand_out(self, placed, event):
        if event is None:
            return placed
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for value in placed.values():
            if isinstance(value, torch.Tensor) and value.is_cuda:
                value.record_stream(consumer)
        return placed

    def __iter__(self) -> Iterator:
        it = self._pairs()
        gen = self._generation
        # Entries are (host_batch, placed, event, ack): the host copy is
        # the drain path's re-place source.
        buf: collections.deque = collections.deque()
        self._buf = buf

        def top_up():
            while len(buf) < self.depth:
                try:
                    batch, ack = next(it)
                except StopIteration:
                    return
                buf.append((batch, *self._place(batch), ack))

        try:
            top_up()
            while buf:
                if gen != self._generation:
                    # Drained: the buffered placements belong to the
                    # previous generation — re-place from the retained
                    # host batches.
                    gen = self._generation
                    for i in range(len(buf)):
                        batch, _, _, ack = buf[i]
                        buf[i] = (batch, *self._place(batch), ack)
                _, placed, event, ack = buf.popleft()
                # Place N+1..N+depth BEFORE handing out N: the overlap
                # contract the pipeline tests assert.
                top_up()
                yield self._hand_out(placed, event)
                # The consumer came back: batch was consumed, not merely
                # buffered — safe to ack its shards now.
                if ack is not None:
                    ack()
        finally:
            self._buf = None
            if hasattr(it, "close"):
                it.close()


def _collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {
        key: np.stack([s[key] for s in samples]) for key in samples[0]
    }


class _SyntheticLMSample:
    """Picklable synthetic-LM sample callable: a class instance, not a
    closure, so data workers can start via the fork-safe "spawn"
    method (closures force fork, and forking a thread-heavy trainer can
    deadlock the child on an inherited lock)."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed

    def __call__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        tokens = rng.integers(
            0, self.vocab_size, size=(self.seq_len + 1,), dtype=np.int32
        )
        return {"inputs": tokens[:-1], "targets": tokens[1:]}


def synthetic_lm_sample_fn(
    vocab_size: int, seq_len: int, seed: int = 0
) -> Callable[[int], Dict[str, np.ndarray]]:
    """Deterministic synthetic LM data (bench + tests)."""
    return _SyntheticLMSample(vocab_size, seq_len, seed)

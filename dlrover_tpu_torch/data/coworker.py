"""Coworker preprocessing: CPU-heavy sample prep in worker processes, with
batches shipped to the trainer through shared memory (port of
``dlrover_tpu/data/coworker.py``).

Capability ref: ATorch's coworker stack
(``atorch/atorch/data/shm_context.py:139-682`` ``ShmDataContext``,
``data/coworker_dataset.py``, ``service/coworker_data_service.py``) —
preprocessing offloaded off the training process and batches handed over
via shared memory instead of pickled pipes.

The shape: the trainer process must spend its host time driving the device,
not tokenizing; ``CoworkerDataLoader`` forks N preprocessing workers that
fill a ring of shared-memory slots with collated batches.  Only slot
descriptors cross the process boundary — tensor bytes are written once into
shm and read once out of it.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import threading
from multiprocessing import shared_memory
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.retry import RetryPolicy

# Sample building touches the data source (remote filesystem, tokenizer
# service): transient hiccups get a few fast retries before the batch is
# declared dead and surfaced to the consumer.  The ``coworker.fetch`` seam
# lets a fault plan script exactly those hiccups.
_FETCH_POLICY = RetryPolicy(
    max_attempts=3, base_delay_s=0.05, max_delay_s=0.5, name="coworker_fetch",
)


def _build_batch(sample_fn, indices) -> Dict[str, np.ndarray]:
    faults.fire("coworker.fetch")
    batch = [sample_fn(i) for i in indices]
    return {
        key: np.stack([s[key] for s in batch])
        for key in batch[0]
    }


def _worker_main(
    sample_fn, slot_names, task_queue, ready_queue, free_queue
):
    """Pull an index list, build + collate the batch, copy into a free slot.

    Runs in a forked process; ``sample_fn`` arrives via fork inheritance
    (closures work), shm slots are attached by name.
    """
    slots = {
        idx: shared_memory.SharedMemory(name=name)
        for idx, name in enumerate(slot_names)
    }
    try:
        while True:
            task = task_queue.get()
            if task is None:
                break
            seq, indices = task
            slot = None
            try:
                collated = _FETCH_POLICY.call(
                    _build_batch, sample_fn, indices
                )
                slot = free_queue.get()
                buf = slots[slot].buf
                offset = 0
                meta: Dict[str, Tuple[Tuple[int, ...], str, int]] = {}
                for key, arr in collated.items():
                    nbytes = arr.nbytes
                    if offset + nbytes > len(buf):
                        raise MemoryError(
                            f"batch ({offset + nbytes}B) exceeds the shm "
                            f"slot ({len(buf)}B); raise slot_bytes"
                        )
                    dst = np.frombuffer(buf, np.uint8, count=nbytes,
                                        offset=offset)
                    dst[:] = arr.reshape(-1).view(np.uint8)
                    meta[key] = (arr.shape, arr.dtype.str, offset)
                    offset += nbytes
                ready_queue.put((seq, slot, meta))
            except Exception as e:  # noqa: BLE001 - surfaced to the consumer
                # The consumer must learn which seq died — a silently lost
                # seq would stall in-order delivery forever while other
                # workers stay alive.  Return the slot before reporting.
                if slot is not None:
                    free_queue.put(slot)
                ready_queue.put((seq, -1, {"__error__": repr(e)}))
                return
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    finally:
        for shm in slots.values():
            try:
                shm.close()
            except BufferError:
                # numpy views into the buffer may outlive this scope; the
                # process is exiting and the parent owns unlink.
                pass


class CoworkerDataLoader:
    """Multiprocess preprocessing loader (static index sources).

    ``sample_fn(index) -> dict[str, np.ndarray]`` runs in the workers.
    ``source`` is an index iterable (e.g. ``ElasticDistributedSampler``) or
    None for an endless arange.  Batches are yielded IN ORDER (a sequence
    number reorders worker completions), so elastic sampler positions stay
    meaningful.  Dynamic master-shard sourcing stays on the in-process
    ``ElasticDataLoader`` — its ack contract needs the consuming process's
    RPC identity.
    """

    def __init__(
        self,
        sample_fn: Callable[[int], Dict[str, np.ndarray]],
        batch_size: int,
        num_workers: int = 2,
        source=None,
        slots: int = 0,
        slot_bytes: int = 64 << 20,
        start_method: str = "auto",
        stall_timeout_s: float = 300.0,
    ):
        """``start_method``: "auto" uses the fork-safe "spawn" when
        ``sample_fn`` pickles and falls back to "fork" (with a warning)
        for closures — forking a thread-heavy trainer (CUDA runtime, RPC
        servers) can deadlock the child on a lock some other thread held
        at fork time.  NOTE spawn re-imports the consumer's main module:
        scripts must build the loader under ``if __name__ ==
        "__main__"`` (multiprocessing raises its standard bootstrapping
        error otherwise); pass ``start_method="fork"`` to restore the
        plain Linux behavior.  ``stall_timeout_s``: raise instead of
        hanging forever when live-but-stuck workers produce nothing (0
        disables)."""
        self.sample_fn = sample_fn
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.source = source
        self.num_slots = slots or 2 * self.num_workers
        self.slot_bytes = slot_bytes
        self.stall_timeout_s = stall_timeout_s
        if start_method == "auto":
            import pickle

            try:
                pickle.dumps(sample_fn)
                start_method = "spawn"
            except Exception:  # noqa: BLE001 - any pickle failure
                logger.warning(
                    "coworker sample_fn is not picklable; falling back "
                    "to fork workers (closures inherit, but forking a "
                    "multithreaded trainer risks child deadlock — prefer "
                    "a picklable callable class)"
                )
                start_method = "fork"
        self.start_method = start_method
        self._shms: List[shared_memory.SharedMemory] = []
        self._procs: List[mp.Process] = []
        self._started = False
        self._stop = threading.Event()

    def _indices(self) -> Iterator[int]:
        if self.source is None:
            i = 0
            while True:
                yield i
                i += 1
        else:
            yield from self.source

    def _start(self):
        ctx = mp.get_context(self.start_method)
        # Bounded: with an endless index source the feeder must block once
        # the pipeline is full instead of buffering tasks forever.
        self._task_queue = ctx.Queue(maxsize=self.num_slots)
        self._ready_queue = ctx.Queue()
        self._free_queue = ctx.Queue()
        for i in range(self.num_slots):
            shm = shared_memory.SharedMemory(
                create=True, size=self.slot_bytes
            )
            self._shms.append(shm)
            self._free_queue.put(i)
        names = [s.name for s in self._shms]
        for _ in range(self.num_workers):
            proc = ctx.Process(
                target=_worker_main,
                args=(self.sample_fn, names, self._task_queue,
                      self._ready_queue, self._free_queue),
                daemon=True,
            )
            proc.start()
            self._procs.append(proc)
        self._started = True

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._started:
            self._start()
        feeder_done = threading.Event()
        submitted = {"n": 0}

        def feed():
            batch: List[int] = []
            seq = 0
            try:
                for index in self._indices():
                    batch.append(index)
                    if len(batch) == self.batch_size:
                        # Count the seq BEFORE the put and roll back if the
                        # put never lands: counting after would let a feeder
                        # dying between put and count drop the in-flight
                        # batch silently (consumer exit condition undershoots)
                        submitted["n"] = seq + 1
                        put_ok = False
                        try:
                            while not (
                                feeder_done.is_set() or self._stop.is_set()
                            ):
                                try:
                                    self._task_queue.put((seq, batch),
                                                         timeout=0.2)
                                    put_ok = True
                                    break
                                except _queue.Full:
                                    continue
                        finally:
                            if not put_ok:
                                submitted["n"] = seq
                        if not put_ok:
                            return
                        seq += 1
                        batch = []
            finally:
                feeder_done.set()

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        next_seq = 0
        held: Dict[int, Tuple[int, Dict]] = {}
        import time as _time

        last_progress = _time.monotonic()
        try:
            while True:
                if (
                    feeder_done.is_set()
                    and next_seq >= submitted["n"]
                    and not held
                ):
                    return
                try:
                    seq, slot, meta = self._ready_queue.get(timeout=0.5)
                    last_progress = _time.monotonic()
                except _queue.Empty:
                    # Any abnormal worker exit is fatal: its in-flight seq
                    # is lost and in-order delivery would stall forever.
                    dead = [
                        p.exitcode for p in self._procs
                        if p.exitcode not in (None, 0)
                    ]
                    if dead or not any(p.is_alive() for p in self._procs):
                        raise RuntimeError(
                            f"coworker processes died (exit codes {dead})"
                        ) from None
                    if self.stall_timeout_s and (
                        _time.monotonic() - last_progress
                        > self.stall_timeout_s
                    ):
                        # Workers ALIVE but producing nothing: the
                        # live-but-wedged signature (e.g. a forked child
                        # deadlocked on an inherited lock).  Crash loudly
                        # — the agent restarts a crashed trainer; nothing
                        # rescues a silently hung one.
                        raise RuntimeError(
                            "coworker pipeline stalled: no batch for "
                            f"{self.stall_timeout_s:.0f}s with "
                            f"{sum(p.is_alive() for p in self._procs)} "
                            "live workers (deadlocked child?)"
                        ) from None
                    continue
                if slot == -1:
                    raise RuntimeError(
                        f"coworker batch {seq} failed: "
                        f"{meta.get('__error__', 'unknown')}"
                    )
                held[seq] = (slot, meta)
                while next_seq in held:
                    slot, meta = held.pop(next_seq)
                    buf = self._shms[slot].buf
                    out = {}
                    for key, (shape, dtype, offset) in meta.items():
                        arr = np.frombuffer(
                            buf, np.dtype(dtype),
                            count=int(np.prod(shape)), offset=offset,
                        ).reshape(shape)
                        out[key] = arr.copy()  # slot is recycled next
                    self._free_queue.put(slot)
                    next_seq += 1
                    yield out
        finally:
            feeder_done.set()

    def close(self):
        if not self._started:
            return
        # A suspended iterator's feeder may still be pumping the bounded
        # task queue: stop it, then drain so the worker sentinels fit.
        self._stop.set()
        while True:
            try:
                self._task_queue.get_nowait()
            except (_queue.Empty, ValueError, OSError):
                break
        for _ in self._procs:
            try:
                self._task_queue.put_nowait(None)
            except (_queue.Full, ValueError, OSError):
                break
        # A worker holding a built batch waits for a free slot that no
        # consumer will return: hand it one, so it reaches its sentinel
        # instead of the join's timeout.
        for slot in range(self.num_slots):
            try:
                self._free_queue.put_nowait(slot)
            except (ValueError, OSError):
                break
        for proc in self._procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2)
        for shm in self._shms:
            try:
                shm.close()
            except BufferError:
                pass
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        self._shms.clear()
        self._procs.clear()
        self._started = False
        self._stop.clear()

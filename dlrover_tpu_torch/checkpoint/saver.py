"""Agent-side async checkpoint saver: drains shm -> storage, commits steps
(port of ``dlrover_tpu/checkpoint/saver.py``, the same code).

Capability ref: ``dlrover/python/elastic_agent/torch/ckpt_saver.py:344-1194``
(``AsyncCheckpointSaver``: event loop, ``save_step_checkpoint``,
``commit_checkpoint``, SIGTERM persist).  One saver per host process
supervising one shm arena; the commit barrier is done-files polled by the
lowest live host (works on any shared filesystem mount); retention runs
behind the tracker update so a reader never sees a deleted-but-tracked step.
It persists meta, data and the digest sidecar from shm alone: it never
touches a tensor or the card, so it runs as a thread of the trainer or in
a process of its own (started with ``spawn`` where CUDA is live).
"""

from __future__ import annotations

import os
import pickle
import signal
import threading
import time
import zlib
from typing import Optional

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedQueue,
)
from dlrover_tpu_torch.common.storage import (
    CheckpointDeletionStrategy,
    CheckpointDirLayout,
    CheckpointStorage,
    KeepLatestStepStrategy,
    digest_stamp,
    get_checkpoint_storage,
)
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.checkpoint.engine import (
    CheckpointEvent,
    CheckpointEventType,
    event_queue_name,
    lock_name,
    shm_name,
)


class AsyncCheckpointSaver:
    """Daemon that persists the shm arena to storage off the training path."""

    _instance: Optional["AsyncCheckpointSaver"] = None

    def __init__(
        self,
        checkpoint_dir: str,
        storage: Optional[CheckpointStorage] = None,
        host_index: int = 0,
        num_hosts: int = 1,
        deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
        commit_timeout: float = 600.0,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.storage = storage or get_checkpoint_storage()
        self.layout = CheckpointDirLayout(checkpoint_dir)
        self.host_index = host_index
        self.num_hosts = num_hosts
        # Host ids of the sealed world (sparse after shrinks).  The commit
        # barrier is driven by the lowest live host — a hardcoded "host 0"
        # would never commit once node 0 has been evicted.
        self.world_hosts: Optional[list] = None
        self.deletion_strategy = deletion_strategy or KeepLatestStepStrategy(3)
        self.commit_timeout = commit_timeout
        self._shm = SharedMemoryHandler(shm_name(host_index))
        # The saver side OWNS the queue + lock servers.
        self._event_queue = SharedQueue(
            event_queue_name(host_index), create=True
        )
        self._lock = SharedLock(lock_name(host_index), create=True)
        from dlrover_tpu_torch.checkpoint.engine import status_name

        self._status = SharedDict(status_name(host_index), create=True)
        self._status.update(
            {
                "persisted_step": -1,
                "committed_step": -1,
                "is_committer": host_index == 0,
            }
        )
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self._persisted_step = -1
        self._cleaned_steps: set = set()
        # Bumped by set_world: in-flight commit barriers for a superseded
        # world must abort instead of blocking the saver thread for the
        # full commit timeout (which would wedge every later persist).
        self._world_gen = 0
        # Guards the cross-thread saver state: the (world_hosts, num_hosts,
        # _world_gen) triple written by ``set_world`` on the agent thread
        # and snapshotted by the saver thread mid-persist, plus
        # ``_persisted_step`` (written saver-side, read from the SIGTERM /
        # membership paths).
        self._state_lock = threading.Lock()
        AsyncCheckpointSaver._instance = self

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="ckpt-saver", daemon=True
        )
        self._thread.start()

    # Drain / forced-stop windows (class attrs so tests can shrink them).
    DRAIN_TIMEOUT_S = 30.0
    FORCED_JOIN_TIMEOUT_S = 5.0

    def stop(self, unlink_shm: bool = False):
        """``unlink_shm=True`` only on clean job success — after a failure the
        arena must survive for the save-at-breakpoint / resume path.

        EXIT is processed IN QUEUE ORDER, after any still-queued SAVE
        events: setting the stop flag first would make the loop drop a
        just-enqueued final checkpoint (and, with unlink_shm, delete the
        only copy) whenever shutdown raced the persist — seen as a
        loaded-host flake where the last ckpt_every save never reached
        disk.  The flag is set only if the thread fails to drain in time.
        """
        self._event_queue.put(CheckpointEvent(CheckpointEventType.EXIT))
        if self._thread:
            self._thread.join(timeout=self.DRAIN_TIMEOUT_S)
            if self._thread.is_alive():
                logger.warning(
                    "saver did not drain within %.0fs; forcing stop",
                    self.DRAIN_TIMEOUT_S,
                )
                self._stopped.set()
                # Give the forced-stop flag a chance to break the loop (or
                # an in-flight persist to finish) before touching shared
                # state.
                self._thread.join(timeout=self.FORCED_JOIN_TIMEOUT_S)
                if self._thread.is_alive():
                    # The worker may be mid-persist INSIDE the shared
                    # queue/lock/status/shm; closing them under it would
                    # corrupt the write or raise in the worker.  Leak the
                    # handles instead — the process is exiting anyway and
                    # a restarted saver re-creates them.
                    logger.error(
                        "saver thread still alive after forced stop; "
                        "leaving shared queue/lock/status/shm open"
                    )
                    return
        self._stopped.set()
        self._event_queue.close()
        self._lock.close()
        self._status.close()
        self._shm.close(unlink=unlink_shm)

    @classmethod
    def register_signal_handlers(cls):
        """Persist shm before dying on SIGTERM (preemption notice).

        Capability ref ``ckpt_saver.py:472-494`` — maintenance events and
        spot preemptions deliver SIGTERM to the host with ~30s grace,
        enough to flush a host-RAM checkpoint to durable storage.
        """

        def handler(signum, frame):
            saver = cls._instance
            if saver is not None:
                logger.info("SIGTERM: persisting shm checkpoint before exit")
                try:
                    saver.save_shm_to_storage()
                except Exception as e:
                    logger.error("SIGTERM persist failed: %s", e)
            # Terminate with real SIGTERM semantics (not KeyboardInterrupt,
            # which user code routinely catches): restore the default
            # handler and re-deliver.
            import os

            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            logger.warning("not main thread; SIGTERM handler not installed")

    # -- event loop -----------------------------------------------------------

    def _run(self):
        logger.info(
            "async saver started (host %d/%d) -> %s",
            self.host_index, self.num_hosts, self.checkpoint_dir,
        )
        while True:
            event = self._event_queue.get(timeout=1.0)
            if event is None:
                if self._stopped.is_set():
                    break  # backstop: forced stop after a failed drain
                continue
            if event.type == CheckpointEventType.EXIT:
                break
            if event.type == CheckpointEventType.SAVE:
                try:
                    self.save_step_checkpoint(event.step)
                except Exception as e:
                    logger.error("persist of step %d failed: %s", event.step, e)

    # -- persist + commit -----------------------------------------------------

    BREAKPOINT_COMMIT_TIMEOUT = 15.0

    def save_shm_to_storage(self) -> bool:
        """Persist whatever is in shm right now (failure/SIGTERM/membership
        path).  The commit barrier gets a short timeout here: when the world
        just lost a member its done-file never appears, and blocking the
        restart (or the SIGTERM grace window) for the full commit timeout
        would cost the whole preemption budget.  Peers that are alive all
        persist within seconds, so a healthy world still commits."""
        faults.fire("saver.flush", host=self.host_index)
        meta = self._shm.load_meta()
        if meta is None:
            return False
        if meta.step <= self._persisted_step:
            return True
        return self.save_step_checkpoint(
            meta.step, commit_timeout=self.BREAKPOINT_COMMIT_TIMEOUT
        )

    def save_step_checkpoint(
        self, step: int, commit_timeout: Optional[float] = None
    ) -> bool:
        # Snapshot the world ONCE: ``set_world`` (agent thread, new
        # rendezvous) can mutate num_hosts/world_hosts mid-persist, and a
        # torn read would pair host_i_of_4.meta with host_i_of_2.data or
        # mis-stamp the done marker.
        # One atomic snapshot of (world, generation) drives the whole
        # persist: cleanup keying, committer election AND the commit
        # barrier's abort check.  Reading any of these later would race
        # ``set_world`` from the agent thread.
        with self._state_lock:
            world_gen = self._world_gen
            num_hosts = self.num_hosts
            world_hosts = (
                list(self.world_hosts) if self.world_hosts else None
            )
        is_committer = (
            self.host_index == min(world_hosts) if world_hosts
            else self.host_index == 0
        )
        # Hold the shm lock for the whole read so the trainer cannot
        # overwrite the arena mid-persist (it skips the save instead).
        if not self._lock.acquire(blocking=True):
            return False
        data = None
        try:
            meta = self._shm.load_meta()
            if meta is None or meta.step != step:
                actual = None if meta is None else meta.step
                logger.warning(
                    "shm holds step %s, wanted %d; persisting what exists",
                    actual, step,
                )
                if meta is None:
                    return False
                step = meta.step
            t0 = time.monotonic()
            step_dir = self.layout.step_dir(step)
            self.storage.safe_makedirs(step_dir)
            # Keyed by world generation: a re-persist of the same step under
            # a NEW world must clean this saver's own previous-world files.
            clean_key = (step, world_gen)
            if clean_key not in self._cleaned_steps:
                self._clean_stale_host_files(step, num_hosts, world_hosts)
                self._cleaned_steps.add(clean_key)
            faults.fire("saver.persist", step=step)
            # Integrity chain: stamp a crc32 into every shard record (and a
            # whole-file digest sidecar) while the bytes are still in shm —
            # restore re-computes both, so a bit-flip or truncation anywhere
            # between here and the restoring host is caught, and the step
            # degrades to an older verified one instead of feeding the
            # model torn tensors.  crc cost is off the training path (this
            # is the async saver thread).  ``data`` is a view of the arena,
            # not a copy: a copy into ``bytes`` holds the GIL for the whole
            # memcpy and stalls the training thread's dispatch, while
            # ``zlib.crc32`` and the file writes release it on a buffer.
            data = self._shm.raw_data(meta)
            for tensor in meta.tensors:
                for record in tensor.shards:
                    record.crc32 = zlib.crc32(
                        data[record.offset:record.offset + record.nbytes])
            # World booking for cross-world restore: the meta records which
            # world persisted it, so a restoring world of a different size
            # can pick the authoritative group in a mixed step dir and
            # reshard instead of rejecting the step.
            meta.world_size = num_hosts
            meta.world_hosts = (
                tuple(world_hosts) if world_hosts else (self.host_index,)
            )
            meta_bytes = pickle.dumps(meta)
            self.storage.write(
                meta_bytes,
                self.layout.meta_path(step, self.host_index, num_hosts),
            )
            self.storage.write(
                data,
                self.layout.data_path(step, self.host_index, num_hosts),
            )
            self.storage.write(
                digest_stamp(
                    zlib.crc32(meta_bytes), zlib.crc32(data), len(data)
                ),
                self.layout.digest_path(step, self.host_index, num_hosts),
            )
            # The done marker is world-stamped: the commit barrier only
            # counts markers carrying the sealed world's size, so a stale
            # done file left by a previous world's persist of the same step
            # (same host id, different world) can never satisfy the barrier.
            # It is written LAST: meta/data/digest are all durable before
            # the step can count toward the commit barrier.
            self.storage.write(
                self._done_stamp(num_hosts),
                self.layout.done_path(step, self.host_index),
            )
            logger.info(
                "host %d persisted step %d in %.2fs",
                self.host_index, step, time.monotonic() - t0,
            )
        finally:
            if data is not None:
                data.release()
            self._lock.release()
        with self._state_lock:
            self._persisted_step = step
        self._status.set("persisted_step", step)
        if is_committer:
            self.commit_checkpoint(
                step,
                expected_hosts=world_hosts,
                num_hosts=num_hosts,
                timeout=commit_timeout,
                world_gen=world_gen,
            )
        return True

    def set_world(self, world_hosts: list):
        """Called by the agent after each sealed rendezvous: the commit
        barrier counts done-files of the *sealed* world and is driven by its
        lowest live host id."""
        with self._state_lock:
            self.world_hosts = sorted(world_hosts)
            self.num_hosts = len(self.world_hosts)
            self._world_gen += 1
        self._status.set("is_committer", self._is_committer())

    def _is_committer(self) -> bool:
        if self.world_hosts:
            return self.host_index == min(self.world_hosts)
        return self.host_index == 0

    @staticmethod
    def _done_stamp(num_hosts: int) -> str:
        return f"ok:{num_hosts}"

    def _done_matches(self, step: int, host: int, num_hosts: int) -> bool:
        content = self.storage.read(
            self.layout.done_path(step, host), mode="r"
        )
        return content is not None and content.strip() == self._done_stamp(
            num_hosts
        )

    def _clean_stale_host_files(
        self, step: int, num_hosts: int, world_hosts: Optional[list]
    ):
        """Drop host files a *previous* world left in this step dir.

        Re-saving a step after an elastic membership change must not leave
        the old world's ``host_*`` files behind: restore would see metas
        from mixed world sizes and reject the step, and stale done markers
        could trip the commit barrier early.  Only files provably foreign to
        the current world are deleted — peers of the current world write
        their own files concurrently and those must never be touched.
        Without a sealed world nothing is provably foreign (a pre-rendezvous
        SIGTERM persist would otherwise shred live peers' files whose n
        differs from this host's stale ``num_hosts``), so no cleanup runs.
        """
        if not world_hosts:
            return
        expected = set(world_hosts)
        step_dir = self.layout.step_dir(step)
        for name in self.storage.listdir(step_dir):
            if not name.startswith("host_"):
                continue
            stale = False
            try:
                if name.endswith(".done"):
                    host = int(name[len("host_"):].split(".")[0])
                    stale = host not in expected
                elif name.endswith((".meta", ".data", ".digest")):
                    host = int(name[len("host_"):].split("_of_")[0])
                    file_n = int(name.split("_of_")[1].split(".")[0])
                    stale = file_n != num_hosts or host not in expected
            except (IndexError, ValueError):
                continue
            if stale:
                self.storage.remove(os.path.join(step_dir, name))
                logger.info(
                    "step %d: removed stale %s from a previous world",
                    step, name,
                )

    def _count_done_files(self, step: int, num_hosts: int) -> int:
        """Count per-host done markers carrying the current world stamp.

        Node ids are sparse after elastic shrinks (e.g. hosts {0, 2} in a
        2-host world), so enumerating ``range(num_hosts)`` would wait for
        ``host_1.done`` forever; only the *count* of distinct, correctly
        world-stamped done files is meaningful.
        """
        count = 0
        for name in self.storage.listdir(self.layout.step_dir(step)):
            if not (name.startswith("host_") and name.endswith(".done")):
                continue
            try:
                host = int(name[len("host_"):].split(".")[0])
            except ValueError:
                continue
            if self._done_matches(step, host, num_hosts):
                count += 1
        return count

    def commit_checkpoint(
        self,
        step: int,
        expected_hosts: Optional[list] = None,
        num_hosts: Optional[int] = None,
        timeout: Optional[float] = None,
        world_gen: Optional[int] = None,
    ):
        """The committer waits for every sealed-world host's done-file, then
        flips the tracker.  ``expected_hosts``/``num_hosts``/``world_gen``
        are snapshots taken when the step was persisted — never re-read
        mutable saver state inside the poll loop (and a ``set_world``
        landing during a long persist must still trip the abort below)."""
        need = len(expected_hosts) if expected_hosts else (
            num_hosts if num_hosts is not None else self.num_hosts
        )
        deadline = time.monotonic() + (
            self.commit_timeout if timeout is None else timeout
        )
        gen = self._world_gen if world_gen is None else world_gen
        # A stamp that matched once stays valid for this barrier's snapshot
        # — cache matches so the poll loop does one read per host, not one
        # per host per 0.5s tick (matters on object-store mounts).
        matched: set = set()
        while time.monotonic() < deadline:
            if self._world_gen != gen or self._stopped.is_set():
                # The world this step was saved under is gone (elastic
                # restart) — its missing members will never write done
                # files.  Abort now; the new world's next save re-persists
                # and commits under the new membership.
                logger.warning(
                    "commit of step %d aborted: world changed mid-barrier",
                    step,
                )
                self.storage.commit(step, False)
                return
            if expected_hosts:
                for h in expected_hosts:
                    if h not in matched and self._done_matches(step, h, need):
                        matched.add(h)
                done = len(matched)
            else:
                done = self._count_done_files(step, need)
            if done >= need:
                self.storage.write(str(step), self.layout.tracker_path())
                self.storage.commit(step, True)
                self._status.set("committed_step", step)
                logger.info("committed step %d (%d hosts)", step, done)
                self._clean_up(step)
                return
            time.sleep(0.5)
        logger.error("commit of step %d timed out (%d hosts)", step, need)
        self.storage.commit(step, False)

    def _clean_up(self, committed_step: int):
        def delete_fn(step: int):
            if step == committed_step:
                return
            self.storage.safe_rmtree(self.layout.step_dir(step))
            logger.info("retention: deleted step %d", step)

        try:
            self.deletion_strategy.clean_up(committed_step, delete_fn)
        except Exception as e:
            logger.warning("retention cleanup failed: %s", e)

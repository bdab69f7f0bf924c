"""Trainer-side Flash Checkpoint engine (port of
``dlrover_tpu/checkpoint/engine.py``).

State is a tree of tensors (``shm_handler.tree_flatten_with_path``);
saving copies each tensor device->host into the host shm arena, off the
training loop's storage path; restore reassembles each leaf and places it
on the engine's device.  A data rank saves its pieces of the state under
a layout (``shm_handler.LeafLayout`` per leaf: a ZeRO-1 shard from its
owner, a replicated leaf from rank 0), the ranks agree that every one of
them saves the step before any copies, and the lowest host commits it
(``saver.py``).  A restore reassembles each leaf from every host's
records of the step, whatever world saved it, and lays it out under the
target world's layout: each rank takes its own slice (any n to m).

One engine per host process, so there is exactly one shm arena per host.
The host is ``DLROVER_TPU_NODE_ID`` when set, else the ``torch.distributed``
rank when a process group is initialized, else 0.

The durable-storage read half (discover world groups, verify digests and
shard crcs, merge records across any saved world, materialize) lives in
:class:`StorageStepReader`; ``CheckpointEngine`` extends it with the shm
save path and the cross-host restore agreement (a ``torch.distributed``
MIN all-reduce, a no-op at world 1).
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from enum import Enum
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedQueue,
)
from dlrover_tpu_torch.common.storage import (
    CheckpointDirLayout,
    CheckpointStorage,
    get_checkpoint_storage,
    parse_digest,
)
from dlrover_tpu_torch.checkpoint.shm_handler import (
    CheckpointMeta,
    SharedMemoryHandler,
    assemble_tensor,
    loads_meta,
    tree_map_with_path,
)
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device


class CheckpointEventType(Enum):
    SAVE = "save"
    EXIT = "exit"


@dataclasses.dataclass
class CheckpointEvent:
    type: CheckpointEventType
    step: int = 0


def _restore_leaf(path, saved: Optional[torch.Tensor], like, device,
                  spot=None):
    """One restored leaf in the template leaf's kind: a tensor on
    ``device`` (its dtype and shape must be the template's: nothing is
    cast), a numpy array, or a Python scalar.  With a layout ``spot``,
    the rank's slice of the whole leaf."""
    name = "".join(path)
    if saved is None:
        raise KeyError(f"checkpoint has no leaf {name}")
    if spot is not None and isinstance(saved, torch.Tensor):
        if tuple(saved.shape) != tuple(spot.global_shape):
            raise ValueError(
                f"{name}: saved {tuple(saved.shape)}, the target layout's "
                f"whole leaf {tuple(spot.global_shape)}")
        saved = saved[tuple(slice(b, e) for b, e in spot.index)]
    if isinstance(like, torch.Tensor):
        if saved.dtype != like.dtype or tuple(saved.shape) != tuple(
                like.shape):
            raise ValueError(
                f"{name}: saved {saved.dtype} {tuple(saved.shape)}, template "
                f"{like.dtype} {tuple(like.shape)}")
        return saved.to(device)
    if isinstance(like, np.ndarray):
        return saved.numpy() if saved.dtype != torch.bfloat16 else (
            saved.float().numpy())
    if isinstance(like, (bool, int, float)):
        return type(like)(saved.item())
    if isinstance(like, np.generic):
        return like.dtype.type(saved.item())
    raise TypeError(f"{name}: template leaf of type {type(like).__name__}")


def materialize_records(arrays: Dict[tuple, torch.Tensor],
                        meta: CheckpointMeta, template: Any,
                        device: torch.device, layout=None):
    """Land reassembled tensors: with a ``template`` (any tree of the
    state's structure), each of its leaves is replaced by the restored
    leaf of the same path, cut to this rank's slice where ``layout``
    (``{path: shm_handler.LeafLayout}``, the target world's) has one;
    without a template, the flat ``{path: tensor}`` dict with every
    tensor on ``device``.  The storage restore and the live re-layout
    (``runtime/virtual_mesh.relayout_state``) both land through here."""
    if template is None:
        return {path: t.to(device) for path, t in arrays.items()}
    layout = layout or {}
    return tree_map_with_path(
        lambda path, like: _restore_leaf(path, arrays.get(path), like,
                                         device, layout.get(path)),
        template)


def default_host_index() -> int:
    """Canonical host identity shared by agent, saver and trainer engine.

    The agent names the shm arena / queue / lock after its ``node_id`` and
    exports it as ``DLROVER_TPU_NODE_ID``.  After an elastic shrink node ids
    are non-contiguous, so a dense rank would dial channels no agent serves
    — prefer the env var whenever present, else the ``torch.distributed``
    rank, else 0.
    """
    from dlrover_tpu_torch.common.constants import ConfigKey

    env = os.environ.get(ConfigKey.NODE_ID)
    if env is not None:
        return int(env)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def default_num_hosts() -> int:
    """The ``torch.distributed`` world size when a process group is
    initialized, else 1."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def shm_name(host_index: int) -> str:
    return f"h{host_index}"


def event_queue_name(host_index: int) -> str:
    return f"ckpt_event_h{host_index}"


def lock_name(host_index: int) -> str:
    return f"ckpt_lock_h{host_index}"


def status_name(host_index: int) -> str:
    return f"ckpt_status_h{host_index}"


class StorageStepReader:
    """Read-and-verify committed checkpoint steps from durable storage.

    Self-contained reader: discovers the saved world group(s) from the
    ``host_{i}_of_{n}.meta`` files actually present, verifies digest
    sidecars and per-shard crcs, merges shard records across hosts, and
    places every leaf on ``device``.  Holds no shm arena, no event queue,
    no lock — safe to construct in processes that only ever *read*
    checkpoints.  Reads the JAX package's checkpoints too
    (:func:`~dlrover_tpu_torch.checkpoint.shm_handler.loads_meta`).
    """

    def __init__(
        self,
        checkpoint_dir: str,
        storage: Optional[CheckpointStorage] = None,
        num_hosts: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.storage = storage or get_checkpoint_storage()
        self.layout = CheckpointDirLayout(checkpoint_dir)
        self.num_hosts = (
            default_num_hosts() if num_hosts is None else num_hosts
        )
        self.device = resolve_device(device)
        #: The target world's ``{path: LeafLayout}`` a restore cuts each
        #: leaf to (None: whole leaves).
        self.target_layout = None
        # ``extra`` sidecar of the most recently restored checkpoint.
        self.last_restored_extra: Dict[str, Any] = {}

    def load_from_storage(
        self,
        template: Any = None,
        step: Optional[int] = None,
        layout=None,
    ):
        """Restore from durable storage.

        With ``step=None`` tries the tracker's committed step first, then
        older committed steps newest-first; an explicit ``step`` (the
        world-agreed one) is tried alone — silently restoring a different
        step than the rest of the world would diverge state.  ``layout``
        cuts each leaf to this rank's slice (see ``load``).
        """
        self.target_layout = layout
        if step is not None:
            candidates = [step]
        else:
            tracked = self.layout.latest_step(self.storage)
            candidates = sorted(
                set(self.layout.committed_steps(self.storage)), reverse=True
            )
            if tracked >= 0:
                candidates = [tracked] + [s for s in candidates if s != tracked]
        for s in candidates:
            if s < 0:
                continue
            result = self._load_step_from_storage(s, template)
            if result is not None:
                return s, result
        return -1, None

    def _load_step_from_storage(self, step: int, template):
        """Load one step, resharding across saved world sizes when needed.

        The host set is discovered from the ``host_{i}_of_{n}.meta`` files
        actually present (node ids are sparse after elastic shrinks — never
        ``range(num_hosts)``).  Every *complete* world group (all ``n`` of
        its hosts' metas present) is a restore candidate: an elastic resize
        legitimately leaves two self-consistent groups in one step dir
        (survivors re-persist the step under the new world before the old
        world's files are cleaned), and each host's meta indexes EVERY
        tensor's global shape, so any group can be resharded into any
        target world.  Candidates are walked in deterministic authority
        order and the first that fully verifies wins; a corrupt
        authoritative group degrades to the next one, then to older steps.
        Zero complete groups still rejects — the step is genuinely
        partial/stale.
        """
        step_dir = self.layout.step_dir(step)
        groups: Dict[int, Dict[int, str]] = {}
        for name in self.storage.listdir(step_dir):
            if not name.endswith(".meta") or not name.startswith("host_"):
                continue
            try:
                host = int(name[len("host_"):].split("_of_")[0])
                n = int(name.split("_of_")[1].split(".")[0])
            except (IndexError, ValueError):
                continue
            groups.setdefault(n, {})[host] = name
        if not groups:
            logger.warning("step %d: no meta files in %s", step, step_dir)
            return None
        complete = {n: hosts for n, hosts in groups.items() if len(hosts) == n}
        if not complete:
            logger.error(
                "step %d not restorable: no complete world group "
                "(world-size groups %s)",
                step, {n: sorted(h) for n, h in groups.items()},
            )
            return None
        if len(groups) > 1:
            logger.warning(
                "step %d: meta files from mixed world sizes %s in %s; "
                "trying complete groups in authority order %s",
                step, sorted(groups), step_dir,
                [n for n, _ in self._order_world_groups(step, complete)],
            )
        for n, host_files in self._order_world_groups(step, complete):
            result = self._load_step_group(step, n, host_files, template)
            if result is not None:
                return result
        return None

    def _order_world_groups(self, step: int, complete: Dict[int, Dict]):
        """Deterministic authority order over complete world groups.

        The freshest signal on storage is the per-host done marker: its
        world stamp (``ok:{n}``) is overwritten by whichever world
        persisted the step last, so the group whose hosts' done files
        agree with it is the one the commit barrier (and tracker) meant.
        Ties break toward the larger world — arbitrary but stable, and the
        verify walk rejects a wrong guess anyway.
        """
        def authority(item):
            n, hosts = item
            stamp = f"ok:{n}"
            done = 0
            for host in hosts:
                content = self.storage.read(
                    self.layout.done_path(step, host), mode="r"
                )
                if content is not None and content.strip() == stamp:
                    done += 1
            return (done / n, n)

        return sorted(complete.items(), key=authority, reverse=True)

    def _load_step_group(
        self, step: int, expected: int, host_files: Dict[int, str],
        template,
    ):
        """Read + verify one complete world group and reshard it into this
        world; None when any host's bytes fail verification (the caller's
        walk then tries the next candidate group / an older step)."""
        metas: Dict[int, CheckpointMeta] = {}
        datas: Dict[int, bytes] = {}
        for host in host_files:
            raw = self.storage.read(self.layout.meta_path(step, host, expected))
            data = self.storage.read(self.layout.data_path(step, host, expected))
            if raw is None or data is None:
                logger.error(
                    "step %d host %d: meta or data unreadable", step, host
                )
                return None
            if not self._verify_host_digest(step, host, expected, raw, data):
                return None
            try:
                metas[host] = loads_meta(raw)
            except Exception as e:
                logger.error("step %d host %d: meta corrupt: %s", step, host, e)
                return None
            if not self._verify_shards(step, host, metas[host], data):
                return None
            datas[host] = data
        # Merge shard records across hosts per tensor path (every host's
        # paths: a pipe stage's meta lists its own layers only).
        merged: Dict[tuple, Any] = {}
        ref_meta = next(iter(metas.values()))
        paths = dict.fromkeys(t.path for m in metas.values()
                              for t in m.tensors)
        for path in paths:
            per_host = []
            for host, m in metas.items():
                for t in m.tensors:
                    if t.path == path:
                        per_host.append((host, t))
            combined = dataclasses.replace(per_host[0][1], shards=[])
            loaders = {}
            for host, t in per_host:
                for record in t.shards:
                    key = record.index
                    if key in loaders:
                        continue  # replicated copy from another host
                    loaders[key] = (host, record)
                    combined.shards.append(record)
            covered = sum(
                int(np.prod(r.shape)) for r in combined.shards
            )
            total = int(np.prod(combined.global_shape))
            if covered != total:
                logger.error(
                    "step %d tensor %s: shards cover %d/%d elements; "
                    "refusing partial restore",
                    step, path, covered, total,
                )
                return None

            def block_loader(record, _loaders=loaders, _datas=datas):
                host, rec = _loaders[record.index]
                return np.frombuffer(
                    _datas[host], dtype=np.uint8,
                    count=rec.nbytes, offset=rec.offset,
                )

            merged[path] = assemble_tensor(combined, block_loader)
        booked = getattr(ref_meta, "world_size", 0)
        if booked and booked != expected:
            logger.warning(
                "step %d: meta books world %d but filenames say %d "
                "(shard records drive reassembly; continuing)",
                step, booked, expected,
            )
        if expected != self.num_hosts:
            logger.info(
                "cross-world restore: step %d saved by %d hosts -> "
                "resharded into world of %d hosts",
                step, expected, self.num_hosts,
            )
        else:
            logger.info("restored step %d from %s", step, self.checkpoint_dir)
        return self._materialize(merged, ref_meta, template)

    def _verify_host_digest(
        self, step: int, host: int, num_hosts: int, raw: bytes, data: bytes
    ) -> bool:
        """Check one host's meta+data bytes against its digest sidecar.

        Missing/unparseable digest == legacy (pre-integrity-chain)
        checkpoint: log and accept — rejecting would strand every
        checkpoint written before the upgrade.  A *present* digest that
        mismatches means torn or corrupted bytes: reject the step so the
        caller's degrade walk falls back to an older verified one.
        """
        content = self.storage.read(
            self.layout.digest_path(step, host, num_hosts), mode="r"
        )
        parsed = parse_digest(content)
        if parsed is None:
            logger.info(
                "step %d host %d: no digest sidecar (legacy checkpoint); "
                "skipping whole-file verification", step, host,
            )
            return True
        meta_crc, data_crc, data_nbytes = parsed
        if len(data) != data_nbytes:
            logger.error(
                "step %d host %d REJECTED: data truncated (%d of %d bytes)",
                step, host, len(data), data_nbytes,
            )
            return False
        if zlib.crc32(raw) != meta_crc:
            logger.error(
                "step %d host %d REJECTED: meta crc mismatch", step, host
            )
            return False
        if zlib.crc32(data) != data_crc:
            logger.error(
                "step %d host %d REJECTED: data crc mismatch "
                "(bit-rot or torn write)", step, host,
            )
            return False
        return True

    def _verify_shards(
        self, step: int, host: int, meta: CheckpointMeta, data: bytes
    ) -> bool:
        """Bounds- and crc-check every shard record against the data blob.

        The bounds check runs even for legacy digest-less checkpoints — a
        truncated data file would otherwise surface as an uncaught
        ``np.frombuffer`` ValueError deep inside tensor reassembly instead
        of a clean degrade to an older step.
        """
        view = memoryview(data)
        for tensor in meta.tensors:
            for record in tensor.shards:
                end = record.offset + record.nbytes
                if record.offset < 0 or end > len(data):
                    logger.error(
                        "step %d host %d REJECTED: shard %s [%d:%d) outside "
                        "data blob of %d bytes",
                        step, host, tensor.path, record.offset, end, len(data),
                    )
                    return False
                expected_crc = getattr(record, "crc32", None)
                if expected_crc is None:
                    continue
                actual = zlib.crc32(view[record.offset:end])
                if actual != expected_crc:
                    logger.error(
                        "step %d host %d REJECTED: shard %s crc mismatch "
                        "(%d != %d)",
                        step, host, tensor.path, actual, expected_crc,
                    )
                    return False
        return True

    def _materialize(self, arrays, meta, template):
        # Surface the checkpoint's small non-array sidecar to the caller
        # without widening every load path's (step, state) return.
        self.last_restored_extra = dict(getattr(meta, "extra", None) or {})
        return materialize_records(arrays, meta, template, self.device,
                                   self.target_layout)


class CheckpointEngine(StorageStepReader):
    """save_to_memory / save_to_storage / load for one host process."""

    def __init__(
        self,
        checkpoint_dir: str,
        storage: Optional[CheckpointStorage] = None,
        host_index: Optional[int] = None,
        num_hosts: Optional[int] = None,
        local_saver: bool = False,
        agree_step_fn: Optional[Callable[[int], int]] = None,
        agree_min_fn: Optional[Callable[[int], int]] = None,
        device: DeviceLike = None,
    ):
        super().__init__(checkpoint_dir, storage=storage, num_hosts=num_hosts,
                         device=device)
        self.host_index = (
            default_host_index() if host_index is None else host_index
        )
        self._agree_step_fn = agree_step_fn
        self._agree_min_fn = agree_min_fn
        self._shm = SharedMemoryHandler(shm_name(self.host_index))
        self._saver = None
        if local_saver:
            # Standalone mode (no agent process): run the async saver as an
            # in-process daemon thread, same contract as the agent-side saver.
            from dlrover_tpu_torch.checkpoint.saver import (
                AsyncCheckpointSaver,
            )

            self._saver = AsyncCheckpointSaver(
                checkpoint_dir,
                storage=self.storage,
                host_index=self.host_index,
                num_hosts=self.num_hosts,
            )
            self._saver.start()
        self._event_queue = SharedQueue(
            event_queue_name(self.host_index), create=False
        )
        self._lock = SharedLock(lock_name(self.host_index), create=False)
        self._status = SharedDict(status_name(self.host_index), create=False)
        self._latest_memory_step = -1
        self._latest_storage_step = -1
        self.last_save_seconds = 0.0

    # -- save -----------------------------------------------------------------

    def save_to_memory(
        self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None,
        layout=None,
    ) -> bool:
        """Pack ``state`` (this rank's pieces under ``layout``, a ``{path:
        LeafLayout}``) into shm, each tensor copied device->host into the
        arena.  Skips (returns False) if the saver is mid-persist — never
        blocks training on storage I/O; in a world of several hosts every
        host skips when one does (one MIN agreement), so a step is saved
        by all of them or by none.  ``last_save_seconds`` is the blocking
        time of the last save that ran."""
        got = self._lock.acquire(blocking=False)
        if self.num_hosts > 1 and self._agree_min(int(got)) == 0:
            if got:
                self._lock.release()
            logger.info("step %d: a host's saver is busy; skip memory save",
                        step)
            return False
        if not got:
            logger.info(
                "step %d: shm busy (saver persisting); skip memory save", step
            )
            return False
        try:
            t0 = time.monotonic()
            self._shm.save_state_dict(state, step, extra, layout)
            self._latest_memory_step = step
            self.last_save_seconds = time.monotonic() - t0
            logger.info(
                "step %d: saved to shm in %.3fs", step, self.last_save_seconds
            )
            return True
        finally:
            self._lock.release()

    def save_to_storage(
        self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None,
        layout=None,
    ) -> bool:
        saved = self.save_to_memory(step, state, extra, layout)
        if saved:
            self._latest_storage_step = step
            self._event_queue.put(
                CheckpointEvent(CheckpointEventType.SAVE, step)
            )
        return saved

    # -- load -----------------------------------------------------------------

    def load(self, template: Any = None, layout=None):
        """Restore the newest *world-agreed* state: shm if it holds the agreed
        step, committed storage otherwise.

        Hosts must restore the same step — after an elastic restart a
        surviving host may hold a newer shm step than a replaced host can see
        on storage; resuming from different steps silently diverges
        replicated state.  The candidate step is therefore agreed across
        hosts (min over each host's best available step) before
        materializing anything.

        Returns ``(step, state)`` where ``state`` has ``template``'s
        structure (or is a flat ``{path: tensor}`` dict when no template)
        with every tensor on the engine's device, cut to this rank's
        slices where ``layout`` (``{path: LeafLayout}``) has them.
        """
        self.target_layout = layout
        meta = self._shm.load_meta()
        shm_ok = meta is not None and self._all_local(meta)
        shm_step = meta.step if shm_ok else -1
        known = [shm_step] + self.layout.committed_steps(self.storage)
        # Walk candidates newest-first, re-agreeing after each failure so a
        # corrupt newest step degrades to the next intact one on EVERY host.
        # Every iteration runs exactly two collectives on every host — the
        # step agreement and the outcome agreement — so hosts whose local
        # attempt succeeded keep participating until the whole world
        # succeeds (a lone host retrying would hang in a dead collective).
        upper: Optional[int] = None
        while True:
            local_best = max(
                (s for s in known if upper is None or s < upper), default=-1
            )
            step = self._agree_restore_step(local_best)
            if step < 0:
                return -1, None
            if upper is not None and step >= upper:
                # Agreement is not making progress (custom agree_fn pinned to
                # a dead step) — fail rather than spin.
                return -1, None
            if shm_ok and shm_step == step:
                logger.info("restoring step %d from shm", step)
                arrays = {
                    t.path: assemble_tensor(
                        t, lambda r: self._shm.load_block(meta, r)
                    )
                    for t in meta.tensors
                }
                result = self._materialize(arrays, meta, template)
            else:
                result = self._load_step_from_storage(step, template)
            world_ok = self._agree_min(1 if result is not None else 0) > 0
            if world_ok:
                return step, result
            logger.warning(
                "agreed step %d not restorable on every host; trying older "
                "steps (local attempt %s)",
                step, "succeeded" if result is not None else "failed",
            )
            upper = step

    def _agree_restore_step(self, candidate: int) -> int:
        """Agree the restore step across the world (min of candidates).

        Uses the injected ``agree_step_fn`` when given (tests, custom
        fabrics); otherwise the shared min-agreement fabric.
        """
        if self._agree_step_fn is not None:
            return self._agree_step_fn(candidate)
        agreed = self._agree_min(candidate)
        if agreed != candidate:
            logger.info(
                "restore step agreed across hosts: %d (local best %d)",
                agreed, candidate,
            )
        return agreed

    def _agree_min(self, value: int) -> int:
        """Min-reduce ``value`` across the restore world.

        A ``torch.distributed`` all-reduce (MIN) when the process group is
        initialized over exactly ``num_hosts`` ranks; a no-op at world 1.
        Falls back to the local value — loudly — when the collective cannot
        run (no process group, or the agent's ``num_hosts`` disagreeing
        with its world size): silently no-opping here would disable the
        divergent-restore guard exactly in the degraded states it exists
        for.
        """
        if self._agree_min_fn is not None:
            return self._agree_min_fn(value)
        world = default_num_hosts()
        if self.num_hosts > 1 and world == self.num_hosts:
            dist = torch.distributed
            on = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
            t = torch.tensor([value], dtype=torch.int64, device=on)
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            return int(t.item())
        if self.num_hosts > 1:
            logger.error(
                "restore agreement DEGRADED to local-only: num_hosts=%d but "
                "the process group's world is %d — cross-host "
                "divergent-restore protection is OFF for this restore",
                self.num_hosts, world,
            )
        return value

    def _all_local(self, meta: CheckpointMeta) -> bool:
        return all(t.local_covers_global for t in meta.tensors)

    def wait_saver(self, timeout: float = 600.0):
        """Block until every storage save this engine requested is durable.

        Uses the saver's published progress (persisted/committed step), not
        queue-emptiness — the queue is empty the instant the saver *pops* an
        event, long before the bytes are on storage, and host 0's commit
        barrier can run for minutes after its own persist.
        """
        target = self._latest_storage_step
        if target < 0:
            return True
        # The committing host (lowest live host id, published by the saver)
        # must additionally wait for the cross-host commit.
        committer = self._status.get("is_committer", self.host_index == 0)
        key = "committed_step" if committer else "persisted_step"
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            done = self._status.get(key, -1)
            if done is not None and done >= target:
                return True
            time.sleep(0.2)
        return False

    def latest_memory_step(self) -> int:
        return self._latest_memory_step

    def close(self):
        if self._saver is not None:
            self._saver.stop()
        self._shm.close()

"""Checkpoint storage backends + retention policies.

Capability parity with ref ``dlrover/python/common/storage.py:24-328``
(``PosixDiskStorage``, ``KeepStepIntervalStrategy``, ``KeepLatestStepStrategy``)
with a TPU-cloud slant: the canonical durable tier is an object store (GCS),
which on TPU VMs is mounted via gcsfuse or addressed through a same-API path
writer — both are covered by the posix backend here, and a dedicated
multipart GCS client can slot in behind the same interface.
"""

from __future__ import annotations

import os
import shutil
from abc import ABC, abstractmethod
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.retry import RetryPolicy


class CheckpointDeletionStrategy(ABC):
    """Decides which persisted step directories to clean up."""

    @abstractmethod
    def clean_up(self, step: int, delete_fn) -> None:
        """Called after ``step`` commits; ``delete_fn(step)`` removes one."""


class KeepLatestStepStrategy(CheckpointDeletionStrategy):
    def __init__(self, max_to_keep: int = 1):
        self._max_to_keep = max(1, max_to_keep)
        self._steps: List[int] = []

    def clean_up(self, step: int, delete_fn) -> None:
        self._steps.append(step)
        while len(self._steps) > self._max_to_keep:
            delete_fn(self._steps.pop(0))


class KeepStepIntervalStrategy(CheckpointDeletionStrategy):
    """Keep every ``keep_interval``-th step plus the latest committed one.

    The just-committed step is always retained (it is the resume point) —
    off-interval steps are pruned when the *next* step commits.
    """

    def __init__(self, keep_interval: int):
        self._keep_interval = keep_interval
        self._pending: Optional[int] = None

    def clean_up(self, step: int, delete_fn) -> None:
        if self._pending is not None and self._pending % self._keep_interval:
            delete_fn(self._pending)
        self._pending = step


class CheckpointStorage(ABC):
    @abstractmethod
    def write(self, content, path: str) -> None: ...

    @abstractmethod
    def read(self, path: str, mode: str = "rb"): ...

    @abstractmethod
    def safe_rmtree(self, dir_path: str) -> None: ...

    @abstractmethod
    def safe_makedirs(self, dir_path: str) -> None: ...

    @abstractmethod
    def exists(self, path: str) -> bool: ...

    @abstractmethod
    def listdir(self, path: str) -> List[str]: ...

    @abstractmethod
    def remove(self, path: str) -> None:
        """Delete one file; missing files are not an error."""

    def commit(self, step: int, success: bool) -> None:
        """Hook called once a step's files are all durable."""


class PosixDiskStorage(CheckpointStorage):
    """Local disk / NFS / gcsfuse-mounted bucket.

    Writes are torn-write-proof: content lands in a same-directory temp
    file, is fsync'd, then atomically ``os.replace``d into place — a
    preemption mid-write leaves either the old file or nothing, never a
    truncated shard.  Transient I/O errors (NFS/gcsfuse blips surface as
    ``OSError``) are retried on a short jittered policy; injected faults
    from the ``storage.write``/``storage.read`` seams are NOT retried
    here — they model failures the *caller's* recovery path must absorb.
    """

    # Short budget: checkpoint persists run off the training path, but a
    # mount that stays broken for >~2s should fail the persist (the saver
    # logs it and the next save retries whole) rather than wedge the
    # saver thread.
    _io_policy = RetryPolicy(
        max_attempts=3, base_delay_s=0.1, max_delay_s=1.0,
        retryable=(OSError,), fatal=(faults.FaultInjected,), name="storage_io",
    )

    def write(self, content, path: str) -> None:
        faults.fire("storage.write", path=os.path.basename(path))
        self._io_policy.call(self._write_once, content, path)

    @staticmethod
    def _write_once(content, path: str) -> None:
        mode = "wb" if isinstance(content, (bytes, memoryview)) else "w"
        tmp = path + ".tmp"
        with open(tmp, mode) as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def read(self, path: str, mode: str = "rb"):
        faults.fire("storage.read", path=os.path.basename(path))
        return self._io_policy.call(self._read_once, path, mode)

    @staticmethod
    def _read_once(path: str, mode: str):
        if not os.path.exists(path):
            return None
        with open(path, mode) as f:
            return f.read()

    def safe_rmtree(self, dir_path: str) -> None:
        shutil.rmtree(dir_path, ignore_errors=True)

    def safe_makedirs(self, dir_path: str) -> None:
        os.makedirs(dir_path, exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def remove(self, path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass


def digest_stamp(meta_crc: int, data_crc: int, data_nbytes: int) -> str:
    """Serialize one host's checkpoint digest sidecar (crc32 of the meta
    pickle, crc32 of the raw data bytes, and the data length so plain
    truncation is caught before any crc is computed)."""
    return f"v1 meta_crc32={meta_crc} data_crc32={data_crc} " \
           f"data_nbytes={data_nbytes}"


def parse_digest(content: Optional[str]):
    """Parse a digest sidecar -> (meta_crc, data_crc, data_nbytes) or None
    (missing/unreadable digests mean "legacy checkpoint, skip verify" —
    never "reject")."""
    if not content:
        return None
    fields = {}
    parts = content.split()
    if not parts or parts[0] != "v1":
        return None
    try:
        for part in parts[1:]:
            key, _, value = part.partition("=")
            fields[key] = int(value)
        return (
            fields["meta_crc32"], fields["data_crc32"], fields["data_nbytes"]
        )
    except (KeyError, ValueError):
        return None


def get_checkpoint_storage(
    deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
) -> CheckpointStorage:
    return PosixDiskStorage()


class CheckpointDirLayout:
    """Canonical on-storage layout of one job's checkpoints.

    checkpoint_dir/
      tracker.txt                 <- latest committed step (atomic replace)
      step_{N}/
        host_{i}_of_{n}.meta      <- pickled tensor index for host i
        host_{i}_of_{n}.data      <- raw tensor bytes for host i
        host_{i}_of_{n}.digest    <- crc32 stamp over meta+data (integrity)
        host_{i}.done             <- per-host done marker
    """

    TRACKER = "tracker.txt"

    def __init__(self, checkpoint_dir: str):
        self.root = checkpoint_dir

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def meta_path(self, step: int, host: int, num_hosts: int) -> str:
        return os.path.join(
            self.step_dir(step), f"host_{host}_of_{num_hosts}.meta"
        )

    def data_path(self, step: int, host: int, num_hosts: int) -> str:
        return os.path.join(
            self.step_dir(step), f"host_{host}_of_{num_hosts}.data"
        )

    def digest_path(self, step: int, host: int, num_hosts: int) -> str:
        return os.path.join(
            self.step_dir(step), f"host_{host}_of_{num_hosts}.digest"
        )

    def done_path(self, step: int, host: int) -> str:
        return os.path.join(self.step_dir(step), f"host_{host}.done")

    def tracker_path(self) -> str:
        return os.path.join(self.root, self.TRACKER)

    def latest_step(self, storage: CheckpointStorage) -> int:
        content = storage.read(self.tracker_path(), "r")
        if not content:
            return -1
        try:
            return int(content.strip())
        except ValueError:
            # A torn/garbage tracker must not take every committed step
            # down with it: fall back to scanning the step directories for
            # the newest one that actually finished (has done markers).
            logger.warning(
                "corrupt tracker file %r; falling back to directory scan",
                content,
            )
            return self.scan_latest_complete(storage)

    def scan_latest_complete(self, storage: CheckpointStorage) -> int:
        """Newest step directory containing at least one done marker —
        the tracker-less estimate of the last committed step."""
        for step in sorted(self.committed_steps(storage), reverse=True):
            names = storage.listdir(self.step_dir(step))
            if any(n.startswith("host_") and n.endswith(".done")
                   for n in names):
                return step
        return -1

    def committed_steps(self, storage: CheckpointStorage) -> List[int]:
        steps = []
        for name in storage.listdir(self.root):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(steps)

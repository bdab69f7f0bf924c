"""Trainer-side text-file shard reader: line ranges without top scans
(port of ``dlrover_tpu/data/text_shards.py``, whole; its fault seams go
through the port's ``common/faults.py``).

Capability ref: ``dlrover/python/master/shard/dataset_splitter.py:257``
(TextDatasetSplitter) and the text reading path of the reference's elastic
dataset — the master hands out [start, end) LINE ranges
(``TextDatasetSplitter`` in master/task_manager.py); this reader turns
them into lines in O(shard) time via a byte-offset index built once per
file (one sequential pass, cached on disk next to the file so restarts
and sibling workers skip the rebuild).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger


class TextShardReader:
    """Random access to line ranges of a (potentially large) text file."""

    INDEX_SUFFIX = ".lineidx.npy"

    def __init__(self, path: str, index_path: Optional[str] = None):
        self.path = path
        self._index_path = index_path or (path + self.INDEX_SUFFIX)
        self._offsets = self._load_or_build_index()
        faults.fire("storage.read", path=os.path.basename(path))
        self._file = open(path, "rb")

    @property
    def num_lines(self) -> int:
        return len(self._offsets) - 1

    def _load_or_build_index(self) -> np.ndarray:
        """offsets[i] = byte offset of line i; offsets[-1] = file size."""
        fsize = os.path.getsize(self.path)
        if os.path.exists(self._index_path):
            try:
                offsets = np.load(self._index_path)
                # The index is only valid for the file it was built from.
                if offsets.ndim == 1 and offsets.size >= 1 and (
                    int(offsets[-1]) == fsize
                ):
                    return offsets
                logger.warning(
                    "text index %s is stale (file size changed); rebuilding",
                    self._index_path,
                )
            except (OSError, ValueError):
                pass
        offsets = [0]
        with open(self.path, "rb") as f:
            for line in f:
                offsets.append(offsets[-1] + len(line))
        arr = np.asarray(offsets, np.int64)
        try:
            # Seam: a fired fault exercises the uncached-index path (the
            # offsets array is rebuilt per process instead of mmapped).
            faults.fire(
                "storage.write", path=os.path.basename(self._index_path)
            )
            tmp = self._index_path + f".tmp{os.getpid()}"
            np.save(tmp, arr)
            os.replace(tmp + ".npy" if not tmp.endswith(".npy") else tmp,
                       self._index_path)
        except (OSError, faults.FaultInjected) as e:
            logger.warning("could not cache text index: %s", e)
        return arr

    def read_shard(self, start: int, end: int) -> List[str]:
        """Lines [start, end) (newline-stripped); clamps to file length."""
        start = max(0, start)
        end = min(end, self.num_lines)
        if start >= end:
            return []
        self._file.seek(int(self._offsets[start]))
        blob = self._file.read(int(self._offsets[end] - self._offsets[start]))
        # Split on the SAME delimiter the index counted (\n bytes):
        # str.splitlines() also breaks on \v \f \x85   etc., which
        # would return more "lines" than the master's line accounting.
        lines = blob.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()  # shard ends on a newline: no phantom last line
        return [
            ln[:-1].decode("utf-8", errors="replace")
            if ln.endswith(b"\r") else ln.decode("utf-8", errors="replace")
            for ln in lines
        ]

    def read_line(self, index: int) -> str:
        """One line by number: a seek + bounded read, never a top scan."""
        if not 0 <= index < self.num_lines:
            raise IndexError(
                f"line {index} out of range [0, {self.num_lines})"
            )
        self._file.seek(int(self._offsets[index]))
        blob = self._file.read(
            int(self._offsets[index + 1] - self._offsets[index])
        )
        if blob.endswith(b"\n"):
            blob = blob[:-1]
        if blob.endswith(b"\r"):
            blob = blob[:-1]
        return blob.decode("utf-8", errors="replace")

    def read_task(self, task) -> List[str]:
        """Resolve a master ShardTask through the one canonical
        resolution (``task_sample_indices``); contiguous ranges keep the
        single-blob fast path."""
        from dlrover_tpu_torch.data.sharding_client import task_sample_indices

        indices = task_sample_indices(task)
        if isinstance(indices, range):
            return self.read_shard(indices.start, indices.stop)
        return [self.read_line(i) for i in indices]

    def close(self):
        self._file.close()

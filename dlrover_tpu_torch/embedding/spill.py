"""Disk spill tier for the sparse embedding store (hybrid mem/disk).

Port of ``dlrover_tpu/embedding/spill.py``: hot features live in memory,
cold features move to a disk tier and fault back in on access, so the
table's logical capacity exceeds RAM.

Design: an append-only record log per table with an in-memory index
{key -> offset}.  Deletions append TOMBSTONES (so a restart's index
rebuild honors fault-backs), truncated tail records from a crash
mid-append are dropped at rebuild, and ``compact()`` rewrites the log
keeping only live records.  Faulting promotes value AND optimizer moments
AND counts, so a faulted feature resumes training where it left off.

The record codec (:func:`pack_records` / :func:`unpack_records`) is also
the reshard's owner-to-owner wire format, byte for byte the JAX
package's.  The log's opens, appends, reads, rebuilds and compactions are
the ``storage.write``/``storage.read`` fault seams, and a demotion is an
``embed.spill`` span, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common import faults, telemetry
from dlrover_tpu_torch.embedding.store import KVStore

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<qIIi")  # key, count, step, payload_bytes
_TOMBSTONE = -1                   # payload_bytes sentinel: key deleted


def pack_records(keys, rows, m, v, counts, steps) -> bytes:
    """Serialize rows in the spill-log record format (header + fp32
    value|m|v payload per key) — also the owner-to-owner wire format the
    reshard row moves ride, so one record codec serves both the disk tier
    and the transport."""
    keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
    out = []
    for i, key in enumerate(keys.tolist()):
        payload = np.concatenate([
            np.asarray(a[i], np.float32).reshape(-1) for a in (rows, m, v)
        ]).tobytes()
        out.append(_HEADER.pack(
            int(key), int(counts[i]), int(steps[i]), len(payload)
        ))
        out.append(payload)
    return b"".join(out)


def unpack_records(data: bytes, dim: int):
    """Inverse of :func:`pack_records`: bytes -> (keys, rows, m, v,
    counts, steps) numpy arrays.  Raises ``ValueError`` on a short or
    malformed stream — a torn transport buffer must not half-apply."""
    payload_bytes = 3 * dim * 4
    keys, rows, m, v, counts, steps = [], [], [], [], [], []
    offset = 0
    while offset < len(data):
        if offset + _HEADER.size > len(data):
            raise ValueError("truncated record header in reshard stream")
        key, count, step, nbytes = _HEADER.unpack_from(data, offset)
        offset += _HEADER.size
        if nbytes != payload_bytes or offset + nbytes > len(data):
            raise ValueError(
                f"malformed record for key {key}: payload {nbytes} != "
                f"{payload_bytes} or stream truncated"
            )
        payload = np.frombuffer(data, np.float32, 3 * dim, offset)
        offset += nbytes
        keys.append(key)
        rows.append(payload[:dim])
        m.append(payload[dim: 2 * dim])
        v.append(payload[2 * dim: 3 * dim])
        counts.append(count)
        steps.append(step)
    empty = np.empty((0, dim), np.float32)
    return (
        np.asarray(keys, np.int64),
        np.stack(rows) if rows else empty,
        np.stack(m) if m else empty.copy(),
        np.stack(v) if v else empty.copy(),
        np.asarray(counts, np.uint32),
        np.asarray(steps, np.uint32),
    )


class SpillFile:
    """Append-only on-disk record store: key -> (value, m, v, count, step)."""

    def __init__(self, path: str, dim: int):
        self.path = path
        self.dim = dim
        self._index: Dict[int, int] = {}  # key -> record offset
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._payload = 3 * dim * 4  # value + m + v, fp32
        if os.path.exists(path):
            self._rebuild_index()
        # The append handle is the spill tier's write path; a full disk or
        # yanked mount surfaces here, so the drills must be able to reach it.
        faults.fire("storage.write", path=path, op="spill.open")
        self._file = open(path, "ab")
        self._reader = open(path, "rb")

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._index

    def keys(self):
        return list(self._index.keys())

    def _rebuild_index(self):
        faults.fire("storage.read", path=self.path, op="spill.rebuild")
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            while True:
                offset = f.tell()
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break  # truncated header: drop the tail
                key, _, _, nbytes = _HEADER.unpack(header)
                if nbytes == _TOMBSTONE:
                    self._index.pop(key, None)
                    continue
                if nbytes != self._payload or offset + _HEADER.size + nbytes > size:
                    # Corrupt or crash-truncated record: drop it and stop —
                    # anything after an inconsistent record is unreliable.
                    logger.warning(
                        "spill log %s: dropping invalid record at %d",
                        self.path, offset,
                    )
                    break
                f.seek(nbytes, os.SEEK_CUR)
                self._index[key] = offset  # later records win

    def append(self, key: int, row: np.ndarray, m: np.ndarray,
               v: np.ndarray, count: int, step: int):
        payload = np.concatenate(
            [np.asarray(a, np.float32).reshape(-1) for a in (row, m, v)]
        ).tobytes()
        assert len(payload) == self._payload
        faults.fire("storage.write", path=self.path, op="spill.append")
        offset = self._file.tell()
        self._file.write(
            _HEADER.pack(int(key), int(count), int(step), len(payload))
        )
        self._file.write(payload)
        self._index[int(key)] = offset

    def flush(self, durable: bool = False):
        self._file.flush()
        if durable:
            # Page-cache flush alone is not crash-safe: a demote that
            # evicts the RAM copy before the OS writes the page back would
            # lose the row from both tiers on power loss.
            os.fsync(self._file.fileno())

    def read(self, key: int) -> Optional[Tuple]:
        offset = self._index.get(int(key))
        if offset is None:
            return None
        faults.fire("storage.read", path=self.path, op="spill.read")
        self.flush()  # the reader must see everything appended so far
        self._reader.seek(offset)
        _, count, step, nbytes = _HEADER.unpack(
            self._reader.read(_HEADER.size)
        )
        payload = np.frombuffer(self._reader.read(nbytes), np.float32)
        row = payload[: self.dim]
        m = payload[self.dim: 2 * self.dim]
        v = payload[2 * self.dim: 3 * self.dim]
        return row, m, v, count, step

    def remove(self, key: int):
        """Tombstone the key: the deletion must survive an index rebuild
        (a resurrected stale record would clobber newer RAM state)."""
        if int(key) not in self._index:
            return
        self._file.write(_HEADER.pack(int(key), 0, 0, _TOMBSTONE))
        self._index.pop(int(key), None)

    def compact(self):
        """Rewrite the log keeping only live records (drops tombstones and
        superseded generations)."""
        self.flush()
        live = list(self._index.keys())
        tmp = self.path + ".compact"
        faults.fire("storage.write", path=self.path, op="spill.compact")
        with open(tmp, "wb") as out:
            new_index: Dict[int, int] = {}
            for key in live:
                record = self.read(key)
                if record is None:
                    continue
                row, m, v, count, step = record
                payload = np.concatenate([row, m, v]).astype(
                    np.float32
                ).tobytes()
                new_index[key] = out.tell()
                out.write(_HEADER.pack(key, count, step, len(payload)))
                out.write(payload)
        self._file.close()
        self._reader.close()
        os.replace(tmp, self.path)
        self._index = new_index
        self._file = open(self.path, "ab")
        self._reader = open(self.path, "rb")

    def close(self):
        for handle in (self._file, self._reader):
            try:
                handle.close()
            except OSError:
                pass


class HybridKVStore:
    """KVStore facade with a disk tier: RAM holds the hot set.

    ``spill(max_age_steps, min_count)`` demotes cold features to disk
    (instead of the base store's destructive ``evict``); lookups fault
    spilled features back with their optimizer moments intact.  A key lives
    in EXACTLY one tier: fault-in and insert tombstone the disk copy.
    """

    def __init__(self, dim: int, spill_path: str,
                 native: Optional[bool] = None):
        self.dim = dim
        self.ram = KVStore(dim, native=native)
        self.disk = SpillFile(spill_path, dim)
        # Serializes compound two-tier operations: SpillFile shares one
        # reader handle (seek+read pairs).  The RAM tier has its own lock.
        self._mu = threading.RLock()

    def __len__(self) -> int:
        with self._mu:
            return len(self.ram) + len(self.disk)

    @property
    def ram_rows(self) -> int:
        return len(self.ram)

    @property
    def disk_rows(self) -> int:
        return len(self.disk)

    def _fault_in(self, keys: np.ndarray) -> int:
        """Promote any spilled keys back into RAM; returns faults."""
        with self._mu:
            faulted = 0
            for key in np.unique(np.asarray(keys, np.int64)):
                record = self.disk.read(int(key))
                if record is None:
                    continue
                row, m, v, count, step = record
                self.ram.insert(
                    np.asarray([key], np.int64),
                    row[None], m[None], v[None],
                    np.asarray([count], np.uint32),
                    np.asarray([step], np.uint32),
                )
                self.disk.remove(int(key))
                faulted += 1
            return faulted

    def lookup(self, keys: np.ndarray, init_scale: float = 0.01,
               seed: int = 0, step: int = 0) -> np.ndarray:
        with self._mu:
            faults = self._fault_in(keys)
            if faults:
                logger.debug("embedding spill: faulted %d rows back", faults)
            return self.ram.lookup(keys, init_scale, seed, step)

    def peek(self, keys: np.ndarray) -> np.ndarray:
        """Read-only: serves RAM rows and disk rows without promotion."""
        with self._mu:
            out = self.ram.peek(keys)
            flat = np.asarray(keys, np.int64).reshape(-1)
            for i, key in enumerate(flat.tolist()):
                if not out[i].any() and key in self.disk:
                    record = self.disk.read(key)
                    if record is not None:
                        out[i] = record[0]
            return out

    # Gradients only exist for rows lookup() faulted in this step, so every
    # group-sparse optimizer applies against the RAM tier alone.
    def apply_group_adam(self, *args, **kwargs):
        with self._mu:
            self.ram.apply_group_adam(*args, **kwargs)

    def apply_group_adagrad(self, *args, **kwargs):
        with self._mu:
            self.ram.apply_group_adagrad(*args, **kwargs)

    def apply_group_ftrl(self, *args, **kwargs):
        with self._mu:
            self.ram.apply_group_ftrl(*args, **kwargs)

    def apply_group_lamb(self, *args, **kwargs):
        with self._mu:
            self.ram.apply_group_lamb(*args, **kwargs)

    def spill(self, min_step: int, min_count: int = 0) -> int:
        """Demote features colder than the thresholds to the disk tier."""
        with self._mu, telemetry.span("embed.spill") as sp:
            keys, rows, m, v, counts, steps = self.ram.export()
            cold = [
                i for i in range(keys.size)
                if steps[i] < min_step and counts[i] < min_count
            ]
            for i in cold:
                self.disk.append(
                    int(keys[i]), rows[i], m[i], v[i],
                    int(counts[i]), int(steps[i]),
                )
            if cold:
                # Durable flush (fsync): the RAM removal below is destructive,
                # so the spilled rows must be on stable storage first.
                self.disk.flush(durable=True)
                self.ram.evict(min_step, min_count)
            if sp is not None:
                sp.attrs["rows"] = len(cold)
                sp.attrs["bytes"] = len(cold) * (3 * self.dim * 4 + 20)
            return len(cold)

    def export(self, min_step: int = 0):
        """Export spans BOTH tiers with the same recency filter — a row
        touched inside the delta window may have been spilled since."""
        with self._mu:
            ram = self.ram.export(min_step)
            disk_hits = []
            for key in self.disk.keys():
                record = self.disk.read(key)
                if record is None:
                    continue
                if min_step and record[4] < min_step:
                    continue
                disk_hits.append((key, *record))
            if not disk_hits:
                return ram
            keys = list(ram[0]) + [h[0] for h in disk_hits]
            rows = list(ram[1]) + [h[1] for h in disk_hits]
            m = list(ram[2]) + [h[2] for h in disk_hits]
            v = list(ram[3]) + [h[3] for h in disk_hits]
            counts = list(ram[4]) + [h[4] for h in disk_hits]
            steps = list(ram[5]) + [h[5] for h in disk_hits]
            return (
                np.asarray(keys, np.int64),
                np.asarray(rows, np.float32).reshape(-1, self.dim),
                np.asarray(m, np.float32).reshape(-1, self.dim),
                np.asarray(v, np.float32).reshape(-1, self.dim),
                np.asarray(counts, np.uint32),
                np.asarray(steps, np.uint32),
            )

    def insert(self, keys, rows, m=None, v=None, counts=None, steps=None):
        """Import path: the RAM copy becomes authoritative — tombstone any
        disk copy or a later fault-in would clobber it with stale state."""
        with self._mu:
            self.ram.insert(keys, rows, m, v, counts, steps)
            for key in np.asarray(keys, np.int64).reshape(-1).tolist():
                self.disk.remove(int(key))
            self.disk.flush()

    def remove(self, keys) -> int:
        """Delete specific keys from whichever tier holds them (reshard
        row-move path); disk copies are tombstoned so an index rebuild
        cannot resurrect a row that migrated to another owner."""
        with self._mu:
            keys = np.asarray(keys, np.int64).reshape(-1)
            removed = self.ram.remove(keys)
            for key in keys.tolist():
                if key in self.disk:
                    self.disk.remove(int(key))
                    removed += 1
            self.disk.flush()
            return removed

    def evict(self, min_step: int, min_count: int = 0) -> int:
        """Destructive eviction across BOTH tiers."""
        with self._mu:
            dropped = self.ram.evict(min_step, min_count)
            for key in self.disk.keys():
                record = self.disk.read(key)
                if record and record[4] < min_step and record[3] < min_count:
                    self.disk.remove(key)
                    dropped += 1
            return dropped

    def compact(self):
        with self._mu:
            self.disk.compact()

    def close(self):
        with self._mu:
            self.disk.close()
            self.ram.close()

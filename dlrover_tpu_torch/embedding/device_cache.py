"""Device-resident hot-row cache over the sharded embedding plane (port of
``dlrover_tpu/embedding/device_cache.py``).

The plane (``embedding/sharded.py``) is host memory; the model runs on the
card.  Without a cache every step pays a host gather and a host-to-device
copy for every unique key.  This cache keeps the hot working set resident
in a fixed ``[capacity, dim]`` fp32 tensor on the card:

- a step's unique keys split into hits (already resident: no host work,
  no transfer) and misses (fetched from their owners once, scattered into
  free slots);
- the device side is two kernels (``embedding/kernels.py``): gather the
  padded slot set out (K10a), scatter the padded miss set in (K10b, in
  place).  Slot arrays are padded to ``max_unique``, so each call is one
  launch whatever the batch; ``gathers``/``scatters`` count the calls;
- slot 0 is a scratch slot no real key ever occupies: padding targets it
  on both paths, which keeps the padded scatter in bounds and the padded
  gather harmless (the inverse mapping never points at the tail);
- eviction is LRU among keys outside the current batch;
- after a gradient push the touched rows are re-peeked from the plane and
  scattered back, so the device copy stays bitwise-equal to the host
  truth.

The slot discipline (free list popping 1, 2, 3, ..., LRU order, padding)
is the JAX cache's, so slot assignments and hit, miss and eviction counts
equal it on one stream.

``EmbeddingPrefetcher`` keeps batches ahead of the consumer, with a
generation-token drain: ``drain()`` invalidates in-flight prefetch work so
a resize/restore can re-issue it against the re-folded plane (same-thread
contract).
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.embedding import kernels
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device


class DeviceHotRowCache:
    """Fixed-capacity device row cache with host-side key->slot mapping."""

    def __init__(self, plane, capacity: int, max_unique: int,
                 device: DeviceLike = None):
        if capacity < max_unique + 1:
            raise ValueError(
                f"capacity ({capacity}) must exceed max_unique "
                f"({max_unique}): one batch's unique keys plus the "
                "scratch slot must fit"
            )
        self.device = resolve_device(device)
        self.plane = plane
        self.capacity = int(capacity)
        self.max_unique = int(max_unique)
        self.dim = int(plane.dim)
        self._cache = torch.zeros((self.capacity, self.dim),
                                  dtype=torch.float32, device=self.device)
        self._slot_of: Dict[int, int] = {}
        self._lru: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict()
        )
        # Slot 0 is scratch (padding target), never allocated to a key.
        self._free = list(range(self.capacity - 1, 0, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Calls of the two kernels' wrappers (one launch each on the card),
        # and the ensures that fetched misses from the plane (one scatter
        # each; every refresh with a resident key is the other kind).
        self.gathers = 0
        self.scatters = 0
        self.fetches = 0

    def memory_buffers(self):
        """The device-resident hot-row pool."""
        return [self._cache]

    # -- residency -------------------------------------------------------------

    def __contains__(self, key: int) -> bool:
        return int(key) in self._slot_of

    def __len__(self) -> int:
        return len(self._slot_of)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def slots_of(self, keys) -> np.ndarray:
        """Resident slots of ``keys`` padded to ``max_unique`` (KeyError
        for a key that is not resident)."""
        return self._pad_slots([self._slot_of[k] for k in
                                np.asarray(keys, np.int64).tolist()])

    def _touch(self, key: int):
        self._lru.pop(key, None)
        self._lru[key] = None

    def _evict_for(self, need: int, protected: set) -> None:
        """Free ``need`` slots by dropping LRU keys outside ``protected``
        (the current batch must never evict itself)."""
        while len(self._free) < need:
            for key in self._lru:
                if key not in protected:
                    victim = key
                    break
            else:  # pragma: no cover - capacity check makes this unreachable
                raise RuntimeError("cache wedged: all slots protected")
            self._lru.pop(victim)
            self._free.append(self._slot_of.pop(victim))
            self.evictions += 1

    def _pad_slots(self, slots) -> np.ndarray:
        out = np.zeros(self.max_unique, np.int32)  # pad -> scratch slot 0
        out[: len(slots)] = slots
        return out

    def _pad_rows(self, rows: np.ndarray) -> np.ndarray:
        out = np.zeros((self.max_unique, self.dim), np.float32)
        out[: rows.shape[0]] = rows
        return out

    def _scatter(self, slots, rows: np.ndarray) -> None:
        # The padded rows are a new host array per call and the upload is
        # blocking, so no copy can still be reading a buffer that is reused.
        kernels.scatter_rows(self._cache, self._pad_slots(slots),
                             self._pad_rows(rows))
        self.scatters += 1

    def _ensure(self, unique: np.ndarray) -> int:
        """Make every key in ``unique`` resident; returns the miss count."""
        if unique.size > self.max_unique:
            raise ValueError(
                f"batch has {unique.size} unique keys > max_unique "
                f"{self.max_unique}; size the cache for the worst batch"
            )
        keys = unique.tolist()
        miss = [k for k in keys if k not in self._slot_of]
        self.hits += len(keys) - len(miss)
        self.misses += len(miss)
        for k in keys:
            if k in self._slot_of:
                self._touch(k)
        if not miss:
            return 0
        rows, uniq, _ = self.plane.lookup(np.asarray(miss, np.int64))
        self._evict_for(len(miss), protected=set(keys))
        slots = []
        for k in uniq.tolist():
            slot = self._free.pop()
            self._slot_of[k] = slot
            self._touch(k)
            slots.append(slot)
        self._scatter(slots, rows)
        self.fetches += 1
        return len(miss)

    # -- the step-facing API ---------------------------------------------------

    def lookup(self, keys) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """Device-resident gather for a batch of int64 keys.

        Returns ``(rows [max_unique, dim] tensor on the cache's device,
        unique, inverse)``: feed ``rows[inverse]`` to the model; the padded
        tail rows are scratch the inverse never references.
        """
        flat = np.ascontiguousarray(keys, np.int64).reshape(-1)
        unique, inverse = np.unique(flat, return_inverse=True)
        self._ensure(unique)
        rows = kernels.gather_rows(self._cache, self.slots_of(unique))
        self.gathers += 1
        return rows, unique, inverse.astype(np.int32)

    def prefetch(self, keys) -> int:
        """Warm the cache for a FUTURE batch's keys: misses are fetched
        from their owners and scattered now.  Returns the miss count the
        prefetch absorbed."""
        flat = np.ascontiguousarray(keys, np.int64).reshape(-1)
        unique = np.unique(flat)
        return self._ensure(unique)

    def apply_gradients(self, unique_keys, grad_rows) -> None:
        """Push gradients to the plane, then write the updated host rows
        back into their device slots: the device copy stays bitwise-equal
        to host truth."""
        self.plane.apply_gradients(unique_keys, grad_rows)
        self.refresh(unique_keys)

    def refresh(self, keys) -> int:
        """Re-scatter the current host values of any cached ``keys``."""
        flat = np.ascontiguousarray(keys, np.int64).reshape(-1)
        cached = [k for k in np.unique(flat).tolist()
                  if k in self._slot_of]
        if not cached:
            return 0
        rows = self.plane.peek(np.asarray(cached, np.int64))
        self._scatter([self._slot_of[k] for k in cached], rows)
        return len(cached)

    def invalidate(self) -> None:
        """Drop all residency (restore/rebuild path: host rows changed
        under the cache) and zero the device buffer."""
        self._slot_of.clear()
        self._lru.clear()
        self._free = list(range(self.capacity - 1, 0, -1))
        self._cache.zero_()

    def stats(self) -> Dict[str, float]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "cached_rows": len(self._slot_of),
            "capacity": self.capacity - 1,
            "evictions": self.evictions,
            "gathers": self.gathers,
            "scatters": self.scatters,
            "fetches": self.fetches,
        }


class EmbeddingPrefetcher:
    """Prefetches future batches' embedding rows into the device cache.

    Keeps up to ``depth`` batches' unique IDs warmed ahead of the consumer,
    so batch N+1's owner fetches and scatters happen before its step.

    Drain contract (live resize): ``drain()`` bumps a generation token;
    the active pass notices before handing out its next batch and
    re-issues ``cache.prefetch`` for every buffered batch: after a
    reshard/restore the residency it warmed may be gone (cache
    invalidated), but no *data* is lost: the host batches are retained.
    Same-thread only, like iteration.
    """

    def __init__(self, source, cache: DeviceHotRowCache,
                 key_field: str = "ids", depth: int = 2):
        self.source = source
        self.cache = cache
        self.key_field = key_field
        self.depth = max(1, depth)
        self._generation = 0
        self._buf = None

    def drain(self) -> int:
        """Invalidate in-flight prefetch work (keep the host batches).
        Returns how many buffered batches the active pass re-warms."""
        self._generation += 1
        return len(self._buf) if self._buf is not None else 0

    def __iter__(self) -> Iterator:
        it = iter(self.source)
        gen = self._generation
        buf: collections.deque = collections.deque()
        self._buf = buf

        def top_up():
            while len(buf) < self.depth:
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.cache.prefetch(batch[self.key_field])
                buf.append(batch)

        try:
            top_up()
            while buf:
                if gen != self._generation:
                    # Drained: the residency warmed for these batches
                    # belonged to the pre-resize plane; re-warm from the
                    # retained host batches against the current one.
                    gen = self._generation
                    for batch in buf:
                        self.cache.prefetch(batch[self.key_field])
                batch = buf.popleft()
                top_up()
                yield batch
        finally:
            self._buf = None
            if hasattr(it, "close"):
                it.close()

"""Classified device-memory accounting: measure device memory, name every
byte (port of ``dlrover_tpu/utils/memory_profile.py``).

- :func:`device_memory_stats` reads the CUDA caching allocator of every
  card this process has allocated on (``torch.cuda.memory_stats``):
  ``bytes_in_use`` is ``allocated_bytes.all.current``, the bytes of live
  tensors as the allocator rounds them (its 512-byte blocks), not the
  larger ``reserved`` bytes the caching allocator keeps (those
  ride along as ``reserved_bytes``); ``peak_bytes`` is
  ``allocated_bytes.all.peak``; ``limit_bytes`` is the card's memory
  (``torch.cuda.mem_get_info``).  The CPU has no allocator statistics:
  there ``bytes_in_use`` (and ``peak_bytes``) is the bytes of the
  buffers the registry names, ``limit_bytes`` 0 (unknown) and ``source``
  ``registry_fallback``.  Nothing walks the garbage collector's objects.
- :class:`BufferRegistry` classifies live buffers into named pools
  (params, optimizer state, KV pool, embedding hot-row cache, prefetch
  buffers, other).  Owners register a zero-arg provider returning the
  tensors they hold (any nest of dicts, lists, tuples and named tuples);
  bound-method providers are held via ``weakref.WeakMethod`` so a dead
  owner silently unregisters itself.
- :func:`compiled_memory_analysis` keeps the reference's API: eager
  PyTorch compiles no program, so it returns ``None`` for anything that
  has no ``memory_analysis()`` (and nothing is booked), as the
  reference does on a backend that lacks one.
- :func:`emit_memory_event` ships one flat-attr ``memory`` telemetry
  event per report tick for the master's ``MemoryLedger``.
- :func:`dump_oom_postmortem` writes a classified buffer table (pool,
  shape, dtype, device, bytes, top-N) next to the checkpoint dir when a
  step dies of an allocator failure (``torch.OutOfMemoryError``).

All byte accounting is **per device**: a rank's tensor already is its
shard (ZeRO-1's optimizer state, the fsdp and tensor boxes), so a tensor
contributes its own ``numel * element_size``.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import default_logger as logger

#: Pool names, in the order postmortem tables and gauges present them.
POOLS: Tuple[str, ...] = (
    "params", "opt_state", "kv_pool", "embed_cache", "prefetch", "other",
)


def per_device_nbytes(arr: Any) -> int:
    """Bytes one device holds for ``arr``: a tensor's (this rank's shard)
    ``numel * element_size``, an array's ``nbytes``, 0 for anything
    else."""
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    try:
        return int(arr.nbytes)
    except Exception:
        return 0


def _leaves(tree: Any) -> List[Any]:
    """The tensors and arrays of a nest of dicts, lists, tuples, named
    tuples and dataclasses."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def tree_device_nbytes(tree: Any) -> int:
    """Per-device bytes of every tensor leaf in ``tree``."""
    return sum(per_device_nbytes(leaf) for leaf in _leaves(tree))


class BufferRegistry:
    """Name → (pool, provider) map classifying live device buffers.

    A provider is a zero-arg callable returning the tensors (any nest)
    its owner currently holds; it is called only at snapshot time, so
    registration costs one dict insert and the step path costs nothing.
    Bound methods are stored as ``weakref.WeakMethod`` — when the owner
    is collected the entry prunes itself at the next snapshot, so
    per-instance registrations (prefetchers rebuilt every epoch,
    short-lived serving engines) cannot leak.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, Tuple[str, Any]] = {}

    def register(self, pool: str, name: str, provider: Callable[[], Any]):
        if pool not in POOLS:
            pool = "other"
        if inspect.ismethod(provider):
            provider = weakref.WeakMethod(provider)
        with self._lock:
            self._entries[name] = (pool, provider)

    def unregister(self, name: str):
        with self._lock:
            self._entries.pop(name, None)

    def clear(self):
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _resolved(self) -> List[Tuple[str, str, Callable[[], Any]]]:
        """(pool, name, live provider) triples; prunes dead WeakMethods."""
        out = []
        dead = []
        with self._lock:
            items = list(self._entries.items())
        for name, (pool, provider) in items:
            fn = provider() if isinstance(provider, weakref.WeakMethod) \
                else provider
            if fn is None:
                dead.append(name)
                continue
            out.append((pool, name, fn))
        if dead:
            with self._lock:
                for name in dead:
                    self._entries.pop(name, None)
        return out

    def pool_bytes(self) -> Dict[str, int]:
        """Per-device bytes per pool.  A provider that raises is counted
        as zero — accounting must never take down the step loop."""
        totals = {pool: 0 for pool in POOLS}
        for pool, name, fn in self._resolved():
            try:
                totals[pool] += tree_device_nbytes(fn())
            except Exception as e:  # pragma: no cover - defensive
                logger.debug("memory registry provider %s failed: %s",
                             name, e)
        return totals

    def rows(self) -> List[Dict[str, Any]]:
        """One classified row per registered tensor, largest first — the
        postmortem table."""
        rows: List[Dict[str, Any]] = []
        for pool, name, fn in self._resolved():
            try:
                leaves = _leaves(fn())
            except Exception:
                continue
            for leaf in leaves:
                rows.append({
                    "pool": pool,
                    "name": name,
                    "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype),
                    "device": str(getattr(leaf, "device", "cpu")),
                    "nbytes": per_device_nbytes(leaf),
                })
        rows.sort(key=lambda r: -r["nbytes"])
        return rows


_REGISTRY = BufferRegistry()


def registry() -> BufferRegistry:
    """The process-wide buffer registry."""
    return _REGISTRY


def cards_in_use() -> List[int]:
    """The cards this process has allocated on (reading another card's
    limit would open a context there)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return [d for d in range(torch.cuda.device_count())
            if torch.cuda.memory_reserved(d) > 0]


def card_memory_stats() -> List[Dict[str, int]]:
    """One row per card this process has allocated on: ``in_use`` and
    ``peak`` (``allocated_bytes.all`` of ``torch.cuda.memory_stats``:
    bytes held by live tensors, not the allocator's cache), ``reserved``
    (``reserved_bytes.all.current``) and ``limit`` (the card's memory,
    ``torch.cuda.mem_get_info``).  Empty where no card is in use."""
    rows = []
    for card in cards_in_use():
        stats = torch.cuda.memory_stats(card)
        rows.append({
            "in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak": int(stats.get("allocated_bytes.all.peak", 0)),
            "reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "limit": int(torch.cuda.mem_get_info(card)[1]),
        })
    return rows


def device_memory_stats() -> Dict[str, Any]:
    """Allocator truth per local card (:func:`card_memory_stats`), summed
    across the host.

    Returns flat ``bytes_in_use`` / ``peak_bytes`` / ``limit_bytes`` /
    ``reserved_bytes`` / ``headroom_frac`` plus ``source``
    (``allocator``, or ``registry_fallback`` where no card is in use:
    see the module docstring).
    """
    cards = card_memory_stats()
    in_use, peak, reserved, limit = (
        sum(c[k] for c in cards)
        for k in ("in_use", "peak", "reserved", "limit"))
    if not cards:
        in_use = peak = sum(_REGISTRY.pool_bytes().values())
    headroom = (1.0 - in_use / limit) if limit > 0 else -1.0
    return {
        "bytes_in_use": in_use,
        "peak_bytes": peak,
        "limit_bytes": limit,
        "reserved_bytes": reserved,
        "headroom_frac": headroom,
        "source": "allocator" if cards else "registry_fallback",
    }


# A compiled program's memory analysis per compile-cache key.
_ANALYSES: Dict[str, Dict[str, int]] = {}
_ANALYSES_LOCK = threading.Lock()

_ANALYSIS_FIELDS = {
    "xla_temp_b": "temp_size_in_bytes",
    "xla_arg_b": "argument_size_in_bytes",
    "xla_out_b": "output_size_in_bytes",
    "xla_code_b": "generated_code_size_in_bytes",
}


def compiled_memory_analysis(compiled: Any) -> Optional[Dict[str, int]]:
    """Extract ``memory_analysis()`` from a compiled program into the
    flat ``xla_*_b`` dict, or ``None`` where there is none (every eager
    PyTorch step)."""
    try:
        analysis = compiled.memory_analysis()
    except Exception:
        return None
    if analysis is None:
        return None
    out = {}
    for attr, field in _ANALYSIS_FIELDS.items():
        out[attr] = int(getattr(analysis, field, 0) or 0)
    return out


def record_compiled_analysis(cache_key: str, compiled: Any
                             ) -> Optional[Dict[str, int]]:
    """Book a compiled program's memory analysis under its compile-cache
    key (the same key the calibration ledger uses)."""
    info = compiled if isinstance(compiled, dict) \
        else compiled_memory_analysis(compiled)
    if not info:
        return None
    with _ANALYSES_LOCK:
        _ANALYSES[cache_key or "uncacheable"] = dict(info)
    return info


def compiled_analysis(cache_key: str) -> Optional[Dict[str, int]]:
    with _ANALYSES_LOCK:
        info = _ANALYSES.get(cache_key or "uncacheable")
        return dict(info) if info else None


def snapshot(cache_key: str = "") -> Dict[str, Any]:
    """One classified memory snapshot: allocator stats + per-pool bytes
    + the booked compile analysis for ``cache_key``.  Flat dict — the
    payload of the ``memory`` telemetry event."""
    snap: Dict[str, Any] = device_memory_stats()
    pools = _REGISTRY.pool_bytes()
    for pool in POOLS:
        snap[f"pool_{pool}_b"] = pools[pool]
    analysis = compiled_analysis(cache_key)
    if analysis:
        snap.update(analysis)
    return snap


def emit_memory_event(
    *,
    step: int,
    cache_key: str = "",
    modeled_b: float = 0.0,
) -> Optional[Dict[str, Any]]:
    """Ship one flat-attr ``memory`` event on the report cadence.

    ``measured_b`` is the allocator's bytes_in_use (or the registry
    fallback); ``modeled_b`` is the caller's analytic estimate for the
    same buffers — the pair feeds the master's calibration ledger.
    Returns the attrs emitted, or ``None`` when the recorder is
    disabled.
    """
    if not telemetry.recorder().enabled:
        return None
    attrs = snapshot(cache_key)
    attrs["step"] = int(step)
    attrs["cache_key"] = cache_key or "uncacheable"
    attrs["measured_b"] = float(attrs["bytes_in_use"])
    attrs["modeled_b"] = float(modeled_b)
    attrs["headroom_frac"] = round(float(attrs["headroom_frac"]), 4)
    telemetry.event("memory", **attrs)
    return attrs


def is_oom_error(e: BaseException) -> bool:
    """Does this look like a device allocator exhaustion?"""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    text = f"{type(e).__name__}: {e}"
    return "RESOURCE_EXHAUSTED" in text or "Out of memory" in text \
        or "out of memory" in text


def dump_oom_postmortem(
    directory: str,
    *,
    error: Optional[BaseException] = None,
    cache_key: str = "",
    top_n: int = 20,
) -> Optional[str]:
    """Write the classified buffer table next to the checkpoint dir
    after an OOM: who was holding the device memory when the allocator
    gave up.  ``unclassified_live_b`` is what the allocator holds beyond
    the registered pools (0 on the CPU, where the allocator is not
    read); the allocator counts bytes, not tensors, so
    ``unclassified_live_n`` is None.  Returns the path written, or
    ``None`` on any failure (forensics must never mask the original
    error)."""
    try:
        rows = _REGISTRY.rows()
        pools = _REGISTRY.pool_bytes()
        device = device_memory_stats()
        unregistered_b = (
            max(0, device["bytes_in_use"] - sum(pools.values()))
            if device["source"] == "allocator" else 0
        )
        report = {
            "error": f"{type(error).__name__}: {error}" if error else "",
            "cache_key": cache_key or "uncacheable",
            "device": device,
            "compiled": compiled_analysis(cache_key),
            "pools_b": pools,
            "unclassified_live_b": unregistered_b,
            "unclassified_live_n": None,
            "top": rows[:top_n],
            "rows_total": len(rows),
        }
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "oom_postmortem.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, path)
        logger.error(
            "OOM postmortem: %d classified buffers, pools=%s -> %s",
            len(rows), report["pools_b"], path,
        )
        return path
    except Exception as e:  # pragma: no cover - defensive
        logger.warning("OOM postmortem dump failed: %s", e)
        return None

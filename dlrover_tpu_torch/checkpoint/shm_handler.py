"""Shared-memory checkpoint arena: pickle-free tree <-> shm packing (port of
``dlrover_tpu/checkpoint/shm_handler.py``).

The hot path of Flash Checkpoint: every tensor of the train state is
copied device->host straight into one posix shm arena, with a pickled
*index* (not pickled tensors) describing every leaf.  The arena outlives
the trainer process, so the saver can persist it even after a SIGKILL.

Layout of the arena (the JAX package's, byte for byte)::

    [8B meta_len][meta pickle][leaf0 bytes][leaf1 bytes]...

The state is a tree of dicts, lists, tuples, named tuples and dataclasses
whose leaves are tensors (any device), numpy arrays or Python scalars.
Its paths are spelled as ``jax.tree_util.keystr`` spells them (``['params']``
for a dict key, ``[0]`` for a sequence index, ``.count`` for a field) and
its leaves are ordered as JAX orders them (dict keys sorted), so a path
means the same leaf in either package.  Dtypes are recorded as numpy's
``dtype.str``; bf16, which numpy lacks, is ``'<V2'`` as JAX's
``ml_dtypes.bfloat16`` records itself, so each package reads the other's
bf16 leaves.

A data rank holds pieces of the state: a ZeRO-1 optimizer-state leaf is
split over the data ranks, and a parameter is replicated on every rank.
``pack_pytree(state, step, extra, layout)`` takes each leaf's
:class:`LeafLayout` (the whole leaf's shape, this rank's slice of it and
its replica id) and, as the reference's ``_select_shards`` keeps the
shards with ``replica_id == 0``, writes a piece only where this rank
holds its replica 0: the owners write the shards, rank 0 the replicated
leaves, and each piece is stored exactly once across the ranks, with
its global index so a restore can reassemble it under any other split.
Without a layout every leaf is one whole block, as at one rank.

A meta pickle written by the JAX package names the JAX package's classes;
:func:`loads_meta` maps those three names onto this module's and refuses
any other name of the JAX stack, so reading one imports nothing of it.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import struct
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    SharedMemory,
    attach_or_none,
)

_HEADER = struct.Struct("<Q")

Path = Tuple[str, ...]

#: numpy's ``dtype.str`` of each torch dtype a leaf may have; bf16 is
#: recorded as ``ml_dtypes.bfloat16`` records itself under JAX.
_DTYPE_STR = {
    torch.float64: "<f8", torch.float32: "<f4", torch.float16: "<f2",
    torch.bfloat16: "<V2", torch.int64: "<i8", torch.int32: "<i4",
    torch.int16: "<i2", torch.int8: "|i1", torch.uint8: "|u1",
    torch.bool: "|b1",
}


@dataclasses.dataclass
class ShardRecord:
    """One stored contiguous block of a leaf."""

    index: Tuple[Tuple[int, Optional[int]], ...]  # (start, stop) per dim
    offset: int
    nbytes: int
    shape: Tuple[int, ...]
    # crc32 of this block's raw bytes, stamped by the saver when the shard
    # is persisted to durable storage (None in shm / legacy checkpoints —
    # restore treats a missing digest as "skip verify", never "reject").
    crc32: Optional[int] = None


@dataclasses.dataclass
class TensorMeta:
    path: Path
    global_shape: Tuple[int, ...]
    dtype: str
    shards: List[ShardRecord]

    @property
    def local_covers_global(self) -> bool:
        covered = sum(int(np.prod(s.shape)) for s in self.shards)
        return covered == int(np.prod(self.global_shape))


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Where one leaf lies on one rank: the whole leaf's shape, the
    rank's slice of it (``(start, stop)`` per dimension) and the rank's
    replica id of that slice (0 on the one rank that writes it)."""

    global_shape: Tuple[int, ...]
    index: Tuple[Tuple[int, int], ...]
    replica_id: int = 0


@dataclasses.dataclass
class CheckpointMeta:
    step: int
    created_at: float
    tensors: List[TensorMeta]
    extra: Dict[str, Any]  # small non-array state (rng, config)
    # World booking, stamped by the saver at persist time (0/() in shm and
    # legacy checkpoints — readers use ``getattr`` with defaults).
    world_size: int = 0
    world_hosts: Tuple[int, ...] = ()


# -- the JAX package's meta pickles ---------------------------------------------

_JAX_META_MODULE = "dlrover_tpu.checkpoint.shm_handler"
_META_CLASSES = {"CheckpointMeta": CheckpointMeta, "TensorMeta": TensorMeta,
                 "ShardRecord": ShardRecord}
_REFUSED_ROOTS = ("dlrover_tpu", "jax", "jaxlib", "flax", "optax", "orbax",
                  "ml_dtypes")


class _MetaUnpickler(pickle.Unpickler):
    """Reads a meta pickle of either package: the JAX package's three meta
    classes become this module's; any other name of the JAX stack is
    refused rather than imported."""

    def find_class(self, module: str, name: str):
        if module == _JAX_META_MODULE and name in _META_CLASSES:
            return _META_CLASSES[name]
        if module.split(".")[0] in _REFUSED_ROOTS:
            raise pickle.UnpicklingError(
                f"checkpoint meta names {module}.{name}, which the port "
                "does not import")
        return super().find_class(module, name)


def loads_meta(raw: bytes) -> CheckpointMeta:
    return _MetaUnpickler(io.BytesIO(raw)).load()


# -- trees ----------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree: Any, prefix: Path = ()
                           ) -> List[Tuple[Path, Any]]:
    """``[(path, leaf)]`` in JAX's order and ``keystr`` spelling; ``None``
    is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_flatten_with_path(tree[key], prefix + (f"[{key!r}]",))
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += tree_flatten_with_path(getattr(tree, name),
                                          prefix + (f".{name}",))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += tree_flatten_with_path(item, prefix + (f"[{i}]",))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for field in dataclasses.fields(tree):
            out += tree_flatten_with_path(getattr(tree, field.name),
                                          prefix + (f".{field.name}",))
        return out
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable[[Path, Any], Any], tree: Any,
                       prefix: Path = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, the
    structure (dict, list, tuple, named tuple, dataclass) kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((key, tree_map_with_path(
            fn, value, prefix + (f"[{key!r}]",))) for key, value in
            tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(
            fn, getattr(tree, name), prefix + (f".{name}",))
            for name in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, item, prefix + (f"[{i}]",))
                          for i, item in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            field.name: tree_map_with_path(fn, getattr(tree, field.name),
                                           prefix + (f".{field.name}",))
            for field in dataclasses.fields(tree) if field.init})
    return fn(prefix, tree)


# -- leaves ---------------------------------------------------------------------


def _container(dtype: str) -> np.dtype:
    """A numpy dtype of the same item size that holds a recorded dtype's
    bytes (bf16 in int16)."""
    return np.dtype(np.int16) if dtype == "<V2" else np.dtype(dtype)


def _leaf_info(leaf) -> Tuple[Tuple[int, ...], str, int]:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _DTYPE_STR:
            raise TypeError(f"no checkpoint dtype for {leaf.dtype}")
        return (tuple(leaf.shape), _DTYPE_STR[leaf.dtype],
                leaf.numel() * leaf.element_size())
    block = np.asarray(leaf)
    return tuple(block.shape), block.dtype.str, block.nbytes


def _select_shards(path: Path, leaf, layout: Optional[Dict[Path, LeafLayout]]
                   ) -> Tuple[Tuple[int, ...], str, List[Tuple[Tuple, Any]]]:
    """``(global_shape, dtype, [(index, block)])`` of one leaf: its piece
    when this rank holds that piece's replica 0, else nothing."""
    shape, dtype, _ = _leaf_info(leaf)
    spot = layout.get(path) if layout is not None else None
    if spot is None:
        return shape, dtype, [(tuple((0, d) for d in shape), leaf)]
    piece = tuple(e - b for b, e in spot.index)
    if piece != shape:
        raise ValueError(
            f"{''.join(path)}: a {shape} piece laid out as {spot.index} of "
            f"{spot.global_shape}")
    if spot.replica_id != 0:
        return tuple(spot.global_shape), dtype, []
    return tuple(spot.global_shape), dtype, [(tuple(spot.index), leaf)]


def pack_pytree(
    state: Any, step: int, extra: Optional[Dict[str, Any]] = None,
    layout: Optional[Dict[Path, LeafLayout]] = None,
) -> Tuple[CheckpointMeta, List[Any]]:
    """Flatten ``state`` into (meta, ordered blocks): one block per piece
    this rank writes (:func:`_select_shards`).  Pure: no copy, no shm
    I/O.  Every tensor's path and global shape is in the meta, written or
    not, so any rank's meta describes the whole tree."""
    tensors: List[TensorMeta] = []
    blocks: List[Any] = []
    offset = 0
    for path, leaf in tree_flatten_with_path(state):
        global_shape, dtype, pieces = _select_shards(path, leaf, layout)
        records = []
        for index, block in pieces:
            shape, _, nbytes = _leaf_info(block)
            records.append(ShardRecord(index=index, offset=offset,
                                       nbytes=nbytes, shape=shape))
            blocks.append(block)
            offset += nbytes
        tensors.append(TensorMeta(path=path, global_shape=global_shape,
                                  dtype=dtype, shards=records))
    meta = CheckpointMeta(step=step, created_at=time.time(),
                          tensors=tensors, extra=dict(extra or {}))
    return meta, blocks


def _copy_into(buf: memoryview, start: int, record: ShardRecord,
               leaf) -> None:
    """Copy one leaf into ``buf[start:start + nbytes]``: a tensor through a
    tensor view of the arena (device->host for a CUDA tensor), anything
    else through a numpy view.  The views are dropped before returning,
    so no buffer export outlives the copy."""
    if record.nbytes == 0:
        return
    if isinstance(leaf, torch.Tensor):
        numel = leaf.numel()
        dst = torch.frombuffer(buf, dtype=leaf.dtype, count=numel,
                               offset=start)
        dst.view(leaf.shape).copy_(leaf.detach())
        del dst
        return
    dst = np.frombuffer(buf, dtype=np.uint8, count=record.nbytes,
                        offset=start)
    dst[:] = np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(
        np.uint8)
    del dst


class SharedMemoryHandler:
    """Owns one shm arena (per training process) and packs trees into it."""

    def __init__(self, name: str):
        job = os.environ.get("DLROVER_TPU_JOB", "")
        tag = f"{job}_" if job else ""
        self.name = f"dlrover_tpu_ckpt_{tag}{name}".replace("/", "_")
        self._shm: Optional[SharedMemory] = None
        self._inode: Optional[int] = None  # of the mapped arena's file

    def _stat(self) -> os.stat_result:
        return os.stat(f"/dev/shm/{self.name}")

    # -- writer side (trainer) ------------------------------------------------

    def save_state_dict(
        self, state: Any, step: int, extra: Optional[Dict[str, Any]] = None,
        layout: Optional[Dict[Path, LeafLayout]] = None,
    ) -> CheckpointMeta:
        meta, leaves = pack_pytree(state, step, extra, layout)
        meta_bytes = pickle.dumps(meta)
        data_offset = _HEADER.size + len(meta_bytes)
        records = [r for t in meta.tensors for r in t.shards]
        total = data_offset + sum(r.nbytes for r in records)
        self._ensure_capacity(total)
        buf = self._shm.buf
        # Crash-consistency ordering: invalidate the header first, then write
        # data + meta, then publish the header *last*.  A trainer SIGKILLed
        # mid-copy leaves meta_len == 0, which readers treat as "no
        # checkpoint" instead of committing torn tensor bytes.
        buf[: _HEADER.size] = _HEADER.pack(0)
        for record, leaf in zip(records, leaves):
            _copy_into(buf, data_offset + record.offset, record, leaf)
        if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
               for leaf in leaves):
            torch.cuda.synchronize()
        buf[_HEADER.size : data_offset] = meta_bytes
        buf[: _HEADER.size] = _HEADER.pack(len(meta_bytes))
        return meta

    def _ensure_capacity(self, total: int):
        if self._shm is not None and self._shm.size < total:
            self._shm.close()
            self._shm.unlink()
            self._shm = None
        if self._shm is None:
            # Round up so small step-to-step growth doesn't recreate.
            size = max(total, 1 << 20)
            size = 1 << (size - 1).bit_length()
            existing = attach_or_none(self.name)
            if existing is not None:
                if existing.size >= total:
                    self._shm = existing
                    return
                existing.close()
                existing.unlink()
            self._shm = SharedMemory(self.name, create=True, size=size)
            self._inode = self._stat().st_ino

    @property
    def size(self) -> int:
        """The arena's bytes (0 before the first save or attach)."""
        return self._shm.size if self._shm is not None else 0

    # -- reader side (saver or restarted trainer) -----------------------------

    def attach(self) -> bool:
        # The writer recreates (unlink + create) the arena when state grows,
        # or when a restarted trainer unlinked it; a reader holding the old
        # mapping would silently read stale bytes forever.  Detect via the
        # backing file's size and inode (a recreated arena of the same size
        # is a new file) and re-attach.
        if self._shm is not None:
            try:
                live = self._stat()
            except FileNotFoundError:
                self._shm.close()
                self._shm = None
                return False
            if live.st_size != self._shm.size or live.st_ino != self._inode:
                logger.info(
                    "shm %s was recreated (%d -> %d bytes); re-attaching",
                    self.name, self._shm.size, live.st_size,
                )
                self._shm.close()
                self._shm = None
        if self._shm is None:
            self._shm = attach_or_none(self.name)
            if self._shm is not None:
                self._inode = self._stat().st_ino
        return self._shm is not None

    def load_meta(self) -> Optional[CheckpointMeta]:
        if not self.attach():
            return None
        buf = self._shm.buf
        (meta_len,) = _HEADER.unpack(bytes(buf[: _HEADER.size]))
        if meta_len == 0 or meta_len > self._shm.size:
            return None
        try:
            return loads_meta(bytes(buf[_HEADER.size : _HEADER.size
                                        + meta_len]))
        except Exception as e:
            logger.warning("shm %s meta unreadable: %s", self.name, e)
            return None

    def raw_data(self, meta: CheckpointMeta) -> memoryview:
        """The tensor byte region (the saver streams this to storage)."""
        (meta_len,) = _HEADER.unpack(bytes(self._shm.buf[: _HEADER.size]))
        data_offset = _HEADER.size + meta_len
        end = data_offset + sum(
            r.nbytes for t in meta.tensors for r in t.shards
        )
        return self._shm.buf[data_offset:end]

    def load_block(self, meta: CheckpointMeta,
                   record: ShardRecord) -> np.ndarray:
        (meta_len,) = _HEADER.unpack(bytes(self._shm.buf[: _HEADER.size]))
        data_offset = _HEADER.size + meta_len
        start = data_offset + record.offset
        return np.frombuffer(
            self._shm.buf, dtype=np.uint8, count=record.nbytes, offset=start
        )

    def no_checkpoint_state(self) -> bool:
        return self.load_meta() is None

    def close(self, unlink: bool = False):
        if self._shm is not None:
            self._shm.close()
            if unlink:
                self._shm.unlink()
            self._shm = None


def assemble_tensor(meta: TensorMeta, block_loader) -> torch.Tensor:
    """Reassemble a whole CPU tensor from shard records via
    ``block_loader(record)`` (flat uint8).  The bytes are copied out, so
    the tensor holds no view of the arena or the data blob."""
    container = _container(meta.dtype)
    out = np.empty(meta.global_shape, dtype=container)
    for record in meta.shards:
        block = block_loader(record).view(container).reshape(record.shape)
        key = tuple(slice(b, e) for b, e in record.index) or ...
        out[key] = block
        del block
    tensor = torch.from_numpy(out)
    if meta.dtype == "<V2":
        tensor = tensor.view(torch.bfloat16)
    return tensor

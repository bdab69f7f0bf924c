"""Sharded embedding plane: hash-bucketed tables partitioned across hosts.

Port of ``dlrover_tpu/embedding/sharded.py``:

- the int64 key space is hashed into a FIXED number of logical buckets
  (``num_buckets``, sized once and never changed afterwards);
- bucket ``b`` lives on physical host ``b % P``: ``runtime.virtual_mesh.
  shard_owner``, the fold rule of the virtual mesh;
- each host's KVStore (optionally hybrid RAM+disk) owns its buckets'
  rows AND their optimizer moments;
- a batch lookup / gradient push exchanges only the touched rows with
  each owner;
- a world resize is a bucket-map re-fold: only rows whose owner changes
  move, owner-to-owner, serialized in the spill-log record format
  (``spill.pack_records``);
- full/delta exports carry the checkpoint integrity chain: per host-shard
  ``.meta`` + ``.data`` + ``.digest`` sidecar (``storage.digest_stamp``),
  and restore re-partitions rows under the CURRENT fold, so any-n->m
  cross-world restore is the same code path as same-world restore.  The
  files are the JAX plane's format: either package restores the other's.

In-process the plane holds all P stores; a real deployment would back each
store with one host process and replace the in-memory exchange with its
transport (the record codec is already the wire format).

The JAX plane's fault seams and spans are the port's too: ``embed.fetch``
fires once per owner exchange of a lookup or an update, ``embed.reshard``
before any owner mutates (an injected error aborts cleanly with the old
fold intact), ``storage.write``/``storage.read`` around a shard export and
import; ``embed.lookup``, ``embed.apply`` and ``embed.reshard`` are spans,
and :meth:`ShardedEmbeddingTable.emit_telemetry` books an ``embed`` event.
With no fault plan every seam is a no-op.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common import faults, telemetry
from dlrover_tpu_torch.common.storage import digest_stamp, parse_digest
from dlrover_tpu_torch.embedding import spill as spill_mod
from dlrover_tpu_torch.embedding.store import KVStore
from dlrover_tpu_torch.runtime.virtual_mesh import shard_owner

logger = logging.getLogger(__name__)

#: group-sparse optimizers the plane dispatches to the owner stores
#: (``adahessian`` needs caller-side Hessian rows — host-local tables
#: support it; the plane keeps to the stateless-gradient family).
OPTIMIZERS = ("adam", "adagrad", "ftrl", "lamb", "radam")


def hash_bucket(keys, num_buckets: int) -> np.ndarray:
    """Deterministic key -> logical bucket (splitmix64 finalizer, the same
    avalanche the native store uses for slot choice).  Vectorized, stable
    across processes and worlds — NEVER Python ``hash()``, which is
    salted per process and would scatter a restored table."""
    x = np.ascontiguousarray(keys, np.int64).astype(np.uint64)
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(num_buckets)).astype(np.int64)


class ShardedEmbeddingTable:
    """A hash-bucketed embedding table folded onto ``world`` owner stores.

    Same trainer-facing contract as ``EmbeddingTable`` (``lookup`` ->
    ``(rows, unique, inverse)``; ``apply_gradients`` on the unique keys),
    plus ``reshard(new_world)`` for elastic resizes and per-host-shard
    digest-chained ``save``/``restore``.
    """

    def __init__(
        self,
        name: str,
        dim: int,
        num_buckets: int = 64,
        world: int = 1,
        init_scale: float = 0.01,
        seed: int = 0,
        optimizer: str = "adam",
        learning_rate: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        l1: float = 0.0,
        l2: float = 0.0,
        beta: float = 0.0,
        native: Optional[bool] = None,
        spill_dir: Optional[str] = None,
    ):
        if optimizer not in OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {OPTIMIZERS}, got {optimizer!r}"
            )
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if num_buckets < world:
            raise ValueError(
                f"num_buckets ({num_buckets}) must be >= world ({world}): "
                "the bucket space is the logical mesh and cannot fold onto "
                "more owners than it has shards"
            )
        self.name = name
        self.dim = int(dim)
        self.num_buckets = int(num_buckets)
        self.world = int(world)
        self.init_scale = init_scale
        self.seed = seed
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.l1, self.l2, self.beta = l1, l2, beta
        self._native = native
        self._spill_dir = spill_dir
        self.step = 0
        self._adam_t = 0
        self._last_export_step = 0
        self._stats: Dict[str, float] = {
            "lookups": 0, "rows_fetched": 0, "reshards": 0,
            "reshard_s": 0.0, "moved_rows": 0, "moved_bytes": 0,
        }
        self._hosts: List[Any] = [
            self._make_store(rank) for rank in range(self.world)
        ]

    def _make_store(self, rank: int):
        if self._spill_dir:
            return spill_mod.HybridKVStore(
                self.dim,
                spill_path=os.path.join(
                    self._spill_dir, f"{self.name}_host{rank}.spill"
                ),
                native=self._native,
            )
        return KVStore(self.dim, native=self._native)

    def __len__(self) -> int:
        return sum(len(h) for h in self._hosts)

    # -- geometry --------------------------------------------------------------

    def bucket_of(self, keys) -> np.ndarray:
        """Logical bucket per key (fixed for the table's lifetime)."""
        return hash_bucket(keys, self.num_buckets)

    def owner_of(self, keys) -> np.ndarray:
        """Physical owner per key under the CURRENT fold."""
        return self.bucket_of(keys) % self.world

    def owned_buckets(self, rank: int) -> Tuple[int, ...]:
        """Buckets folded onto host ``rank`` — the virtual-mesh rule."""
        return tuple(
            b for b in range(self.num_buckets)
            if shard_owner(b, self.world) == rank
        )

    def rows_owned(self, rank: Optional[int] = None) -> int:
        if rank is None:
            return len(self)
        return len(self._hosts[rank])

    # -- training step ---------------------------------------------------------

    def lookup(self, keys) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Gather unique rows for a batch of int64 keys from their owners.

        Returns ``(rows [U, dim] float32, unique_keys [U], inverse)`` —
        identical contract (and, per key, bitwise-identical rows) to the
        single-host ``EmbeddingTable.lookup``: the deterministic per-key
        init depends only on ``(key, seed)``, never on which owner holds
        the bucket.
        """
        with telemetry.span("embed.lookup") as sp:
            self.step += 1
            flat = np.ascontiguousarray(keys, np.int64).reshape(-1)
            unique, inverse = np.unique(flat, return_inverse=True)
            rows = np.empty((unique.size, self.dim), np.float32)
            owners = self.owner_of(unique)
            touched = 0
            for rank in range(self.world):
                sel = owners == rank
                count = int(np.count_nonzero(sel))
                if not count:
                    continue
                # One exchange per owner: the seam models the peer host
                # dropping/straggling this batch's row fetch.
                faults.fire("embed.fetch", rank=rank, rows=count)
                rows[sel] = self._hosts[rank].lookup(
                    unique[sel], init_scale=self.init_scale,
                    seed=self.seed, step=self.step,
                )
                touched += 1
            self._stats["lookups"] += 1
            self._stats["rows_fetched"] += int(unique.size)
            if sp is not None:
                sp.attrs["rows"] = int(unique.size)
                sp.attrs["owners"] = touched
            return rows, unique, inverse.astype(np.int32)

    def apply_gradients(self, unique_keys, grad_rows) -> None:
        """Group-sparse update pushed to each owner — moments live in the
        owner's store (per-bucket slot partitioning)."""
        with telemetry.span("embed.apply") as sp:
            self._adam_t += 1
            unique_keys = np.ascontiguousarray(unique_keys, np.int64)
            grads = np.asarray(grad_rows, np.float32)
            owners = self.owner_of(unique_keys)
            for rank in range(self.world):
                sel = owners == rank
                count = int(np.count_nonzero(sel))
                if not count:
                    continue
                faults.fire("embed.fetch", rank=rank, rows=count)
                self._apply_one(
                    self._hosts[rank], unique_keys[sel], grads[sel]
                )
            if sp is not None:
                sp.attrs["rows"] = int(unique_keys.size)

    def _apply_one(self, store, keys, grads):
        if self.optimizer == "adam":
            store.apply_group_adam(
                keys, grads, lr=self.learning_rate, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay,
                t=self._adam_t,
            )
        elif self.optimizer == "adagrad":
            store.apply_group_adagrad(
                keys, grads, lr=self.learning_rate, eps=self.eps,
            )
        elif self.optimizer == "ftrl":
            store.apply_group_ftrl(
                keys, grads, lr=self.learning_rate,
                l1=self.l1, l2=self.l2, beta=self.beta,
            )
        elif self.optimizer == "radam":
            store.apply_group_radam(
                keys, grads, lr=self.learning_rate, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay,
                t=self._adam_t,
            )
        else:  # lamb
            store.apply_group_lamb(
                keys, grads, lr=self.learning_rate, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay,
                t=self._adam_t,
            )

    def peek(self, keys) -> np.ndarray:
        """Read-only gather across owners (eval / cache-writeback path)."""
        flat = np.ascontiguousarray(keys, np.int64).reshape(-1)
        out = np.zeros((flat.size, self.dim), np.float32)
        owners = self.owner_of(flat)
        for rank in range(self.world):
            sel = owners == rank
            if not sel.any():
                continue
            out[sel] = self._hosts[rank].peek(flat[sel])
        return out

    # -- elastic resharding ----------------------------------------------------

    def reshard(self, new_world: int) -> Dict[str, int]:
        """Re-fold the bucket map onto ``new_world`` owners, moving ONLY
        the rows whose bucket changed owner (spill-log record transport).

        The seam fires before any owner mutates, so an injected error
        aborts cleanly and a retrying caller re-enters with the old fold
        intact.  Returns a summary for the resize ledger.
        """
        new_world = int(new_world)
        if new_world < 1:
            raise ValueError(f"new_world must be >= 1, got {new_world}")
        if new_world > self.num_buckets:
            raise ValueError(
                f"cannot fold {self.num_buckets} buckets onto {new_world} "
                "owners: grow num_buckets at table construction"
            )
        t0 = time.monotonic()
        with telemetry.span(
            "embed.reshard", src=self.world, dst=new_world
        ) as sp:
            faults.fire("embed.reshard", src=self.world, dst=new_world)
            old_world = self.world
            moved_rows = 0
            moved_bytes = 0
            if new_world != old_world:
                while len(self._hosts) < new_world:
                    self._hosts.append(self._make_store(len(self._hosts)))
                for src in range(old_world):
                    moved_rows, moved_bytes = self._migrate_from(
                        src, new_world, moved_rows, moved_bytes,
                    )
                for rank in range(new_world, len(self._hosts)):
                    leftover = len(self._hosts[rank])
                    if leftover:  # pragma: no cover - invariant guard
                        raise RuntimeError(
                            f"reshard left {leftover} rows on retired "
                            f"host {rank}"
                        )
                    self._hosts[rank].close()
                del self._hosts[new_world:]
                self.world = new_world
            dt = time.monotonic() - t0
            self._stats["reshards"] += 1
            self._stats["reshard_s"] += dt
            self._stats["moved_rows"] += moved_rows
            self._stats["moved_bytes"] += moved_bytes
            if sp is not None:
                sp.attrs["moved_rows"] = moved_rows
                sp.attrs["moved_bytes"] = moved_bytes
            logger.info(
                "embedding plane %s: resharded %d -> %d owners, moved %d "
                "rows (%d bytes) in %.3fs",
                self.name, old_world, new_world, moved_rows, moved_bytes,
                dt,
            )
            return {
                "src": old_world, "dst": new_world,
                "moved_rows": moved_rows, "moved_bytes": moved_bytes,
            }

    def _migrate_from(self, src: int, new_world: int,
                      moved_rows: int, moved_bytes: int):
        """Move ``src``'s rows whose bucket re-folded elsewhere.  Rows are
        packed in the spill-log record format, inserted at the new owner
        (moments and freshness metadata intact), then removed at the
        source — insert-before-remove, so an interruption duplicates
        instead of losing (the bucket map decides which copy serves).

        A row moves iff its NEW owner differs from the host that holds it
        NOW.  Comparing old fold vs new fold instead would, on folds where
        neither world divides the other (3→2, 2→3, 4→6), re-select a row
        already migrated INTO a later-processed source with destination ==
        itself — insert into the same store, then remove: the row is lost.
        """
        store = self._hosts[src]
        all_keys, rows, m, v, counts, steps = store.export()
        if all_keys.size == 0:
            return moved_rows, moved_bytes
        dsts = self.bucket_of(all_keys) % new_world
        sel_move = dsts != src
        if not sel_move.any():
            return moved_rows, moved_bytes
        for dst in np.unique(dsts[sel_move]):
            sel = dsts == dst
            payload = spill_mod.pack_records(
                all_keys[sel], rows[sel], m[sel], v[sel],
                counts[sel], steps[sel],
            )
            k2, r2, m2, v2, c2, s2 = spill_mod.unpack_records(
                payload, self.dim
            )
            self._hosts[int(dst)].insert(k2, r2, m2, v2, c2, s2)
            store.remove(k2)
            moved_rows += int(k2.size)
            moved_bytes += len(payload)
        return moved_rows, moved_bytes

    # -- checkpoint (digest-chained per-host shards) ---------------------------

    def _export_dir(self, directory: str, kind: str, step: int) -> str:
        return os.path.join(directory, f"{self.name}_{kind}_{step}")

    def _shard_meta(self, rank: int, kind: str, step: int) -> Dict[str, Any]:
        return {
            "name": self.name, "dim": self.dim,
            "num_buckets": self.num_buckets, "world": self.world,
            "rank": rank, "kind": kind, "export_step": step,
            "plane_step": self.step, "adam_t": self._adam_t,
        }

    def save(self, directory: str, step: int, delta: bool = False) -> str:
        """Write one export dir of per-host shards, each with the
        checkpoint integrity chain's ``.meta``/``.data``/``.digest``
        triple (``storage.digest_stamp``).  ``delta`` exports only rows
        touched since the previous export — the preemption-drain leg."""
        kind = "delta" if delta else "full"
        out_dir = self._export_dir(directory, kind, step)
        min_step = self._last_export_step if delta else 0
        os.makedirs(out_dir, exist_ok=True)
        for rank, store in enumerate(self._hosts):
            keys, rows, m, v, counts, steps = store.export(min_step)
            buf = io.BytesIO()
            np.savez(
                buf, keys=keys, rows=rows, m=m, v=v, counts=counts,
                steps=steps,
            )
            data = buf.getvalue()
            meta = pickle.dumps(self._shard_meta(rank, kind, step))
            base = os.path.join(
                out_dir, f"host_{rank}_of_{self.world}"
            )
            # Same seam the checkpoint savers declare: shard export is
            # remote-storage-shaped I/O and must be drillable.
            faults.fire("storage.write", path=base, op="embed.save")
            with open(base + ".meta.tmp", "wb") as f:
                f.write(meta)
            with open(base + ".data.tmp", "wb") as f:
                f.write(data)
            with open(base + ".digest.tmp", "w", encoding="utf-8") as f:
                f.write(digest_stamp(
                    zlib.crc32(meta), zlib.crc32(data), len(data)
                ))
            for ext in (".meta", ".data", ".digest"):
                os.replace(base + ext + ".tmp", base + ext)
        # Commit the delta watermark only once EVERY shard is in place: a
        # failed partial export must leave the next delta covering the
        # same rows, or the preemption drain silently drops them.
        self._last_export_step = self.step + 1
        logger.info(
            "embedding plane %s: saved %s export (%d hosts, %d rows) to %s",
            self.name, kind, self.world, len(self), out_dir,
        )
        return out_dir

    def _read_shard(self, base: str):
        """One digest-verified host shard -> (meta dict, npz arrays).
        Raises ``ValueError`` on a digest mismatch (corrupt/torn shard)."""
        faults.fire("storage.read", path=base, op="embed.restore")
        with open(base + ".meta", "rb") as f:
            meta_bytes = f.read()
        with open(base + ".data", "rb") as f:
            data = f.read()
        digest = None
        if os.path.exists(base + ".digest"):
            with open(base + ".digest", encoding="utf-8") as f:
                digest = f.read()
        parsed = parse_digest(digest)
        if parsed is not None:
            meta_crc, data_crc, data_nbytes = parsed
            if len(data) != data_nbytes or zlib.crc32(data) != data_crc \
                    or zlib.crc32(meta_bytes) != meta_crc:
                raise ValueError(
                    f"embedding shard {base}: digest mismatch "
                    "(corrupt or torn export)"
                )
        return pickle.loads(meta_bytes), np.load(io.BytesIO(data))

    def _list_exports(self, directory: str) -> List[Tuple[int, str, str]]:
        out = []
        prefix = self.name + "_"
        if not os.path.isdir(directory):
            return out
        for entry in sorted(os.listdir(directory)):
            if not entry.startswith(prefix):
                continue
            stem = entry[len(prefix):]
            try:
                kind, step_s = stem.rsplit("_", 1)
                step = int(step_s)
            except ValueError:
                continue
            if kind in ("full", "delta") and os.path.isdir(
                os.path.join(directory, entry)
            ):
                out.append((step, kind, os.path.join(directory, entry)))
        return out

    def _load_export(self, export_dir: str) -> int:
        """Insert one export's rows, re-partitioned under the CURRENT
        fold — cross-world restore is the same path as same-world.

        Two-pass, so the export is all-or-nothing: pass 1 digest-verifies
        EVERY shard (and that the rank set is complete) before pass 2
        inserts a single row.  A corrupt/torn shard therefore raises with
        the plane untouched, and ``restore``'s fall-back never mixes rows
        from two checkpoints."""
        shards = sorted(
            fname[: -len(".meta")]
            for fname in os.listdir(export_dir)
            if fname.endswith(".meta")
        )
        verified = []
        for shard in shards:
            meta, arrays = self._read_shard(os.path.join(export_dir, shard))
            if meta["dim"] != self.dim:
                raise ValueError(
                    f"table dim mismatch: {meta['dim']} != {self.dim}"
                )
            if meta["num_buckets"] != self.num_buckets:
                raise ValueError(
                    "bucket-space mismatch: export has "
                    f"{meta['num_buckets']} buckets, table has "
                    f"{self.num_buckets} — the logical bucket space is "
                    "fixed for the table's lifetime"
                )
            verified.append((meta, arrays))
        ranks = sorted(meta["rank"] for meta, _ in verified)
        want = list(range(verified[0][0]["world"])) if verified else []
        if not verified or ranks != want:
            raise ValueError(
                f"embedding export {export_dir}: torn export — have "
                f"shards for ranks {ranks}, expected {want or 'some'}"
            )
        loaded = 0
        for meta, arrays in verified:
            keys = arrays["keys"]
            if keys.size == 0:
                continue
            owners = self.owner_of(keys)
            for rank in range(self.world):
                sel = owners == rank
                if not sel.any():
                    continue
                self._hosts[rank].insert(
                    keys[sel], arrays["rows"][sel], arrays["m"][sel],
                    arrays["v"][sel], arrays["counts"][sel],
                    arrays["steps"][sel],
                )
                loaded += int(np.count_nonzero(sel))
            self.step = max(self.step, int(meta["plane_step"]))
            self._adam_t = max(self._adam_t, int(meta["adam_t"]))
        return loaded

    def restore(self, directory: str) -> int:
        """Replay the newest intact full export + newer deltas; a corrupt
        full export (digest mismatch) is skipped for the next older one —
        the checkpoint engine's reject-and-fall-back discipline."""
        exports = self._list_exports(directory)
        fulls = sorted(e for e in exports if e[1] == "full")
        while fulls:
            base_step, _, base_dir = fulls[-1]
            try:
                self._load_export(base_dir)
                break
            except (ValueError, OSError) as e:
                logger.warning(
                    "embedding plane %s: rejecting export %s (%s); "
                    "falling back to the previous full export",
                    self.name, base_dir, e,
                )
                fulls.pop()
        else:
            return 0
        for step, kind, path in sorted(exports):
            if kind == "delta" and step > base_step:
                try:
                    self._load_export(path)
                except (ValueError, OSError) as e:
                    # Same reject-and-continue discipline as the full leg:
                    # a corrupt/torn delta loses its window's updates but
                    # never aborts the restore or half-applies its rows.
                    logger.warning(
                        "embedding plane %s: rejecting delta export %s "
                        "(%s); continuing with the remaining exports",
                        self.name, path, e,
                    )
        self._last_export_step = self.step + 1
        logger.info(
            "embedding plane %s: restored %d rows across %d hosts",
            self.name, len(self), self.world,
        )
        return self.step

    def drain(self, directory: str, step: int) -> str:
        """Preemption drain: flush the delta leg (rows touched since the
        last export) before the host goes away."""
        return self.save(directory, step, delta=True)

    # -- checkpoint-extra booking ---------------------------------------------

    def booking(self) -> Dict[str, Any]:
        """The bucket→owner assignment (and optimizer clock) booked
        through the checkpoint ``extra`` channel — what a restoring
        trainer needs to re-fold the plane before any rows load."""
        return {
            "name": self.name,
            "num_buckets": self.num_buckets,
            "world": self.world,
            "plane_step": self.step,
            "adam_t": self._adam_t,
        }

    def adopt_booking(self, booking: Optional[Dict[str, Any]]) -> None:
        """Adopt a restored booking.  The bucket space must match (it is
        the plane's logical mesh); a differing booked world re-folds the
        live plane to it — the restore-side half of elastic resharding."""
        if not booking:
            return
        if int(booking.get("num_buckets", self.num_buckets)) != \
                self.num_buckets:
            raise ValueError(
                f"booked bucket space {booking['num_buckets']} != "
                f"{self.num_buckets}: the logical bucket space is fixed"
            )
        self.step = max(self.step, int(booking.get("plane_step", 0)))
        self._adam_t = max(self._adam_t, int(booking.get("adam_t", 0)))
        booked_world = int(booking.get("world", self.world))
        if booked_world != self.world:
            self.reshard(booked_world)

    # -- stats / telemetry -----------------------------------------------------

    def stats(self) -> Dict[str, float]:
        per_host = [len(h) for h in self._hosts]
        spill_bytes = 0
        for host in self._hosts:
            disk = getattr(host, "disk", None)
            if disk is not None:
                spill_bytes += len(disk) * (3 * self.dim * 4
                                            + spill_mod._HEADER.size)
        return {
            "world": self.world,
            "rows_owned": int(sum(per_host)),
            "rows_owned_max": int(max(per_host) if per_host else 0),
            "lookups": int(self._stats["lookups"]),
            "rows_fetched": int(self._stats["rows_fetched"]),
            "reshards": int(self._stats["reshards"]),
            "reshard_s": float(self._stats["reshard_s"]),
            "moved_rows": int(self._stats["moved_rows"]),
            "spill_bytes": int(spill_bytes),
        }

    def emit_telemetry(self, **extra) -> None:
        """Book one ``embed`` telemetry event (the master's speed monitor
        aggregates these into the ``dlrover_embed_*`` gauges).  ``extra``
        merges cache-side stats (hit rate) the plane cannot see."""
        snapshot = self.stats()
        snapshot.update(extra)
        telemetry.event("embed", **snapshot)

    def close(self):
        for host in self._hosts:
            host.close()
        self._hosts = []

"""EmbeddingTable: the trainer-facing sparse embedding feature column.

Port of ``dlrover_tpu/embedding/table.py``, the host-local table: the
KVStore holds the full table; each step gathers only the rows the batch
touches into a dense [U, dim] array (U = unique keys), the model treats
that as an ordinary parameter-like input, and the returned gradient rows
are applied host-side by the group-sparse optimizer.  ``lookup``
deduplicates keys so a batch touching the same feature twice trains it
once per step with the summed gradient.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from dlrover_tpu_torch.embedding.store import KVStore

logger = logging.getLogger(__name__)


class EmbeddingTable:
    #: group-sparse optimizers the store applies in-table
    OPTIMIZERS = ("adam", "adagrad", "ftrl", "lamb", "radam", "adahessian")

    def __init__(
        self,
        name: str,
        dim: int,
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
        spill_path: Optional[str] = None,
    ):
        if optimizer not in self.OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {self.OPTIMIZERS}, got "
                f"{optimizer!r}"
            )
        self.name = name
        self.dim = dim
        self.init_scale = init_scale
        self.seed = seed
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.l1, self.l2, self.beta = l1, l2, beta
        if spill_path:
            # Hybrid mem/disk tier (ref tfplus hybrid_embedding): cold
            # features demote to disk and fault back on access.
            from dlrover_tpu_torch.embedding.spill import HybridKVStore

            self.store = HybridKVStore(
                dim, spill_path=spill_path, native=native
            )
        else:
            self.store = KVStore(dim, native=native)
        self.step = 0
        self._adam_t = 0
        self._last_export_step = 0

    def __len__(self) -> int:
        return len(self.store)

    # -- training step --------------------------------------------------------

    def lookup(self, keys: np.ndarray) -> Tuple["np.ndarray", np.ndarray, np.ndarray]:
        """Gather unique rows for a batch of (arbitrary-shape) int64 keys.

        Returns ``(rows [U, dim] float32, unique_keys [U], inverse)`` where
        ``inverse`` maps each flat input position to its row — feed
        ``rows[inverse].reshape(*keys.shape, dim)`` into the model, or pass
        ``inverse`` into the jitted step and gather on device.
        """
        self.step += 1
        flat = np.ascontiguousarray(keys, np.int64).reshape(-1)
        unique, inverse = np.unique(flat, return_inverse=True)
        rows = self.store.lookup(
            unique, init_scale=self.init_scale, seed=self.seed,
            step=self.step,
        )
        return rows, unique, inverse.astype(np.int32)

    def apply_gradients(
        self, unique_keys: np.ndarray, grad_rows, hessian_rows=None
    ) -> None:
        """Group-sparse update on the rows ``lookup`` returned this step,
        with the optimizer chosen at construction.  ``hessian_rows``
        (same shape as the grads) is required by ``adahessian`` — the
        caller's Hutchinson diagonal estimate."""
        self._adam_t += 1
        grads = np.asarray(grad_rows, np.float32)
        if self.optimizer == "adahessian":
            if hessian_rows is None:
                raise ValueError(
                    "optimizer='adahessian' needs hessian_rows (the "
                    "Hutchinson Hessian-diagonal estimate per row)"
                )
            self.store.apply_group_adahessian(
                unique_keys, grads, np.asarray(hessian_rows, np.float32),
                lr=self.learning_rate, b1=self.b1, b2=self.b2, eps=self.eps,
                weight_decay=self.weight_decay, t=self._adam_t,
            )
        elif self.optimizer == "radam":
            self.store.apply_group_radam(
                unique_keys, grads,
                lr=self.learning_rate, b1=self.b1, b2=self.b2, eps=self.eps,
                weight_decay=self.weight_decay, t=self._adam_t,
            )
        elif self.optimizer == "adam":
            self.store.apply_group_adam(
                unique_keys, grads,
                lr=self.learning_rate, b1=self.b1, b2=self.b2, eps=self.eps,
                weight_decay=self.weight_decay, t=self._adam_t,
            )
        elif self.optimizer == "adagrad":
            self.store.apply_group_adagrad(
                unique_keys, grads, lr=self.learning_rate, eps=self.eps,
            )
        elif self.optimizer == "ftrl":
            self.store.apply_group_ftrl(
                unique_keys, grads, lr=self.learning_rate,
                l1=self.l1, l2=self.l2, beta=self.beta,
            )
        else:  # lamb
            self.store.apply_group_lamb(
                unique_keys, grads,
                lr=self.learning_rate, b1=self.b1, b2=self.b2, eps=self.eps,
                weight_decay=self.weight_decay, t=self._adam_t,
            )

    def evict(self, max_age_steps: int, min_count: int = 1) -> int:
        """Drop features colder than ``min_count`` hits and older than
        ``max_age_steps`` (feature freshness, ref kv_variable delete ops)."""
        cutoff = max(0, self.step - max_age_steps)
        return self.store.evict(cutoff, min_count)

    def spill(self, max_age_steps: int, min_count: int = 1) -> int:
        """Demote cold features to the disk tier (hybrid stores only);
        they fault back into RAM on their next lookup."""
        if not hasattr(self.store, "spill"):
            raise ValueError(
                "spill requires a hybrid store: pass spill_path= to "
                "EmbeddingTable"
            )
        cutoff = max(0, self.step - max_age_steps)
        return self.store.spill(cutoff, min_count)

    # -- checkpoint (full + delta) --------------------------------------------

    def state_blob(self, delta: bool = False) -> bytes:
        """Serialize the table (or the delta since the last export)."""
        min_step = self._last_export_step if delta else 0
        keys, rows, m, v, counts, steps = self.store.export(min_step)
        self._last_export_step = self.step + 1
        buf = io.BytesIO()
        np.savez(
            buf, keys=keys, rows=rows, m=m, v=v, counts=counts, steps=steps,
        )
        return pickle.dumps(
            {
                "name": self.name,
                "dim": self.dim,
                "step": self.step,
                "adam_t": self._adam_t,
                "delta": delta,
                "arrays": buf.getvalue(),
            }
        )

    def load_blob(self, blob: bytes) -> int:
        """Merge a blob (full or delta) into the table; returns row count."""
        payload = pickle.loads(blob)
        if payload["dim"] != self.dim:
            raise ValueError(
                f"table dim mismatch: {payload['dim']} != {self.dim}"
            )
        arrays = np.load(io.BytesIO(payload["arrays"]))
        self.store.insert(
            arrays["keys"], arrays["rows"], arrays["m"], arrays["v"],
            arrays["counts"], arrays["steps"],
        )
        self.step = max(self.step, int(payload["step"]))
        self._adam_t = max(self._adam_t, int(payload["adam_t"]))
        self._last_export_step = self.step + 1
        return int(arrays["keys"].size)

    def save(self, directory: str, step: int, delta: bool = False) -> str:
        """Write ``{dir}/{name}_{step}.kv`` (atomic rename)."""
        os.makedirs(directory, exist_ok=True)
        kind = "delta" if delta else "full"
        path = os.path.join(directory, f"{self.name}_{kind}_{step}.kv")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self.state_blob(delta=delta))
        os.replace(tmp, path)
        logger.info(
            "embedding %s: saved %s ckpt (%d rows) to %s",
            self.name, kind, len(self.store), path,
        )
        return path

    def restore(self, directory: str) -> int:
        """Replay newest full export + any newer deltas; returns the step."""
        if not os.path.isdir(directory):
            return 0
        entries = []
        for fname in os.listdir(directory):
            if not fname.endswith(".kv"):
                continue
            stem = fname[: -len(".kv")]
            try:
                name, kind, step_s = stem.rsplit("_", 2)
                step = int(step_s)
            except ValueError:
                continue
            if name == self.name and kind in ("full", "delta"):
                entries.append((step, kind, fname))
        fulls = sorted(e for e in entries if e[1] == "full")
        if not fulls:
            return 0
        base_step = fulls[-1][0]
        replay = [fulls[-1]] + sorted(
            e for e in entries if e[1] == "delta" and e[0] > base_step
        )
        for step, kind, fname in replay:
            with open(os.path.join(directory, fname), "rb") as f:
                self.load_blob(f.read())
        logger.info(
            "embedding %s: restored %d rows (base %d + %d deltas)",
            self.name, len(self.store), base_step, len(replay) - 1,
        )
        return self.step

"""DeepRec-style CTR training on the distributed embedding plane, on the
card (port of ``examples/train_rec.py``).

Drives the recommender stack of ``dlrover_tpu_torch.embedding``:

- ``ShardedEmbeddingTable``: the sparse id space hash-bucketed and
  partitioned across ``--world`` owner hosts (simulated in-process);
- ``DeviceHotRowCache``: the hot working set resident on the card,
  gathered (K10a) and scattered (K10b) by the CUDA kernels of
  ``ops/csrc/embedding_rows.cu``; steady-state steps touch the owner hosts
  only for cache misses;
- ``EmbeddingPrefetcher``: the next batches' unique ids warmed ahead of
  the current step;
- elastic resharding: ``--reshard-at step:world,...`` re-folds the bucket
  map mid-run (rows move owner-to-owner, training continues);
- full+delta export under the checkpoint integrity chain.

    python -m dlrover_tpu_torch.examples.train_rec --steps 200 --world 4 \\
        --reshard-at 100:2

Synthetic CTR traffic: K categorical fields per example, zipf-skewed ids
(hot features recur, which is what the device cache is for), label
correlated with feature identity so the loss visibly falls.  The dense
model is the JAX example's: one ReLU hidden layer, a scalar head plus the
mean of the gathered rows, mean sigmoid cross-entropy, Adam.  The gradient
is taken with respect to the gathered rows tensor, and its first
``len(unique)`` rows go back to the host for the plane's sparse update.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch.embedding import (
    DeviceHotRowCache,
    EmbeddingPrefetcher,
    ShardedEmbeddingTable,
)
from dlrover_tpu_torch.optimizers import optax_ports as ox
from dlrover_tpu_torch.runtime.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DENSE_KEYS = ("w1", "b1", "w2", "b2")


def parse_reshard_plan(text: str):
    """``"100:2,200:4"`` -> [(100, 2), (200, 4)] sorted by step."""
    plan = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        step_s, _, world_s = part.partition(":")
        plan.append((int(step_s), int(world_s)))
    return sorted(plan)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--fields", type=int, default=8,
                   help="categorical features per example")
    p.add_argument("--id-space", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--world", type=int, default=2,
                   help="owner hosts the id space is partitioned across")
    p.add_argument("--num-buckets", type=int, default=64,
                   help="logical hash buckets (the fixed bucket space "
                        "worlds fold onto; must be >= any world)")
    p.add_argument("--cache-rows", type=int, default=8192,
                   help="device hot-row cache capacity (rows)")
    p.add_argument("--max-unique", type=int, default=4096,
                   help="padded unique-id width per step (worst batch)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches of ids warmed ahead of the consumer")
    p.add_argument("--sparse-optimizer", default="adam",
                   choices=("adam", "adagrad", "ftrl", "lamb", "radam"))
    p.add_argument("--reshard-at", default="",
                   help="mid-run elastic re-folds, 'step:world,...' "
                        "(e.g. '100:2,150:4')")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def batches(args, rng: np.random.Generator, n: int):
    """The example's traffic: zipf(1.3) ids over ``--id-space``."""
    for _ in range(n):
        raw = rng.zipf(1.3, size=(args.batch_size, args.fields))
        ids = (raw % args.id_space).astype(np.int64)
        label = ((ids.sum(axis=1) % 97) < 33).astype(np.float32)
        yield {"ids": ids, "label": label}


def init_dense(args) -> Dict[str, torch.Tensor]:
    """Random dense parameters at the JAX example's scales (from a torch
    generator seeded 0: the values are not JAX's)."""
    gen = torch.Generator().manual_seed(0)
    width = args.dim * args.fields
    return {
        "w1": torch.randn((width, args.hidden), generator=gen)
        / float(np.sqrt(width)),
        "b1": torch.zeros((args.hidden,)),
        "w2": torch.randn((args.hidden, 1), generator=gen) * 0.1,
        "b2": torch.zeros((1,)),
    }


def sigmoid_binary_cross_entropy(logit: torch.Tensor,
                                 label: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, element-wise."""
    return (-label * F.logsigmoid(logit)
            - (1.0 - label) * F.logsigmoid(-logit))


def dense_loss(dense: Dict[str, torch.Tensor], rows: torch.Tensor,
               inverse: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    # ``rows[inverse]``; as ``index_select`` its backward is an
    # ``index_add_`` (atomics), where advanced indexing's is a sort-based
    # ``index_put_`` that took 38.6 ms of a 47.8 ms device step on the card.
    gathered = rows.index_select(0, inverse).reshape(label.shape[0], -1)
    h = torch.relu(gathered @ dense["w1"] + dense["b1"])
    logit = (h @ dense["w2"] + dense["b2"])[:, 0]
    logit = logit + gathered.mean(dim=1)
    return sigmoid_binary_cross_entropy(logit, label).mean()


def step_grads(dense, rows, inverse, label):
    """Loss and gradients with respect to the dense params and the gathered
    rows tensor (``jax.value_and_grad(..., argnums=(0, 1))``)."""
    leaves = {k: dense[k].detach().requires_grad_(True) for k in DENSE_KEYS}
    rows = rows.detach().requires_grad_(True)
    loss = dense_loss(leaves, rows, inverse, label)
    grads = torch.autograd.grad(
        loss, [leaves[k] for k in DENSE_KEYS] + [rows])
    return (loss.detach(), dict(zip(DENSE_KEYS, grads[:-1])), grads[-1])


def run(args, dense: Optional[Dict[str, torch.Tensor]] = None,
        device: DeviceLike = None,
        on_step: Optional[Callable[[int, DeviceHotRowCache, np.ndarray],
                                   None]] = None) -> Dict:
    """Train ``args.steps`` steps; returns per-step losses and seconds, the
    cache's and the plane's stats and the reshards done.

    ``dense`` (``w1``, ``b1``, ``w2``, ``b2``; e.g. from
    ``models.from_jax.rec_dense_from_jax``) replaces the random init.
    ``device`` defaults to ``cuda``.  ``on_step(step, cache, unique)`` is
    called after each step's update (and reshard); its time is not counted
    in the step's seconds.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    reshard_plan = dict(parse_reshard_plan(args.reshard_at))
    plane = ShardedEmbeddingTable(
        "rec", dim=args.dim, num_buckets=args.num_buckets,
        world=args.world, learning_rate=args.lr, seed=1,
        optimizer=args.sparse_optimizer,
    )
    if args.checkpoint_dir:
        restored = plane.restore(args.checkpoint_dir)
        if restored:
            logger.info("embedding plane resumed at step %d", restored)
    cache = DeviceHotRowCache(
        plane, capacity=args.cache_rows, max_unique=args.max_unique,
        device=dev,
    )
    if dense is None:
        dense = init_dense(args)
    params = {k: dense[k].detach().to(dev, torch.float32).clone()
              for k in DENSE_KEYS}
    tx = ox.chain(ox.scale_by_adam(), ox.scale(-args.lr))
    opt_state = tx.init(params)
    saved_full = False
    losses, step_s, reshards = [], [], []
    step = 0
    source = EmbeddingPrefetcher(
        batches(args, rng, args.steps), cache, key_field="ids",
        depth=args.prefetch_depth,
    )
    t0 = t_prev = time.perf_counter()
    hook_s = 0.0
    for batch in source:
        step += 1
        rows, uniq, inverse = cache.lookup(batch["ids"])
        loss, dg, drows = step_grads(
            params, rows, torch.from_numpy(inverse.astype(np.int64)).to(dev),
            torch.from_numpy(batch["label"]).to(dev),
        )
        with torch.no_grad():
            updates, opt_state = tx.update(dg, opt_state, params)
            params = ox.apply_updates(params, updates)
        # Gradients land on the padded unique width; push only the real
        # rows, and the cache writes the post-update values back.
        cache.apply_gradients(uniq, drows[: len(uniq)].cpu().numpy())
        losses.append(float(loss))
        if step in reshard_plan:
            rows_before = len(plane)
            summary = plane.reshard(reshard_plan[step])
            source.drain()  # re-warm buffered batches against the new fold
            reshards.append(dict(summary, step=step, rows_before=rows_before,
                                 rows_after=len(plane)))
            logger.info(
                "resharded %d -> %d owners at step %d (%d rows moved)",
                summary["src"], summary["dst"], step, summary["moved_rows"],
            )
        if step % 50 == 0 or step == args.steps:
            logger.info("step %d loss %.4f rows %d hit_rate %.3f", step,
                        losses[-1], len(plane), cache.hit_rate)
        if args.checkpoint_dir and (
            step % args.ckpt_every == 0 or step == args.steps
        ):
            plane.save(args.checkpoint_dir, step=step, delta=saved_full)
            saved_full = True
        now = time.perf_counter()
        step_s.append(now - t_prev)
        if on_step is not None:
            on_step(step, cache, uniq)
            t_hook = time.perf_counter()
            hook_s += t_hook - now
            now = t_hook
        t_prev = now
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0 - hook_s
    result = {
        "steps": step,
        "losses": losses,
        "step_s": step_s,
        "elapsed_s": elapsed,
        "examples_per_s": step * args.batch_size / elapsed if elapsed > 0
        else 0.0,
        "rows_per_s": step * args.batch_size * args.fields / elapsed
        if elapsed > 0 else 0.0,
        "cache": cache.stats(),
        "plane": plane.stats(),
        "rows": len(plane),
        "reshards": reshards,
    }
    logger.info(
        "done: %d steps, %.1f examples/s, %d rows on %d owners, cache hit "
        "rate %.3f", step, result["examples_per_s"], len(plane),
        plane.world, cache.hit_rate,
    )
    plane.close()
    return result


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    run(args, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

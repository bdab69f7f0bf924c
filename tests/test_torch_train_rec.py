"""Port parity: ``dlrover_tpu_torch.embedding.device_cache`` (the hot-row
cache and its prefetcher) and ``dlrover_tpu_torch.examples.train_rec``
against ``dlrover_tpu.embedding`` and ``examples/train_rec.py``, on the
CPU, where the cache's gather and scatter take their plain versions.

Tolerances.  The cache moves rows and does no arithmetic, and both
packages' planes run the same C++ store: slots, counters and rows are
compared bitwise.  The 6-step loop runs the same fp32 model and Adam in
two frameworks: matrix products and the scatter-add behind ``rows[inverse]``
sum in other orders, a few ulps on values of order 0.01 to 1, which Adam's
normalised steps (lr 0.01) do not amplify past 1e-6 in six steps; losses
and every touched plane row are held to 1e-5 (measured here: 6.0e-8 on
the losses, 8.1e-8 on the rows).

Each test seeds its own generator.
"""

import argparse
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dlrover_tpu.embedding import DeviceHotRowCache as JaxCache
from dlrover_tpu.embedding import EmbeddingPrefetcher as JaxPrefetcher
from dlrover_tpu.embedding import ShardedEmbeddingTable as JaxPlane
from dlrover_tpu_torch.embedding import (
    DeviceHotRowCache,
    EmbeddingPrefetcher,
    ShardedEmbeddingTable,
)
from dlrover_tpu_torch.embedding import kernels
from dlrover_tpu_torch.examples import train_rec
from dlrover_tpu_torch.models.from_jax import rec_dense_from_jax

DIM = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP_ATOL = 1e-5


def make_plane(world, **kw):
    kw.setdefault("num_buckets", 16)
    kw.setdefault("learning_rate", 0.05)
    kw.setdefault("seed", 3)
    return ShardedEmbeddingTable("plane", dim=DIM, world=world, **kw)


def make_cache(plane, capacity=64, max_unique=32):
    return DeviceHotRowCache(plane, capacity=capacity, max_unique=max_unique,
                             device="cpu")


# -- the cache (counterparts of tests/test_embedding_plane.py) -----------------


def test_cache_lookup_matches_plane_bitwise():
    plane = make_plane(2)
    cache = make_cache(plane)
    keys = np.array([[3, 7, 11], [7, 3, 19]], np.int64)
    rows, uniq, inverse = cache.lookup(keys)
    assert rows.shape == (32, DIM) and rows.dtype == torch.float32
    np.testing.assert_array_equal(rows[: len(uniq)].numpy(),
                                  plane.peek(uniq))
    flat_rows = rows.numpy()[inverse].reshape(2, 3, DIM)
    np.testing.assert_array_equal(flat_rows,
                                  plane.peek(keys).reshape(2, 3, DIM))
    plane.close()


def test_cache_hits_and_misses_accounted():
    plane = make_plane(2)
    cache = make_cache(plane)
    cache.lookup(np.array([1, 2, 3], np.int64))
    assert cache.misses == 3 and cache.hits == 0
    cache.lookup(np.array([1, 2, 4], np.int64))
    assert cache.misses == 4 and cache.hits == 2
    assert cache.hit_rate == pytest.approx(2 / 6)
    plane.close()


def test_cache_evicts_lru_outside_current_batch():
    plane = make_plane(2)
    cache = make_cache(plane, capacity=5, max_unique=4)
    cache.lookup(np.array([1, 2, 3, 4], np.int64))
    cache.lookup(np.array([2, 3, 4], np.int64))  # 1 becomes LRU
    cache.lookup(np.array([5], np.int64))        # needs one slot
    assert cache.evictions == 1
    assert 1 not in cache and 5 in cache
    for key in (2, 3, 4):
        assert key in cache
    plane.close()


def test_cache_writeback_after_gradients_stays_bitwise():
    plane = make_plane(2)
    cache = make_cache(plane)
    keys = np.array([10, 20, 30], np.int64)
    _, uniq, _ = cache.lookup(keys)
    grads = np.ones((len(uniq), DIM), np.float32)
    cache.apply_gradients(uniq, grads)
    rows, _, _ = cache.lookup(keys)  # all hits: the device copy is fresh
    assert cache.misses == 3
    np.testing.assert_array_equal(rows[: len(uniq)].numpy(),
                                  plane.peek(uniq))
    plane.close()


def test_cache_one_gather_per_lookup_whatever_the_unique_count():
    """The JAX cache's no-retrace pin, in the port's terms: every lookup is
    one gather call over the padded width, and every ensure with misses
    and every refresh one scatter call, whatever the unique count."""
    plane = make_plane(2)
    cache = make_cache(plane)
    rng = np.random.default_rng(0)
    for i in range(8):
        n = int(rng.integers(1, 30))
        before = cache.stats()
        rows, uniq, _ = cache.lookup(
            rng.integers(0, 300, size=n).astype(np.int64))
        after = cache.stats()
        assert rows.shape == (32, DIM)
        assert after["gathers"] - before["gathers"] == 1
        missed = int(after["misses"] > before["misses"])
        assert after["scatters"] - before["scatters"] == missed
        assert after["fetches"] - before["fetches"] == missed
        cache.apply_gradients(uniq, np.zeros((len(uniq), DIM), np.float32))
        assert cache.stats()["scatters"] - after["scatters"] == 1
    assert kernels.LAUNCHES == {"embed_gather": 0, "embed_scatter": 0}
    plane.close()


def test_cache_rejects_oversized_batch_and_tiny_capacity():
    plane = make_plane(2)
    with pytest.raises(ValueError):
        DeviceHotRowCache(plane, capacity=8, max_unique=8, device="cpu")
    cache = make_cache(plane, capacity=9, max_unique=8)
    with pytest.raises(ValueError):
        cache.lookup(np.arange(9, dtype=np.int64))
    plane.close()


def test_cache_invalidate_drops_residency_and_zeroes_the_buffer():
    plane = make_plane(2)
    cache = make_cache(plane)
    cache.lookup(np.array([1, 2], np.int64))
    buf = cache.memory_buffers()[0]
    cache.invalidate()
    assert len(cache) == 0
    assert cache.memory_buffers()[0] is buf and not buf.any()
    cache.lookup(np.array([1, 2], np.int64))
    assert cache.misses == 4  # refetched after the invalidate
    plane.close()


def test_gathered_rows_are_a_copy_a_later_scatter_cannot_change():
    plane = make_plane(2)
    cache = make_cache(plane)
    rows, uniq, _ = cache.lookup(np.array([5, 6, 7], np.int64))
    held = rows.clone()
    cache.apply_gradients(uniq, np.ones((len(uniq), DIM), np.float32))
    cache.prefetch(np.arange(100, 120, dtype=np.int64))
    assert rows.data_ptr() != cache.memory_buffers()[0].data_ptr()
    assert torch.equal(rows, held)
    assert not torch.equal(cache.lookup(np.array([5, 6, 7]))[0][:3],
                           held[:3])
    plane.close()


def test_prefetcher_preserves_order_and_warms_cache():
    plane = make_plane(2)
    cache = make_cache(plane)
    batches = [
        {"ids": np.array([i, i + 100], np.int64), "tag": i}
        for i in range(5)
    ]
    pf = EmbeddingPrefetcher(iter(batches), cache, depth=2)
    seen = []
    for batch in pf:
        assert int(batch["ids"][0]) in cache
        seen.append(batch["tag"])
    assert seen == [0, 1, 2, 3, 4]
    assert cache.misses == 10  # every unique id warmed exactly once
    plane.close()


def test_prefetcher_drain_rewarms_after_invalidate():
    plane = make_plane(2)
    cache = make_cache(plane)
    batches = [{"ids": np.array([i, i + 100], np.int64)} for i in range(4)]
    pf = EmbeddingPrefetcher(iter(batches), cache, depth=2)
    it = iter(pf)
    next(it)
    cache.invalidate()
    assert pf.drain() > 0
    out = list(it)
    assert len(out) == 3
    assert all(int(b["ids"][0]) in cache for b in out)
    plane.close()


# -- the cache against the JAX cache -------------------------------------------


def test_cache_matches_jax_cache_on_one_stream():
    """One stream of lookups, prefetches and gradient pushes, with
    evictions, through both packages: the same slot of every key, the
    same hits, misses and evictions, the same rows bit for bit."""
    rng = np.random.default_rng(4)
    port_plane = make_plane(3)
    jax_plane = JaxPlane("plane", dim=DIM, world=3, num_buckets=16,
                         learning_rate=0.05, seed=3)
    port = make_cache(port_plane, capacity=40, max_unique=24)
    ref = JaxCache(jax_plane, capacity=40, max_unique=24)
    for step in range(12):
        keys = (rng.zipf(1.3, size=20) % 90).astype(np.int64)
        rows, uniq, inverse = port.lookup(keys)
        jrows, juniq, jinverse = ref.lookup(keys)
        np.testing.assert_array_equal(uniq, juniq)
        np.testing.assert_array_equal(inverse, jinverse)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        grads = rng.normal(size=(len(uniq), DIM)).astype(np.float32)
        port.apply_gradients(uniq, grads)
        ref.apply_gradients(juniq, grads)
        ahead = (rng.zipf(1.3, size=10) % 90).astype(np.int64)
        assert port.prefetch(ahead) == ref.prefetch(ahead)
        assert port._slot_of == ref._slot_of
        stats = port.stats()
        for key in ("gathers", "scatters", "fetches"):
            stats.pop(key)
        assert stats == ref.stats()
    assert ref.evictions > 0
    np.testing.assert_array_equal(port.memory_buffers()[0].numpy(),
                                  np.asarray(ref.memory_buffers()[0]))
    port_plane.close()
    jax_plane.close()


# -- the CTR loop ----------------------------------------------------------------


LOOP_ARGV = [
    "--steps", "6", "--batch-size", "32", "--fields", "4", "--dim", "8",
    "--hidden", "16", "--world", "2", "--num-buckets", "16",
    "--cache-rows", "160", "--max-unique", "128", "--reshard-at", "3:3",
]


def _jax_loop(args, dense_np):
    """``examples/train_rec.py``'s loop (:93-172) on the JAX package's
    plane, cache and prefetcher, from the given dense parameters; returns
    the losses and the plane's rows of every touched key."""
    rng = np.random.default_rng(0)
    reshard_plan = dict(train_rec.parse_reshard_plan(args.reshard_at))

    def batches(n):
        for _ in range(n):
            raw = rng.zipf(1.3, size=(args.batch_size, args.fields))
            ids = (raw % args.id_space).astype(np.int64)
            label = ((ids.sum(axis=1) % 97) < 33).astype(np.float32)
            yield {"ids": ids, "label": label}

    plane = JaxPlane("rec", dim=args.dim, num_buckets=args.num_buckets,
                     world=args.world, learning_rate=args.lr, seed=1,
                     optimizer=args.sparse_optimizer)
    cache = JaxCache(plane, capacity=args.cache_rows,
                     max_unique=args.max_unique)

    def step_fn(dense, rows, inverse, label):
        def loss_fn(dense, rows):
            gathered = rows[inverse].reshape(label.shape[0], -1)
            h = jax.nn.relu(gathered @ dense["w1"] + dense["b1"])
            logit = (h @ dense["w2"] + dense["b2"])[:, 0]
            logit = logit + gathered.mean(axis=1)
            return jnp.mean(
                optax.sigmoid_binary_cross_entropy(logit, label))

        loss, (dg, drows) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            dense, rows)
        return loss, dg, drows

    step_fn = jax.jit(step_fn)
    dense = {k: jnp.asarray(v) for k, v in dense_np.items()}
    tx = optax.adam(args.lr)
    opt_state = tx.init(dense)
    losses, touched = [], set()
    source = JaxPrefetcher(batches(args.steps), cache, key_field="ids",
                           depth=args.prefetch_depth)
    step = 0
    for batch in source:
        step += 1
        rows, uniq, inverse = cache.lookup(batch["ids"])
        loss, dg, drows = step_fn(dense, rows, jnp.asarray(inverse),
                                  jnp.asarray(batch["label"]))
        updates, opt_state = tx.update(dg, opt_state, dense)
        dense = optax.apply_updates(dense, updates)
        cache.apply_gradients(uniq, np.asarray(drows)[: len(uniq)])
        losses.append(float(loss))
        touched.update(uniq.tolist())
        if step in reshard_plan:
            plane.reshard(reshard_plan[step])
            source.drain()
    keys = np.array(sorted(touched), np.int64)
    out = losses, keys, plane.peek(keys), cache.stats(), plane.stats()
    plane.close()
    return out


def _dense_np(args, seed=7):
    rng = np.random.default_rng(seed)
    width = args.dim * args.fields
    return {
        "w1": (rng.normal(size=(width, args.hidden))
               / np.sqrt(width)).astype(np.float32),
        "b1": (0.01 * rng.normal(size=args.hidden)).astype(np.float32),
        "w2": (0.1 * rng.normal(size=(args.hidden, 1))).astype(np.float32),
        "b2": np.zeros(1, np.float32),
    }


def test_run_matches_the_jax_example_loop():
    """Six steps at small size (evicting cache, a 2 -> 3 reshard at step
    3) through ``train_rec.run`` and through the JAX example's loop from
    the same dense parameters: losses and every touched plane row within
    1e-5, the cache's counters equal."""
    args = train_rec.parse_args(LOOP_ARGV)
    dense_np = _dense_np(args)
    seen = {}

    def on_step(step, cache, uniq):
        seen.setdefault("keys", set()).update(uniq.tolist())
        if step == args.steps:
            keys = np.array(sorted(seen["keys"]), np.int64)
            seen["rows"] = cache.plane.peek(keys)
        # The cache's own invariant: its rows are the plane's, bitwise.
        got = kernels.gather_rows(cache.memory_buffers()[0],
                                  cache.slots_of(uniq))[: len(uniq)]
        np.testing.assert_array_equal(got.numpy(), cache.plane.peek(uniq))

    result = train_rec.run(args, dense=rec_dense_from_jax(dense_np),
                           device="cpu", on_step=on_step)
    losses, keys, rows, jcache, jplane = _jax_loop(args, dense_np)
    np.testing.assert_allclose(result["losses"], losses, rtol=0,
                               atol=LOOP_ATOL)
    np.testing.assert_array_equal(np.array(sorted(seen["keys"])), keys)
    np.testing.assert_allclose(seen["rows"], rows, rtol=0, atol=LOOP_ATOL)
    cache_stats = dict(result["cache"])
    assert cache_stats.pop("gathers") == args.steps
    assert cache_stats.pop("scatters") == (args.steps
                                           + cache_stats.pop("fetches"))
    assert cache_stats == jcache and jcache["evictions"] > 0
    assert result["plane"]["moved_rows"] == jplane["moved_rows"] > 0
    (reshard,) = result["reshards"]
    assert reshard["rows_before"] == reshard["rows_after"]
    assert reshard["src"] == 2 and reshard["dst"] == 3


def test_run_falls_and_restores_from_a_checkpoint(tmp_path):
    argv = LOOP_ARGV[:1] + ["12"] + LOOP_ARGV[2:] + [
        "--checkpoint-dir", str(tmp_path), "--ckpt-every", "4",
        "--lr", "0.05"]
    args = train_rec.parse_args(argv)
    result = train_rec.run(args, device="cpu")
    losses = result["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    plane = ShardedEmbeddingTable("rec", dim=args.dim,
                                  num_buckets=args.num_buckets, world=3)
    assert plane.restore(str(tmp_path)) > 0
    assert len(plane) == result["rows"]
    plane.close()


def test_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_rec.run(train_rec.parse_args(LOOP_ARGV))


def test_every_flag_of_the_jax_example_is_kept():
    spec = importlib.util.spec_from_file_location(
        "_jax_train_rec", os.path.join(REPO, "examples", "train_rec.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ref = vars(module.parse_args([]))
    port = vars(train_rec.parse_args([]))
    assert port.pop("device") is None
    assert port == ref
    assert train_rec.parse_reshard_plan("200:4, 100:2,") == [(100, 2),
                                                            (200, 4)]


def test_rec_dense_from_jax_checks_names_and_shapes():
    args = argparse.Namespace(dim=4, fields=3, hidden=5)
    dense = _dense_np(args)
    out = rec_dense_from_jax(dense)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "w1": (12, 5), "b1": (5,), "w2": (5, 1), "b2": (1,)}
    assert all(v.dtype == torch.float32 for v in out.values())
    with pytest.raises(KeyError):
        rec_dense_from_jax({k: v for k, v in dense.items() if k != "b2"})
    with pytest.raises(ValueError):
        rec_dense_from_jax(dict(dense, w2=np.zeros((4, 1), np.float32)))

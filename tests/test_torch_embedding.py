"""Port parity: the host side of ``dlrover_tpu_torch.embedding`` (store,
spill tier, sharded plane, host-local table) and the plain versions of
its two kernels, against ``dlrover_tpu.embedding``.

Tolerances.  Everything here is compared bitwise.  The native stores of
both packages are the same C++ code (the sources differ in one comment)
compiled the same way, and the NumPy stores the same numpy operations, so
one key and gradient stream gives equal rows, moments and counts.  The
plane's routing, record codec and exports move bytes and do no
arithmetic.  The plain gather and scatter copy rows, as the Pallas bodies
do.

Each test seeds its own generator.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlrover_tpu.embedding import kernels as jkernels
from dlrover_tpu.embedding import sharded as jsharded
from dlrover_tpu.embedding import spill as jspill
from dlrover_tpu.embedding import store as jstore
from dlrover_tpu.embedding import table as jtable
from dlrover_tpu_torch.embedding import (
    EmbeddingTable,
    KVStore,
    ShardedEmbeddingTable,
    hash_bucket,
)
from dlrover_tpu_torch.embedding import device_cache, kernels, spill, store
from dlrover_tpu_torch.runtime.virtual_mesh import shard_owner

DIM = 8
STORE_OPTIMIZERS = ("adam", "adagrad", "ftrl", "lamb", "radam", "adahessian")


def _apply(store_obj, opt, keys, grads, hess, t):
    if opt == "adam":
        store_obj.apply_group_adam(keys, grads, lr=0.05, weight_decay=0.01,
                                   t=t)
    elif opt == "adagrad":
        store_obj.apply_group_adagrad(keys, grads, lr=0.05)
    elif opt == "ftrl":
        store_obj.apply_group_ftrl(keys, grads, lr=0.05, l1=0.001, l2=0.01,
                                   beta=0.1)
    elif opt == "lamb":
        store_obj.apply_group_lamb(keys, grads, lr=0.05, weight_decay=0.01,
                                   t=t)
    elif opt == "radam":
        store_obj.apply_group_radam(keys, grads, lr=0.05, t=t)
    else:
        store_obj.apply_group_adahessian(keys, grads, hess, lr=0.05, t=t)


def _assert_exports_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _by_key(export):
    """An export's six arrays in key order (a store exports in its own
    slot order)."""
    order = np.argsort(export[0], kind="stable")
    return tuple(np.asarray(a)[order] for a in export)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("opt", STORE_OPTIMIZERS)
def test_kvstore_matches_jax_store_bitwise(opt, native):
    """One key/gradient stream (inserts, repeats, absent keys) through
    both packages' stores, for every optimizer: rows, moments, counts and
    steps equal bit for bit (native against native, NumPy against
    NumPy)."""
    rng = np.random.default_rng(11)
    port = KVStore(DIM, initial_capacity=16, native=native)
    ref = jstore.KVStore(DIM, initial_capacity=16, native=native)
    assert port.native is native and ref.native is native
    for t in range(1, 6):
        keys = rng.integers(-40, 200, size=30).astype(np.int64)
        np.testing.assert_array_equal(
            port.lookup(keys, 0.05, seed=3, step=t),
            ref.lookup(keys, 0.05, seed=3, step=t))
        uniq = np.unique(keys)
        uniq = np.concatenate([uniq, [10_000 + t]])  # absent: skipped
        grads = rng.normal(size=(uniq.size, DIM)).astype(np.float32)
        hess = rng.normal(size=(uniq.size, DIM)).astype(np.float32)
        _apply(port, opt, uniq, grads, hess, t)
        _apply(ref, opt, uniq, grads, hess, t)
    _assert_exports_equal(port.export(), ref.export())
    _assert_exports_equal(port.export(min_step=4), ref.export(min_step=4))
    probe = np.arange(-50, 210, dtype=np.int64)
    np.testing.assert_array_equal(port.peek(probe), ref.peek(probe))
    gone = probe[::3]
    assert port.remove(gone) == ref.remove(gone)
    assert port.evict(min_step=5, min_count=3) == ref.evict(5, 3)
    _assert_exports_equal(port.export(), ref.export())
    assert len(port) == len(ref)
    port.close()
    ref.close()


def test_native_store_raises_rather_than_falls_back(monkeypatch, tmp_path):
    """``native=None`` and ``native=True`` mean the C++ table: a compiler
    that is missing or fails raises with its output; only ``native=False``
    gives the NumPy store."""
    monkeypatch.setattr(store, "_lib", None)
    monkeypatch.setattr(store, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(store, "CXX", str(tmp_path / "no-such-g++"))
    for native in (None, True):
        with pytest.raises(RuntimeError, match="cannot run"):
            KVStore(DIM, native=native)
    assert KVStore(DIM, native=False).native is False

    bad = tmp_path / "kv_store.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(store, "CXX", "g++")
    monkeypatch.setattr(store, "_SRC", str(bad))
    with pytest.raises(RuntimeError, match="rc 1"):
        KVStore(DIM)
    assert not os.listdir(tmp_path / "build")  # nothing half-built left


def test_native_source_is_the_jax_packages_and_builds_outside_it():
    """The C++ table is the JAX package's, line for line but for the
    header comment's path to the capability reference."""
    with open(store._SRC, "rb") as a, open(
            os.path.join(os.path.dirname(jstore.__file__), "native",
                         "kv_store.cc"), "rb") as b:
        port, ref = a.read().splitlines(), b.read().splitlines()
    assert len(port) == len(ref)
    assert [i for i, (x, y) in enumerate(zip(port, ref)) if x != y] == [3]
    assert port[3].startswith(b"// (tfplus/tfplus/kv_variable/")
    lib = store._load_native()
    assert lib is not None
    assert os.path.dirname(store._target()) == store.BUILD_DIR
    assert os.path.exists(store._target())
    assert not os.path.dirname(store._SRC).startswith(store.BUILD_DIR)


def test_hash_bucket_and_fold_match_jax():
    rng = np.random.default_rng(5)
    keys = np.concatenate([
        rng.integers(-2**62, 2**62, size=5000, dtype=np.int64),
        np.array([0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]),
    ])
    for buckets in (1, 16, 64, 97):
        np.testing.assert_array_equal(
            hash_bucket(keys, buckets), jsharded.hash_bucket(keys, buckets))
    for world in (1, 3, 4):
        assert [shard_owner(b, world) for b in range(64)] == [
            jsharded.shard_owner(b, world) for b in range(64)]


# -- sharded plane -------------------------------------------------------------


def make_plane(world, **kw):
    kw.setdefault("num_buckets", 16)
    kw.setdefault("learning_rate", 0.05)
    kw.setdefault("seed", 3)
    return ShardedEmbeddingTable("plane", dim=DIM, world=world, **kw)


def make_jax_plane(world, **kw):
    kw.setdefault("num_buckets", 16)
    kw.setdefault("learning_rate", 0.05)
    kw.setdefault("seed", 3)
    return jsharded.ShardedEmbeddingTable("plane", dim=DIM, world=world,
                                          **kw)


def drive(plane, steps=4, seed=0, batch=64):
    """Deterministic lookup+gradient stream, replayable on any fold."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        keys = rng.integers(0, 500, size=batch).astype(np.int64)
        _, uniq, _ = plane.lookup(keys)
        grads = np.outer(
            (uniq % 13 - 6).astype(np.float32) * 0.02,
            np.ones(DIM, np.float32),
        )
        plane.apply_gradients(uniq, grads)
    return plane


def snapshot(plane):
    """{key: (value, m, v, count)} across every owner host."""
    out = {}
    for host in plane._hosts:
        keys, rows, m, v, counts, _ = host.export()
        for i, key in enumerate(keys.tolist()):
            out[key] = (rows[i].copy(), m[i].copy(), v[i].copy(),
                        int(counts[i]))
    return out


def assert_snapshots_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        for leg in range(3):
            np.testing.assert_array_equal(a[key][leg], b[key][leg])
        assert a[key][3] == b[key][3]


@pytest.mark.parametrize("opt", ("adam", "adagrad", "ftrl", "lamb", "radam"))
def test_sharded_plane_matches_jax_plane_bitwise(opt):
    """The same stream through both packages' planes at world 3: lookups,
    updates with every plane optimizer, rows and moments equal."""
    port = drive(make_plane(3, optimizer=opt))
    ref = drive(make_jax_plane(3, optimizer=opt))
    assert_snapshots_equal(snapshot(port), snapshot(ref))
    assert port.stats() == ref.stats()
    rows, uniq, inverse = port.lookup(np.array([[9, 4], [4, 9]], np.int64))
    jrows, juniq, jinverse = ref.lookup(np.array([[9, 4], [4, 9]]))
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(uniq, juniq)
    np.testing.assert_array_equal(inverse, jinverse)
    port.close()
    ref.close()


@pytest.mark.parametrize("world", [2, 3, 4])
def test_sharded_lookup_and_update_match_world_1_bitwise(world):
    sharded = drive(make_plane(world))
    reference = drive(make_plane(1))
    keys = np.arange(500, dtype=np.int64)
    np.testing.assert_array_equal(sharded.peek(keys), reference.peek(keys))
    assert len(sharded) == len(reference)
    sharded.close()
    reference.close()


@pytest.mark.parametrize("src,dst", [
    (s, d) for s in (1, 2, 3, 4) for d in (1, 2, 3, 4) if s != d])
def test_reshard_matrix_rows_and_moments_exact(src, dst):
    """Every n->m fold over worlds {1, 2, 3, 4}: rows, moments and counts
    exact, every row on its new owner, retired hosts gone, and the same
    moves as the JAX plane's reshard."""
    plane = drive(make_plane(src))
    ref = drive(make_jax_plane(src))
    before = snapshot(plane)
    summary = plane.reshard(dst)
    assert summary == ref.reshard(dst)
    after = snapshot(plane)
    assert plane.world == dst and len(plane._hosts) == dst
    assert_snapshots_equal(before, after)
    for rank in range(dst):
        keys = plane._hosts[rank].export()[0]
        np.testing.assert_array_equal(
            plane.owner_of(keys), np.full(keys.shape, rank))
        assert set(plane.bucket_of(keys).tolist()) <= set(
            plane.owned_buckets(rank))
    assert summary["moved_rows"] > 0
    assert_snapshots_equal(after, snapshot(ref))
    plane.close()
    ref.close()


@pytest.mark.parametrize("dst", [2, 3])
def test_reshard_then_training_matches_jax(dst):
    """Train, re-fold, train on: the port's plane equals the JAX plane's
    bit for bit, and at 4 -> 2 also a never-resharded world-1 plane (at
    4 -> 3 the JAX plane itself departs from world 1 on 2 of 264 keys, a
    reference behaviour the port keeps; ``ROADMAP.md`` Queue 3)."""
    planes = []
    for make in (make_plane, make_jax_plane):
        elastic = drive(make(4), steps=3, seed=1)
        elastic.reshard(dst)
        planes.append(drive(elastic, steps=3, seed=2))
    keys = np.arange(500, dtype=np.int64)
    np.testing.assert_array_equal(planes[0].peek(keys), planes[1].peek(keys))
    assert_snapshots_equal(snapshot(planes[0]), snapshot(planes[1]))
    if dst == 2:
        reference = drive(make_plane(1), steps=3, seed=1)
        drive(reference, steps=3, seed=2)
        np.testing.assert_array_equal(planes[0].peek(keys),
                                      reference.peek(keys))
        reference.close()
    for p in planes:
        p.close()


# -- record codec and spill tier -----------------------------------------------


def _records(rng, n):
    return (rng.integers(-1000, 1000, size=n).astype(np.int64),
            rng.normal(size=(n, DIM)).astype(np.float32),
            rng.normal(size=(n, DIM)).astype(np.float32),
            rng.normal(size=(n, DIM)).astype(np.float32),
            rng.integers(0, 99, size=n).astype(np.uint32),
            rng.integers(0, 99, size=n).astype(np.uint32))


def test_pack_unpack_records_is_the_jax_wire_format():
    rng = np.random.default_rng(2)
    recs = _records(rng, 17)
    payload = spill.pack_records(*recs)
    assert payload == jspill.pack_records(*recs)
    _assert_exports_equal(spill.unpack_records(payload, DIM), recs)
    _assert_exports_equal(spill.unpack_records(b"", DIM),
                          jspill.unpack_records(b"", DIM))
    with pytest.raises(ValueError):
        spill.unpack_records(payload[:-3], DIM)
    with pytest.raises(ValueError):
        spill.unpack_records(payload[:10], DIM)
    with pytest.raises(ValueError):
        spill.unpack_records(payload, DIM + 1)


def test_hybrid_store_spills_and_faults_back_with_state(tmp_path):
    """Cold rows demote to disk (the log survives a reopen), fault back on
    lookup with moments and counts, and train on as if never spilled."""
    keys = np.arange(20, dtype=np.int64)
    grads = np.full((20, DIM), 0.1, np.float32)
    hybrid = spill.HybridKVStore(DIM, str(tmp_path / "t.spill"))
    plain = KVStore(DIM)
    for s in (hybrid, plain):
        s.lookup(keys, 0.05, seed=1, step=1)
        s.apply_group_adam(keys, grads, lr=0.1, t=1)
    assert hybrid.spill(min_step=2, min_count=5) == 20
    assert hybrid.ram_rows == 0 and hybrid.disk_rows == 20
    np.testing.assert_array_equal(hybrid.peek(keys), plain.peek(keys))
    _assert_exports_equal(_by_key(hybrid.export()), _by_key(plain.export()))
    hybrid.close()
    hybrid = spill.HybridKVStore(DIM, str(tmp_path / "t.spill"))
    assert hybrid.disk_rows == 20  # the index rebuilt from the log
    for s in (hybrid, plain):
        s.lookup(keys[:5], 0.05, seed=1, step=2)
        s.apply_group_adam(keys[:5], grads[:5], lr=0.1, t=2)
    assert hybrid.ram_rows == 5 and hybrid.disk_rows == 15
    _assert_exports_equal(_by_key(hybrid.export()), _by_key(plain.export()))
    assert hybrid.remove(keys[:8]) == 8 == plain.remove(keys[:8])
    hybrid.compact()
    assert len(hybrid) == 12
    _assert_exports_equal(_by_key(hybrid.export()), _by_key(plain.export()))
    hybrid.close()


def test_reshard_with_spill_tier_moves_cold_rows(tmp_path):
    plane = make_plane(2, spill_dir=str(tmp_path))
    drive(plane)
    for host in plane._hosts:
        host.spill(min_step=plane.step + 1, min_count=10**6)
    before = snapshot(plane)
    plane.reshard(3)
    assert_snapshots_equal(before, snapshot(plane))
    assert plane.stats()["spill_bytes"] > 0
    plane.close()


# -- exports -------------------------------------------------------------------


@pytest.mark.parametrize("jax_world,port_world", [(2, 3), (4, 1), (3, 3)])
def test_restores_a_jax_plane_export_at_another_world(tmp_path, jax_world,
                                                      port_world):
    """The JAX plane's full and delta exports, restored by the port's plane
    at another world: rows, moments and counts bitwise, every row on its
    owner under the port's fold, clocks carried (the state that crosses
    packages)."""
    ref = drive(make_jax_plane(jax_world))
    ref.save(str(tmp_path), step=4)
    drive(ref, steps=2, seed=9)
    ref.save(str(tmp_path), step=6, delta=True)
    port = make_plane(port_world)
    assert port.restore(str(tmp_path)) == ref.step
    assert_snapshots_equal(snapshot(port), snapshot(ref))
    assert port.booking()["adam_t"] == ref.booking()["adam_t"]
    for rank in range(port_world):
        keys = port._hosts[rank].export()[0]
        np.testing.assert_array_equal(
            port.owner_of(keys), np.full(keys.shape, rank))
    # Training goes on identically from the carried state.
    drive(port, steps=2, seed=4)
    drive(ref, steps=2, seed=4)
    assert_snapshots_equal(snapshot(port), snapshot(ref))
    port.close()
    ref.close()


def test_jax_plane_restores_a_port_export(tmp_path):
    port = drive(make_plane(3))
    port.save(str(tmp_path), step=4)
    ref = make_jax_plane(2)
    ref.restore(str(tmp_path))
    assert_snapshots_equal(snapshot(ref), snapshot(port))
    port.close()
    ref.close()


def test_corrupt_export_falls_back_to_previous_full(tmp_path):
    plane = drive(make_plane(2), steps=2)
    plane.save(str(tmp_path), step=2)
    good = snapshot(plane)
    drive(plane, steps=2, seed=5)
    plane.save(str(tmp_path), step=4)
    newest = os.path.join(str(tmp_path), "plane_full_4")
    victim = [os.path.join(newest, f) for f in sorted(os.listdir(newest))
              if f.endswith(".data")][-1]  # the last shard read
    with open(victim, "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff")
    fresh = make_plane(2)
    fresh.restore(str(tmp_path))
    assert_snapshots_equal(snapshot(fresh), good)
    plane.close()
    fresh.close()


def test_drain_flushes_the_delta_leg(tmp_path):
    plane = drive(make_plane(2), steps=2)
    plane.save(str(tmp_path), step=2)
    drive(plane, steps=1, seed=8)
    out = plane.drain(str(tmp_path), step=3)
    assert "delta" in os.path.basename(out)
    fresh = make_plane(3)
    fresh.restore(str(tmp_path))
    assert_snapshots_equal(snapshot(fresh), snapshot(plane))
    plane.close()
    fresh.close()


def test_booking_roundtrip_adopts_world_and_clocks():
    plane = drive(make_plane(4))
    booking = plane.booking()
    assert booking == drive(make_jax_plane(4)).booking()
    other = make_plane(2)
    other.adopt_booking(booking)
    assert other.world == 4 and other.step == plane.step
    with pytest.raises(ValueError):
        other.adopt_booking(dict(booking, num_buckets=999))
    with pytest.raises(ValueError):
        make_plane(32, num_buckets=16)
    with pytest.raises(ValueError):
        other.reshard(17)
    plane.close()
    other.close()


# -- host-local table ----------------------------------------------------------


@pytest.mark.parametrize("opt", STORE_OPTIMIZERS)
def test_table_matches_jax_table_and_checkpoints(tmp_path, opt):
    """``EmbeddingTable`` with every optimizer against the JAX table on one
    stream, then a full + delta save restored by the JAX table."""
    rng = np.random.default_rng(8)
    port = EmbeddingTable("t", DIM, optimizer=opt, learning_rate=0.05)
    ref = jtable.EmbeddingTable("t", DIM, optimizer=opt, learning_rate=0.05)
    for step in range(4):
        keys = rng.integers(0, 60, size=(6, 3)).astype(np.int64)
        rows, uniq, inverse = port.lookup(keys)
        jrows, juniq, jinverse = ref.lookup(keys)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(inverse, jinverse)
        grads = rng.normal(size=(uniq.size, DIM)).astype(np.float32)
        hess = rng.normal(size=grads.shape).astype(np.float32)
        port.apply_gradients(uniq, grads, hess)
        ref.apply_gradients(juniq, grads, hess)
        if step == 1:
            port.save(str(tmp_path), step=2)
    port.save(str(tmp_path), step=4, delta=True)
    _assert_exports_equal(port.store.export(), ref.store.export())
    back = jtable.EmbeddingTable("t", DIM, optimizer=opt)
    assert back.restore(str(tmp_path)) == port.step
    _assert_exports_equal(back.store.export(), port.store.export())


def test_table_rejects_unknown_optimizer_and_spills(tmp_path):
    with pytest.raises(ValueError):
        EmbeddingTable("t", DIM, optimizer="sgd")
    with pytest.raises(ValueError):
        EmbeddingTable("t", DIM).spill(1)
    table = EmbeddingTable("t", DIM, spill_path=str(tmp_path / "t.spill"))
    table.lookup(np.arange(10))
    table.lookup(np.arange(3))
    assert table.spill(max_age_steps=0, min_count=2) == 7
    assert len(table) == 10


# -- the kernels' plain versions -----------------------------------------------


@pytest.mark.parametrize("dim", [8, 129])
def test_plain_kernels_match_the_pallas_bodies(monkeypatch, dim):
    """``gather_rows``/``scatter_rows`` on CPU tensors (the plain versions
    the CUDA kernels are held against) against the JAX Pallas bodies in
    interpret mode: a padded tail at scratch slot 0, duplicates only at
    slot 0 with zero rows."""
    monkeypatch.setenv(jkernels.ENV_MODE, "interpret")
    rng = np.random.default_rng(dim)
    cache_host = rng.normal(size=(16, dim)).astype(np.float32)
    slots = np.array([3, 0, 7, 7, 1, 15, 0, 0], np.int32)
    scatter_slots = np.array([2, 5, 9, 15, 0, 0], np.int32)
    rows = rng.normal(size=(6, dim)).astype(np.float32)
    rows[4:] = 0.0

    got = kernels.gather_rows(torch.from_numpy(cache_host.copy()), slots)
    want = np.asarray(jkernels.gather_rows(jnp.asarray(cache_host), slots))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, cache_host[slots])

    cache = torch.from_numpy(cache_host.copy())
    out = kernels.scatter_rows(cache, scatter_slots, rows)
    want = np.asarray(jkernels.scatter_rows(
        jnp.asarray(cache_host), scatter_slots, rows))
    assert out is cache  # in place
    np.testing.assert_array_equal(cache.numpy(), want)


def test_kernel_wrappers_check_slots_and_shapes():
    cache = torch.zeros((10, DIM))
    for bad in ([10], [-1], [3, 11]):
        with pytest.raises(IndexError):
            kernels.gather_rows(cache, np.array(bad))
        with pytest.raises(IndexError):
            kernels.scatter_rows(cache, np.array(bad),
                                 np.zeros((len(bad), DIM)))
    with pytest.raises(ValueError):
        kernels.gather_rows(cache, np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError):
        kernels.scatter_rows(cache, np.array([1, 2]), np.zeros((3, DIM)))
    with pytest.raises(TypeError):
        kernels.gather_rows(cache.double(), np.array([1]))
    # float64 rows are cast to float32, as the JAX wrapper casts them.
    kernels.scatter_rows(cache, np.array([4]), np.full((1, DIM), 0.1))
    assert cache.dtype == torch.float32
    np.testing.assert_array_equal(cache[4].numpy(),
                                  np.full(DIM, 0.1, np.float32))
    out = kernels.gather_rows(cache, np.array([4, 4]))
    assert out.data_ptr() != cache.data_ptr()


@pytest.mark.parametrize("case", [
    "int64_slots", "strided_slots", "2d_slots", "rows_shape", "rows_dtype",
    "strided_rows", "cpu_cache"])
def test_kernel_entry_points_refuse_what_they_would_misread(case):
    # The kernels read slots and rows through raw pointers: every case is
    # refused before the launch (here the CPU cache is the last refusal).
    cache = torch.zeros((10, DIM))
    slots = torch.arange(4, dtype=torch.int32)
    rows = torch.zeros((4, DIM))
    if case == "int64_slots":
        slots = slots.long()
    elif case == "strided_slots":
        slots = torch.arange(8, dtype=torch.int32)[::2]
    elif case == "2d_slots":
        slots = slots.reshape(2, 2)
    elif case == "rows_shape":
        rows = torch.zeros((3, DIM))
    elif case == "rows_dtype":
        rows = rows.double()
    elif case == "strided_rows":
        rows = torch.zeros((DIM, 4)).t()
    match = {"int64_slots": "slots", "strided_slots": "slots",
             "2d_slots": "slots", "cpu_cache": "CUDA cache"}.get(case, "rows")
    with pytest.raises(ValueError, match=match):
        kernels.scatter_kernel(cache, slots, rows)
    if match != "rows":
        with pytest.raises(ValueError, match=match):
            kernels.gather_kernel(cache, slots)
    assert not cache.any()


def test_a_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request succeeds")
    plane = make_plane(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_cache.DeviceHotRowCache(plane, capacity=8, max_unique=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_cache.DeviceHotRowCache(plane, capacity=8, max_unique=4,
                                       device="cuda")
    plane.close()

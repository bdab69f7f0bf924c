"""The port's sharded Flash Checkpoint across worlds and its live
re-layout (``checkpoint/{shm_handler,engine}.py`` with layouts,
``runtime/virtual_mesh.relayout_state``, ``ElasticTrainer.
apply_world_change``), in spawned gloo worlds of 2 and 4 processes on
the tiny model, against the JAX package where it writes or reads the
same files.

Everything here is bit for bit: a restore lands the saved bytes, and the
live re-layout goes through the same record path with the wire in place
of storage.  The state under test is ZeRO-1's: the parameters replicated
(rank 0 writes them) and the Adafactor or sgd state split over the ranks
(each rank writes its shards).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_worlds
from dlrover_tpu.checkpoint import Checkpointer as JCheckpointer
from dlrover_tpu.checkpoint import StorageType as JStorageType
from dlrover_tpu.checkpoint.engine import StorageStepReader as JReader
from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.parallel import rules as jrules
from dlrover_tpu.runtime.mesh import ParallelConfig, build_mesh
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.checkpoint.from_jax import load_jax_checkpoint
from dlrover_tpu_torch.models import gpt2_config
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax

WORLDS = (1, 2, 4)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Each test's own shm arenas and sockets (xdist workers share
    ``/dev/shm``); the arenas are removed after."""
    job = f"tr{os.getpid()}_{abs(hash(str(tmp_path))) % 10**8}"
    monkeypatch.setenv("DLROVER_TPU_JOB", job)
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    os.makedirs(tmp_path / "socks", exist_ok=True)
    yield job
    for name in os.listdir("/dev/shm"):
        if job in name:
            try:
                os.unlink(os.path.join("/dev/shm", name))
            except FileNotFoundError:
                pass


def _assert_pieces_equal(got, whole):
    """Every piece of a rank's restored state equals the whole saved
    state at its index, bit for bit."""
    assert set(got) == set(whole)
    for path, (shape, index, _, value) in got.items():
        want = whole[path]
        if not isinstance(value, np.ndarray):
            assert value == want, path
            continue
        assert tuple(want.shape) == tuple(shape), path
        part = want[tuple(slice(b, e) for b, e in index)]
        assert value.dtype == part.dtype, path
        np.testing.assert_array_equal(value.view(np.uint8),
                                      np.ascontiguousarray(part).view(
                                          np.uint8), err_msg="".join(path))


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """Saves at n = 1, 2, 4 and restores of each at m = 1, 2, 4."""
    root = tmp_path_factory.mktemp("resize")
    dirs = {n: str(root / f"ckpt{n}") for n in WORLDS}
    job = f"mx{os.getpid()}"
    prev = {k: os.environ.get(k) for k in ("DLROVER_TPU_JOB",
                                           "DLROVER_TPU_SOCKET_DIR")}
    os.environ["DLROVER_TPU_SOCKET_DIR"] = str(root / "socks")
    os.makedirs(root / "socks", exist_ok=True)
    try:
        saved, restored = {}, {}
        one = torch_worlds.save_and_restore(0, 1, {"save": dirs[1],
                                                   "job": job})
        saved[1] = [one["saved"]]
        two = torch_worlds.run_world(2, torch_worlds.save_and_restore, {
            "save": dirs[2], "restore": {1: dirs[1]}, "job": job}, root)
        saved[2] = [r["saved"] for r in two]
        four = torch_worlds.run_world(4, torch_worlds.save_and_restore, {
            "save": dirs[4], "restore": {1: dirs[1], 2: dirs[2],
                                         4: dirs[4]},
            "job": job}, root)
        saved[4] = [r["saved"] for r in four]
        again = torch_worlds.run_world(2, torch_worlds.save_and_restore, {
            "restore": {2: dirs[2], 4: dirs[4]}, "job": f"{job}b"}, root)
        for n in WORLDS:
            restored[(n, 1)] = [torch_worlds.save_and_restore(
                0, 1, {"restore": {n: dirs[n]}, "job": f"{job}c"})[n]]
        restored[(1, 2)] = [r[1] for r in two]
        restored[(1, 4)] = [r[1] for r in four]
        restored[(2, 4)] = [r[2] for r in four]
        restored[(4, 4)] = [r[4] for r in four]
        restored[(2, 2)] = [r[2] for r in again]
        restored[(4, 2)] = [r[4] for r in again]
        worlds = {1: one["world"], 2: two[0]["world"], 4: four[0]["world"]}
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))
    return saved, restored, dirs, worlds


@pytest.mark.parametrize("n", WORLDS)
def test_the_sharded_save_writes_each_piece_once(matrix, n):
    """Each saving rank's records: its ZeRO-1 shards and, on rank 0 only,
    the replicated leaves (replica 0); together they cover every leaf
    exactly once."""
    saved, _, _, worlds = matrix
    assert worlds[n] == (n, n, n > 1)
    counts = {}
    for rank in saved[n]:
        for path, (shape, index, replica, value) in rank.items():
            if replica == 0 and isinstance(value, np.ndarray):
                counts[path] = counts.get(path, 0) + int(np.prod(
                    [e - b for b, e in index]))
    whole = torch_worlds.assemble(saved[n])
    for path, arr in whole.items():
        if isinstance(arr, np.ndarray):
            assert counts[path] == arr.size, path
    split = [p for p, v in saved[n][0].items() if v[1] != tuple(
        (0, d) for d in v[0])]
    assert bool(split) == (n > 1)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("m", WORLDS)
def test_a_save_at_n_restores_at_m_bit_for_bit(matrix, n, m):
    saved, restored, _, _ = matrix
    whole = torch_worlds.assemble(saved[n])
    ranks = restored[(n, m)]
    assert len(ranks) == m
    for step, got in ranks:
        assert step == 2
        _assert_pieces_equal(got, whole)


def test_the_reference_reads_a_world_two_checkpoint(matrix):
    """The JAX package's reader restores the port's sharded world-2
    checkpoint: the same files, records and bytes."""
    saved, _, dirs, _ = matrix
    whole = torch_worlds.assemble(saved[2])
    step, flat = JReader(dirs[2], num_hosts=1).load_from_storage()
    assert step == 2
    for path, arr in whole.items():
        if isinstance(arr, np.ndarray):
            np.testing.assert_array_equal(np.asarray(flat[path]), arr)


def test_a_jax_multi_shard_checkpoint_restores_in_the_port(tmp_path):
    """A JAX ZeRO-1 state on a ``data`` 4 mesh saves its optimizer state
    as four shard records a leaf (replica 0 of each) and its parameters
    once; the port reassembles the parameters bit for bit."""
    tiny = torch_worlds.TINY
    cfg = jgpt2_config("124m", **tiny, dtype=jnp.float32)
    train = jtl.build_sharded_train(
        JModel(cfg), jtl.make_optimizer("adamw"),
        build_mesh(ParallelConfig(data=4), devices=jax.devices()[:4]),
        jrules.DEFAULT_RULES, global_batch_size=torch_worlds.BATCH,
        seq_len=torch_worlds.SEQ, zero1=True)
    state = train.init(jax.random.PRNGKey(0))
    state, _ = train.step(state, jtl.shard_batch(torch_worlds.lm_batch(0),
                                                 train))
    ckpt = JCheckpointer(str(tmp_path / "jax"), local_saver=True)
    assert ckpt.save_checkpoint(1, state, JStorageType.DISK)
    assert ckpt.wait(timeout=60)
    ckpt.close()
    meta = JReader(str(tmp_path / "jax"), num_hosts=1)
    step, flat = meta.load_from_storage()
    assert step == 1
    got = load_jax_checkpoint(str(tmp_path / "jax"), gpt2_config(
        "124m", **tiny), device="cpu")
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                               gpt2_config("124m", **tiny))
    for name, w in want.items():
        np.testing.assert_array_equal(got.params[name].numpy(), w.numpy())


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    prev = {k: os.environ.get(k) for k in ("DLROVER_TPU_SOCKET_DIR",)}
    os.environ["DLROVER_TPU_SOCKET_DIR"] = str(root / "socks")
    os.makedirs(root / "socks", exist_ok=True)
    job = f"ch{os.getpid()}"
    try:
        return torch_worlds.run_world(4, torch_worlds.relayout_chain, {
            "ckpt": str(root / "ckpt"), "job": job}, root)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for name in os.listdir("/dev/shm"):
            if job in name:
                os.unlink(os.path.join("/dev/shm", name))


def test_live_relayout_chain_matches_the_storage_reshard(chain):
    """4 -> 2 -> 1 -> 4: after every live re-layout the state is bit for
    bit the state a new trainer restores from storage, the step is never
    rewound, and the fold's grad_accum follows the world (tokens/step
    invariant); a same-world change is a no-op."""
    for rank in chain:
        step, want = rank["restored"]
        assert step == 4
        assert rank["noop"]["noop"] and rank["noop"]["ok"]
        for m, detail, at, physical, accum, got in rank["chain"]:
            assert detail["ok"] and not detail["fallback"]
            assert detail["new_world"] == m == physical
            assert at == 4
            assert accum == jtl.elastic_grad_accum(1, 4, m,
                                                   torch_worlds.BATCH, 4)
            assert set(got) == set(want)
            for path, piece in got.items():
                assert piece[:3] == want[path][:3], path
                np.testing.assert_array_equal(
                    np.asarray(piece[3]), np.asarray(want[path][3]),
                    err_msg="".join(path))


def test_a_failed_relayout_exhausts_its_retries_and_falls_back(chain):
    for rank in chain:
        detail, step, physical, attempts = rank["fallback"]
        assert detail["ok"] and detail["fallback"]
        assert detail["new_world"] == 2 == physical
        # Steps 5-6 ran after the committed step 4: the fallback restores
        # a restorable step (the live shm arena's 6 or storage's 4).
        assert detail["restored_step"] in (4, 6) and step == \
            detail["restored_step"]
        assert attempts == 3  # the RetryPolicy's whole budget

"""Port parity: Flash Checkpoint (``dlrover_tpu_torch.checkpoint``) on the CPU.

After ``tests/test_checkpoint.py`` and the corruption matrix of
``tests/test_faultline.py``: the shm round trip, the memory and disk cycle,
a torn write that stays invisible, the SIGTERM persist path, sparse host
ids, the fall back to the last verified step, the legacy checkpoint with
no digest, and an injected ``storage.write`` fault.  Across the packages:
the port's leaf paths are JAX's ``keystr`` paths, the port restores a
checkpoint that the JAX ``Checkpointer`` wrote for a 2-layer GPT-2 with
bf16 params (``'<V2'`` leaves, the JAX meta pickle read without importing
``dlrover_tpu``) whose logits then match JAX's, and the JAX package reads
the port's bf16 leaves back.

Every test has a job tag and a socket directory of its own, so no two
xdist workers share an arena or a socket.
"""

import collections
import dataclasses
import glob
import os
import pickle
import struct
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint.checkpointer import Checkpointer as JCheckpointer
from dlrover_tpu.checkpoint.checkpointer import StorageType as JStorage
from dlrover_tpu.models.transformer import TransformerConfig as JConfig
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu_torch.checkpoint import shm_handler as tsh
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.from_jax import load_jax_checkpoint
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.storage import (
    CheckpointDirLayout,
    PosixDiskStorage,
)
from dlrover_tpu_torch.models.transformer import TransformerConfig as TConfig
from dlrover_tpu_torch.models.transformer import TransformerLM as TModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """A job tag and socket directory of the test's own; its arenas (the
    port's and the JAX package's, both named after the tag) are removed
    afterwards."""
    job = f"tc{os.getpid()}_{tmp_path.name}"
    monkeypatch.setenv("DLROVER_TPU_JOB", job)
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", str(tmp_path / "socks"))
    faults.reset()
    yield
    faults.reset()
    for path in glob.glob(f"/dev/shm/dlrover_tpu_ckpt_{job}_*"):
        os.unlink(path)


Moment = collections.namedtuple("Moment", "count mu")


@dataclasses.dataclass
class Holder:
    step: int
    w: torch.Tensor


def _state(seed):
    gen = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn((4, 5), generator=gen),
            "b16": torch.randn((3, 8), generator=gen).to(torch.bfloat16),
            "i": torch.arange(6, dtype=torch.int32).reshape(2, 3) * seed,
        },
        "opt": (Moment(count=seed, mu=torch.randn((7,), generator=gen)),
                None, [np.full((2,), 0.5 * seed, np.float32)]),
        "holder": Holder(step=seed, w=torch.zeros((2, 2)) + seed),
        "scalar": torch.tensor(3.5 * seed),
    }


def _assert_trees_equal(got, want):
    gl, wl = (tsh.tree_flatten_with_path(t) for t in (got, want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        if isinstance(w, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == w.dtype, path
            assert torch.equal(g, w), path
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w and type(g) is type(w), path


def _engine(ckpt_dir, **kw):
    kw.setdefault("agree_step_fn", lambda c: c)
    return CheckpointEngine(ckpt_dir, host_index=kw.pop("host_index", 0),
                            num_hosts=kw.pop("num_hosts", 1), device="cpu",
                            **kw)


# -- the arena ------------------------------------------------------------------


def test_paths_and_order_are_jaxs():
    """The port's leaf paths and their order are JAX's ``keystr`` paths of
    the same tree (dict keys sorted, named-tuple fields, None empty)."""
    state = _state(2)
    as_np = {
        "params": {k: v.float().numpy() for k, v in state["params"].items()},
        "opt": (Moment(count=2, mu=state["opt"][0].mu.numpy()), None,
                [state["opt"][2][0]]),
        "scalar": state["scalar"].numpy(),
    }
    want = [tuple(jax.tree_util.keystr([k]) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(as_np)[0]]
    got = [p for p, _ in tsh.tree_flatten_with_path(
        {k: state[k] for k in ("params", "opt", "scalar")})]
    assert got == want
    assert ("['opt']", "[0]", ".count") in got


def test_shm_round_trip_is_bit_exact():
    state = _state(3)
    writer = tsh.SharedMemoryHandler("rt")
    meta = writer.save_state_dict(state, step=9, extra={"rng": [1, 2]})
    assert {t.dtype for t in meta.tensors} >= {"<f4", "<V2", "<i4", "<i8"}
    reader = tsh.SharedMemoryHandler("rt")
    got_meta = reader.load_meta()
    assert got_meta.step == 9 and got_meta.extra == {"rng": [1, 2]}
    arrays = {t.path: tsh.assemble_tensor(
        t, lambda r: reader.load_block(got_meta, r))
        for t in got_meta.tensors}
    got = tsh.tree_map_with_path(
        lambda path, like: (arrays[path].numpy() if isinstance(
            like, np.ndarray) else type(like)(arrays[path].item())
            if isinstance(like, int) else arrays[path]), _state(0))
    _assert_trees_equal(got, state)
    # The views of the arena are gone: both handles close cleanly.
    reader.close()
    writer.close(unlink=True)


def test_torn_write_is_invisible():
    handler = tsh.SharedMemoryHandler("torn")
    handler.save_state_dict({"w": torch.ones(4)}, step=1)
    handler._shm.buf[:8] = struct.pack("<Q", 0)
    assert handler.load_meta() is None
    handler.close(unlink=True)


def test_reader_reattaches_after_arena_growth():
    writer = tsh.SharedMemoryHandler("grow")
    writer.save_state_dict({"w": torch.ones(8)}, step=1)
    reader = tsh.SharedMemoryHandler("grow")
    assert reader.load_meta().step == 1
    writer.save_state_dict({"w": torch.ones(1 << 19), "v": torch.ones(
        1 << 19, dtype=torch.float64)}, step=2)
    assert reader.load_meta().step == 2
    writer.close(unlink=True)
    reader.close()


def test_reader_reattaches_after_an_arena_of_the_same_size_is_recreated():
    """A trainer that unlinks its arena and creates one of the same size
    (a restart) leaves an attached reader (the saver) on the old mapping
    unless the reader checks the file itself, not only its size: the port
    checks the inode (the JAX package's reader compares sizes only)."""
    writer = tsh.SharedMemoryHandler("same")
    writer.save_state_dict({"w": torch.ones(8)}, step=1)
    reader = tsh.SharedMemoryHandler("same")
    assert reader.load_meta().step == 1
    writer.close(unlink=True)
    restarted = tsh.SharedMemoryHandler("same")
    restarted.save_state_dict({"w": torch.full((8,), 2.0)}, step=2)
    assert restarted.size == reader._shm.size
    meta = reader.load_meta()
    assert meta.step == 2
    block = tsh.assemble_tensor(meta.tensors[0],
                                lambda r: reader.load_block(meta, r))
    assert torch.equal(block, torch.full((8,), 2.0))
    restarted.close(unlink=True)
    reader.close()


def test_meta_unpickler_refuses_the_jax_stack():
    ok = pickle.dumps(tsh.CheckpointMeta(1, 0.0, [], {"a": np.ones(2)}))
    assert tsh.loads_meta(ok).step == 1
    for module in ("dlrover_tpu.common.faults", "jax.numpy", "flax.core"):
        # A protocol-4 pickle of the global ``module.Thing``.
        raw = (b"\x80\x04\x8c" + bytes([len(module)]) + module.encode()
               + b"\x94\x8c\x05Thing\x94\x93\x94.")
        with pytest.raises(pickle.UnpicklingError, match="does not import"):
            tsh.loads_meta(raw)


# -- engine and saver -----------------------------------------------------------


def test_memory_and_disk_cycle(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    ckpt = Checkpointer(ckpt_dir, host_index=0, num_hosts=1,
                        local_saver=True, device="cpu")
    s11 = _state(11)
    assert ckpt.save_checkpoint(11, s11, StorageType.MEMORY)
    step, loaded = ckpt.load_checkpoint(state_template=_state(0))
    assert step == 11
    _assert_trees_equal(loaded, s11)

    s12 = _state(12)
    assert ckpt.save_checkpoint(12, s12, StorageType.DISK,
                                extra={"accum": 2})
    assert ckpt.wait(timeout=30)
    assert CheckpointDirLayout(ckpt_dir).latest_step(PosixDiskStorage()) \
        == 12
    ckpt._engine._shm.close(unlink=True)
    fresh = Checkpointer(ckpt_dir, host_index=0, num_hosts=1, device="cpu")
    step, loaded = fresh._engine.load_from_storage(template=_state(0))
    assert step == 12 and fresh._engine.last_restored_extra == {"accum": 2}
    _assert_trees_equal(loaded, s12)
    step, flat = fresh._engine.load_from_storage()
    assert torch.equal(flat[("['params']", "['b16']")], s12["params"]["b16"])
    # A target layout (``shardings``) cuts a leaf to the rank's slice.
    path = ("['params']", "['b16']")
    spot = tsh.LeafLayout((3, 8), ((0, 3), (4, 8)), 0)
    template = _state(0)
    template["params"]["b16"] = template["params"]["b16"][:, 4:].clone()
    step, cut = fresh.load_checkpoint(shardings={path: spot},
                                      state_template=template)
    assert step == 12
    assert torch.equal(cut["params"]["b16"], s12["params"]["b16"][:, 4:])
    with pytest.raises(ValueError, match="whole leaf"):
        fresh.load_checkpoint(
            shardings={path: tsh.LeafLayout((6, 8), ((0, 3), (0, 8)), 0)},
            state_template=_state(0))
    ckpt.close()


def test_template_mismatch_is_refused_not_cast(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ckpt"), host_index=0, num_hosts=1,
                        local_saver=True, device="cpu")
    assert ckpt.save_checkpoint(1, {"w": torch.ones(3, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="template"):
        ckpt.load_checkpoint(state_template={"w": torch.ones(3)})
    with pytest.raises(KeyError):
        ckpt.load_checkpoint(state_template={"v": torch.ones(3)})
    ckpt.close()


def test_saver_sigterm_persist_path(tmp_path):
    """``save_shm_to_storage`` (what the SIGTERM handler runs) persists and
    commits an un-flushed shm step; then a real SIGTERM to a saver process
    with the handler installed persists the arena before the process
    dies."""
    ckpt_dir = str(tmp_path / "ckpt")
    saver = AsyncCheckpointSaver(ckpt_dir, host_index=0, num_hosts=1)
    engine = _engine(ckpt_dir)
    engine.save_to_memory(33, {"w": torch.full((2, 2), 9.0)})
    assert saver.save_shm_to_storage()
    layout = CheckpointDirLayout(ckpt_dir)
    assert layout.latest_step(PosixDiskStorage()) == 33
    saver.stop()

    code = (
        "import os, signal, sys, time\n"
        "from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver\n"
        f"s = AsyncCheckpointSaver({ckpt_dir!r}, host_index=0, num_hosts=1)\n"
        "AsyncCheckpointSaver.register_signal_handlers()\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, env=dict(os.environ))
    assert proc.stdout.readline().strip() == b"ready"
    # The saver process owns the lock now: the trainer's save goes through.
    assert engine.save_to_memory(34, {"w": torch.full((2, 2), 10.0)})
    proc.terminate()
    assert proc.wait(timeout=60) == -15
    assert layout.latest_step(PosixDiskStorage()) == 34
    step, loaded = engine.load_from_storage(template={"w": torch.zeros(2, 2)})
    assert step == 34 and torch.equal(loaded["w"], torch.full((2, 2), 10.0))
    engine.close()
    engine._shm.close(unlink=True)


def test_sparse_host_ids_commit_and_restore(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    savers, engines = {}, {}
    for host in (1, 2):
        savers[host] = AsyncCheckpointSaver(ckpt_dir, host_index=host)
        savers[host].set_world([1, 2])
        savers[host].start()
        engines[host] = _engine(ckpt_dir, host_index=host, num_hosts=2)
    state = {"w": torch.full((2, 2), 5.0)}
    for host in (1, 2):
        assert engines[host].save_to_storage(21, state)
    assert engines[1].wait_saver(timeout=30)
    assert CheckpointDirLayout(ckpt_dir).latest_step(PosixDiskStorage()) \
        == 21
    for host in (1, 2):
        engines[host]._shm.close(unlink=True)
    fresh = _engine(ckpt_dir, host_index=1, num_hosts=2)
    step, loaded = fresh.load(template={"w": torch.zeros(2, 2)})
    assert step == 21 and torch.equal(loaded["w"], state["w"])
    for host in (1, 2):
        savers[host].stop()


def test_world_agreed_step_overrides_newer_shm(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    saver = AsyncCheckpointSaver(ckpt_dir, host_index=0, num_hosts=1)
    saver.start()
    engine = _engine(ckpt_dir, agree_step_fn=lambda c: 10)
    assert engine.save_to_storage(10, {"w": torch.full((3,), 1.0)})
    assert engine.wait_saver(timeout=30)
    assert engine.save_to_memory(30, {"w": torch.full((3,), 3.0)})
    step, loaded = engine.load(template={"w": torch.zeros(3)})
    assert step == 10 and torch.equal(loaded["w"], torch.full((3,), 1.0))
    engine._shm.close(unlink=True)
    saver.stop()


# -- the corruption matrix (tests/test_faultline.py) ----------------------------


def _saved_engine(tmp_path):
    """Two committed steps (10 -> 1.0s, 20 -> 2.0s) on real storage."""
    ckpt_dir = str(tmp_path / "ckpt")
    saver = AsyncCheckpointSaver(ckpt_dir, host_index=0, num_hosts=1)
    saver.start()
    engine = _engine(ckpt_dir)
    for step, value in ((10, 1.0), (20, 2.0)):
        assert engine.save_to_storage(step, {"w": torch.full((3,), value)})
        assert engine.wait_saver(timeout=30)
    return saver, engine, CheckpointDirLayout(ckpt_dir)


def _flip_byte(path, offset=0):
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def _restore(engine):
    engine._shm.close(unlink=True)
    return engine.load_from_storage(template={"w": torch.zeros(3)})


@pytest.mark.parametrize("corrupt", [
    "truncate_data", "bitflip_data", "missing_meta", "bitflip_meta",
    "missing_data",
])
def test_corruption_falls_back_to_the_last_verified_step(tmp_path, corrupt):
    saver, engine, layout = _saved_engine(tmp_path)
    data_path, meta_path = (layout.data_path(20, 0, 1),
                            layout.meta_path(20, 0, 1))
    if corrupt == "truncate_data":
        with open(data_path, "r+b") as f:
            f.truncate(os.path.getsize(data_path) // 2)
    elif corrupt == "bitflip_data":
        _flip_byte(data_path, offset=3)
    elif corrupt == "missing_meta":
        os.remove(meta_path)
    elif corrupt == "bitflip_meta":
        _flip_byte(meta_path, offset=1)
    else:
        os.remove(data_path)
    step, loaded = _restore(engine)
    assert step == 10, f"{corrupt}: landed on {step}, not the verified 10"
    assert torch.equal(loaded["w"], torch.full((3,), 1.0))
    saver.stop()


def test_shard_crc_alone_catches_a_flip(tmp_path):
    """With the digest sidecar gone (legacy), the per-shard crc32 the saver
    stamped still rejects a flipped byte."""
    saver, engine, layout = _saved_engine(tmp_path)
    os.remove(layout.digest_path(20, 0, 1))
    _flip_byte(layout.data_path(20, 0, 1), offset=5)
    step, _ = _restore(engine)
    assert step == 10
    saver.stop()


def test_legacy_checkpoint_without_digest_still_restores(tmp_path):
    saver, engine, layout = _saved_engine(tmp_path)
    os.remove(layout.digest_path(20, 0, 1))
    step, loaded = _restore(engine)
    assert step == 20 and torch.equal(loaded["w"], torch.full((3,), 2.0))
    saver.stop()


def test_injected_write_error_keeps_the_last_verified_step(tmp_path):
    saver, engine, layout = _saved_engine(tmp_path)
    faults.configure("storage.write:error@1")
    assert engine.save_to_storage(30, {"w": torch.full((3,), 3.0)})
    assert not engine.wait_saver(timeout=2)
    assert faults.active().fired == [("storage.write", "error", 1)]
    faults.reset()
    assert layout.latest_step(PosixDiskStorage()) == 20
    step, loaded = _restore(engine)
    assert step == 20 and torch.equal(loaded["w"], torch.full((3,), 2.0))
    saver.stop()


# -- across the packages ----------------------------------------------------------

GPT2 = dict(vocab_size=96, num_layers=2, d_model=64, num_heads=4,
            max_seq_len=48)


def test_port_restores_a_jax_written_gpt2_checkpoint(tmp_path):
    """The JAX ``Checkpointer`` saves a 2-layer GPT-2 with bf16 params (as
    a dict holding ``params`` and a step array); the port restores it from
    storage by path, with ``'<V2'`` leaves read as bf16 and the JAX meta
    pickle read without importing ``dlrover_tpu`` (checked in a fresh
    interpreter); the logits then match JAX's at the fp32 tolerance of
    ``tests/test_torch_transformer.py`` (atol 1e-4)."""
    jcfg = JConfig(**GPT2, param_dtype=jnp.bfloat16, dtype=jnp.float32)
    params = nn.meta.unbox(JModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    leaves = jax.tree_util.tree_leaves(params)
    assert {np.dtype(x.dtype).str for x in leaves} == {"<V2"}
    ckpt_dir = str(tmp_path / "jax_ckpt")
    jckpt = JCheckpointer(ckpt_dir, host_index=0, num_hosts=1,
                          local_saver=True)
    assert jckpt.save_checkpoint(7, {"params": params, "step": jnp.int32(7)},
                                 JStorage.DISK, extra={"seed": 0})
    assert jckpt.wait(timeout=60)
    jckpt.close()

    tcfg = TConfig(**GPT2, param_dtype=torch.bfloat16, dtype=torch.float32)
    restored = load_jax_checkpoint(ckpt_dir, tcfg, device="cpu")
    assert restored.step == 7 and restored.extra == {"seed": 0}
    assert restored.opt_state is None
    assert restored.params["blocks.1.attn.qkv.kernel"].dtype == torch.bfloat16
    model = TModel(tcfg, device="cpu")
    model.load_state_dict(restored.params)
    tokens = np.random.default_rng(7).integers(0, 96, size=(2, 24))
    want = np.asarray(JModel(jcfg).apply({"params": params},
                                         jnp.asarray(tokens))[0], np.float32)
    got = model(torch.as_tensor(tokens)).detach().float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    code = (
        "import sys\n"
        "from dlrover_tpu_torch.checkpoint.from_jax import "
        "load_jax_checkpoint\n"
        "from dlrover_tpu_torch.models.transformer import TransformerConfig\n"
        "import torch\n"
        f"cfg = TransformerConfig(**{GPT2!r}, param_dtype=torch.bfloat16)\n"
        f"r = load_jax_checkpoint({ckpt_dir!r}, cfg, device='cpu')\n"
        "assert r.step == 7\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('dlrover_tpu', 'jax', 'flax'))\n"
        "print('imported:', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert "imported: []" in out.stdout


def test_port_restores_a_jax_low_bit_adam_state(tmp_path):
    """A JAX ``q8_adam`` train state (``.opt_state``'s ``.count``, ``.m``,
    ``.v``, quantized leaves as ``.q``/``.scales``) comes across through
    ``low_bit_state_from_jax``, equal to carrying the live JAX state."""
    from dlrover_tpu.parallel import rules as jrules
    from dlrover_tpu.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu.trainer import train_lib as jtl
    from dlrover_tpu_torch.models.from_jax import low_bit_state_from_jax
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.optimizers import optax_ports as ox

    jcfg = JConfig(**GPT2, param_dtype=jnp.bfloat16)
    train = jtl.build_sharded_train(
        JModel(jcfg), jtl.make_optimizer("q8_adam", learning_rate=1e-3),
        build_mesh(ParallelConfig(), devices=jax.devices()[:1]),
        jrules.DEFAULT_RULES, global_batch_size=2, seq_len=16)
    state = train.init(jax.random.PRNGKey(0))
    ckpt_dir = str(tmp_path / "jax_q8")
    jckpt = JCheckpointer(ckpt_dir, host_index=0, num_hosts=1,
                          local_saver=True)
    assert jckpt.save_checkpoint(3, state, JStorage.DISK)
    assert jckpt.wait(timeout=60)
    jckpt.close()

    tcfg = TConfig(**GPT2, param_dtype=torch.bfloat16)
    restored = load_jax_checkpoint(ckpt_dir, tcfg, device="cpu")
    assert restored.step == 3
    assert isinstance(restored.opt_state, tq.Q8AdamState)
    q8 = jax.tree.map(np.asarray, state.opt_state[1])
    want = low_bit_state_from_jax(q8, ox.stack_layers(restored.params))
    assert restored.opt_state.count == want.count
    for name in want.m:
        for got_m, want_m in ((restored.opt_state.m[name], want.m[name]),
                              (restored.opt_state.v[name], want.v[name])):
            for g, w in zip(tsh.tree_flatten_with_path(got_m),
                            tsh.tree_flatten_with_path(want_m)):
                assert torch.equal(g[1], w[1]), name


def test_jax_reads_the_ports_bf16_leaves(tmp_path):
    """The port writes bf16 as ``'<V2'``, as the JAX package writes its
    own: the JAX ``Checkpointer`` reads the port's checkpoint back as it
    reads its own bf16 leaves (raw two-byte values, which view as
    ``bfloat16``) with the same bits."""
    ckpt_dir = str(tmp_path / "ckpt")
    ckpt = Checkpointer(ckpt_dir, host_index=0, num_hosts=1,
                        local_saver=True, device="cpu")
    w = torch.randn((4, 6), generator=torch.Generator().manual_seed(5)).to(
        torch.bfloat16)
    assert ckpt.save_checkpoint(4, {"w": w, "n": torch.arange(3)},
                                StorageType.DISK)
    assert ckpt.wait(timeout=30)
    ckpt.close()
    ckpt._engine._shm.close(unlink=True)
    jckpt = JCheckpointer(ckpt_dir, host_index=0, num_hosts=1)
    step, loaded = jckpt._engine.load_from_storage(
        treedef=jax.tree_util.tree_structure({"w": 0, "n": 0}))
    raw = np.asarray(loaded["w"])
    assert step == 4 and raw.dtype.itemsize == 2 and raw.dtype.kind == "V"
    np.testing.assert_array_equal(raw.view(np.int16),
                                  w.view(torch.int16).numpy())
    assert raw.view(jnp.bfloat16).dtype == jnp.bfloat16
    np.testing.assert_array_equal(loaded["n"], np.arange(3))


@pytest.mark.parametrize("optimizer", ["adafactor", "q8_adam"])
def test_train_state_round_trip_continues_the_uninterrupted_run(tmp_path,
                                                               optimizer):
    """``chip_smoke.py``'s ``flash_ckpt`` path at a small size on the CPU:
    a 2-layer GPT-2 train state (``TrainState.checkpoint_tree``: the
    params and an Adafactor or q8 Adam state, python ints and
    ``QMoment`` named tuples among its leaves) saved to shm and to disk,
    restored from each into a fresh state's tree, is equal leaf for leaf,
    and ``Train.restore`` then takes the next step with the uninterrupted
    run's loss exactly."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib

    cfg = gpt2_config("124m", num_layers=2, d_model=64, num_heads=4,
                      vocab_size=128, max_seq_len=32, dtype=torch.float32,
                      attention_impl="flash", remat="flash_only")
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer(optimizer, learning_rate=1e-3,
                                      min_quant_size=512)
        if optimizer == "q8_adam" else train_lib.make_optimizer(
            optimizer, learning_rate=1e-3),
        global_batch_size=4, seq_len=16, device="cpu")
    tokens = np.random.default_rng(3).integers(0, 128, size=(4, 17))
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    state = train.init(seed=0)
    for _ in range(2):
        state, _ = train.step(state, batch)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), host_index=0, num_hosts=1,
                        local_saver=True, device="cpu")
    saved = tsh.tree_map_with_path(
        lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x,
        state.checkpoint_tree())
    assert ckpt.save_checkpoint(state.step, state.checkpoint_tree(),
                                StorageType.DISK)
    assert ckpt.wait(timeout=30)
    state, want = train.step(state, batch)
    reader = CheckpointEngine(str(tmp_path / "ckpt"), host_index=0,
                              num_hosts=1, device="cpu")
    for load in (lambda t: ckpt.load_checkpoint(state_template=t),
                 lambda t: reader.load_from_storage(template=t)):
        step, tree = load(train.init(seed=1).checkpoint_tree())
        assert step == 2
        _assert_trees_equal(tree, saved)
        restored, got = train.step(train.restore(step, tree), batch)
        assert restored.step == 3
        assert got["loss"].item() == want["loss"].item()
    ckpt.close()

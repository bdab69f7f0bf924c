"""Port parity: Local SGD (``dlrover_tpu_torch/parallel/local_sgd.py``) and
its transports (``quantized_collectives.process_allgather`` and
``quantized_process_allgather``) against the reference
(``dlrover_tpu/parallel/local_sgd.py``, its ``quantized_process_allgather``
format).

A spawned gloo world of 2: each rank is a replica that moves its
parameters by its own seeded steps, with the outer sync on the world's
wire (fp, or int8 through the plain versions of K5a and K5b on the CPU).
The reference runs both replicas in one process, fed by an in-process
fabric as ``tests/test_local_sgd.py`` feeds it: the fp fabric hands every
replica both deltas; the int8 fabric puts each delta through the
reference's own block quantization and dequantization, leaf by leaf, as
its multi-host path does.  Held bit for bit: the replicas agree after
every sync, the port equals the reference (the same float32 operations
in the same order: ``sum(ls) / len``, the consensus counts, the momentum,
and codes that round alike), a replica resumed from ``state_dict``
continues identically, and the wire carries exactly the bytes the shapes
give (``process_allgather_bytes``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from dlrover_tpu.parallel import local_sgd as jls
from dlrover_tpu.parallel import quantized_collectives as jqc
from dlrover_tpu_torch.parallel import local_sgd as tls
from dlrover_tpu_torch.parallel import quantized_collectives as tqc

CASES = [
    ("average_fp", dict(sync_every=2, outer_momentum=0.9), 6),
    ("gta_int8", dict(sync_every=2, outer_momentum=0.0, method="gta",
                      quantized_comm=True), 6),
    ("average_int8", dict(sync_every=3, outer_momentum=0.5, outer_lr=0.7,
                          quantized_comm=True), 6),
    ("gta_fp_threshold", dict(sync_every=2, outer_momentum=0.9,
                              method="gta", gta_threshold=0.5), 4),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_worlds.run_world(
        2, torch_worlds.run_local_sgd, {"cases": CASES},
        tmp_path_factory.mktemp("lsgd"))


def _int8_fabric(delta, block=256):
    """The reference's quantized_process_allgather, one replica's leaf
    payload quantized and dequantized as its multi-host path does."""
    out = {}
    for k, leaf in delta.items():
        flat = jnp.asarray(leaf, jnp.float32).reshape(-1)
        padded = -(-flat.size // block) * block
        q, s = jqc._block_quant(jnp.pad(flat, (0, padded - flat.size)),
                                block)
        deq = jqc._block_dequant(q, s, block)
        out[k] = deq[:flat.size].reshape(leaf.shape).astype(leaf.dtype)
    return out


def _reference(kw, steps):
    """Both replicas through the reference: per sync, each replica's
    parameters."""
    outers = [jls.LocalSGD(jls.LocalSGDConfig(**kw)) for _ in range(2)]
    params = [{k: jnp.asarray(v) for k, v in torch_worlds.lsgd_params()
               .items()} for _ in range(2)]
    for r in range(2):
        outers[r].init(params[r])
    gathered = []
    for r in range(2):
        outers[r].allgather_fn = lambda d: list(gathered)
    syncs = [[], []]
    for step in range(steps):
        for r in range(2):
            move = torch_worlds.lsgd_step(r, step)
            params[r] = {k: p + jnp.asarray(move[k])
                         for k, p in params[r].items()}
        deltas = [jax.tree.map(lambda p, a: p - a, params[r],
                               outers[r]._anchor) for r in range(2)]
        if kw.get("quantized_comm"):
            deltas = [_int8_fabric(d) for d in deltas]
        gathered[:] = deltas
        for r in range(2):
            params[r], synced = outers[r].maybe_sync(params[r])
            if synced:
                syncs[r].append({k: np.asarray(v)
                                 for k, v in params[r].items()})
    return syncs


@pytest.mark.parametrize("key,kw,steps", CASES, ids=[c[0] for c in CASES])
def test_outer_syncs_match_the_reference(ranks, key, kw, steps):
    want = _reference(kw, steps)
    numels = [int(np.prod(s)) for s in torch_worlds.LSGD_SHAPES.values()]
    quant = "int8" if kw.get("quantized_comm") else "none"
    assert len(want[0]) == steps // kw["sync_every"] >= 2
    for r in range(2):
        syncs = ranks[r][key]["syncs"]
        assert len(syncs) == len(want[r])
        for got, ref, other in zip(syncs, want[r], ranks[1 - r][key]["syncs"]):
            for k in ref:
                np.testing.assert_array_equal(got["params"][k], ref[k], k)
                np.testing.assert_array_equal(got["params"][k],
                                              other["params"][k], k)
            assert got["bytes"] == {"all_gather": tqc.process_allgather_bytes(
                numels, quant)}


@pytest.mark.parametrize("key", [c[0] for c in CASES])
def test_a_replica_resumes_from_its_state_dict(ranks, key):
    for r in range(2):
        out = ranks[r][key]
        for k in out["final"]:
            np.testing.assert_array_equal(out["resumed"][k], out["final"][k])


def test_world_one_returns_the_tree_itself():
    tree = {"w": torch.randn(3, 300), "b": torch.randn(5)}
    for gather in (tqc.quantized_process_allgather, tqc.process_allgather):
        out = gather(tree)
        assert len(out) == 1 and all(out[0][k] is tree[k] for k in tree)
    outer = tls.LocalSGD(tls.LocalSGDConfig(sync_every=1, outer_momentum=0.0,
                                            quantized_comm=True))
    outer.init({"w": torch.zeros(4)})
    params, synced = outer.maybe_sync({"w": torch.full((4,), 0.5)})
    assert synced and torch.equal(params["w"], torch.full((4,), 0.5))


def test_quantized_payload_equals_the_references_format():
    """One replica's int8 round trip (K5a/K5b's plain versions) against
    the reference's block quantization of the same padded leaf."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((7, 100)).astype(np.float32),
            "b": rng.standard_normal((256,)).astype(np.float32)}
    want = _int8_fabric({k: jnp.asarray(v) for k, v in tree.items()})
    # The same arithmetic as the wire path: quantize, then dequantize.
    for k, v in tree.items():
        flat = torch.from_numpy(v).reshape(-1)
        padded = -(-flat.numel() // 256) * 256
        q, s = tqc._block_quant(torch.nn.functional.pad(
            flat, (0, padded - flat.numel())), 256)
        got = tqc._block_dequant(q, s, 256)[:flat.numel()].reshape(v.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[k]))
    assert tqc.process_allgather_bytes([700, 256], "int8") == \
        4 * 256 + 4 * 4
    assert tqc.process_allgather_bytes([700, 256]) == 956 * 4


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_reducers_match_the_reference(threshold):
    rng = np.random.default_rng(9)
    deltas = [{"w": rng.standard_normal((4, 33)).astype(np.float32)}
              for _ in range(3)]
    deltas[1]["w"][0] = 0.0  # zero votes: no consensus on some values
    jd = [{k: jnp.asarray(v) for k, v in d.items()} for d in deltas]
    td = [{k: torch.from_numpy(v) for k, v in d.items()} for d in deltas]
    np.testing.assert_array_equal(
        tls.gta_reduce(td, threshold)["w"].numpy(),
        np.asarray(jls.gta_reduce(jd, threshold)["w"]))
    np.testing.assert_array_equal(tls.average_reduce(td)["w"].numpy(),
                                  np.asarray(jls.average_reduce(jd)["w"]))


def test_outer_momentum_and_schedule_match_the_reference():
    """In one process, a fabric of two mirror replicas (the reference's
    own test shape): syncs on schedule, momentum accumulated alike."""
    cfg = dict(sync_every=3, outer_lr=0.8, outer_momentum=0.5)
    outer = tls.LocalSGD(tls.LocalSGDConfig(**cfg),
                         allgather_fn=lambda d: [d, {k: 2 * v for k, v in
                                                     d.items()}])
    ref = jls.LocalSGD(jls.LocalSGDConfig(**cfg),
                       allgather_fn=lambda d: [d, jax.tree.map(
                           lambda v: 2 * v, d)])
    tp, jp = {"w": torch.zeros(3)}, {"w": jnp.zeros(3)}
    outer.init(tp)
    ref.init(jp)
    for step in range(1, 10):
        tp = {"w": tp["w"] + 1.0}
        jp = {"w": jp["w"] + 1.0}
        tp, ts = outer.maybe_sync(tp)
        jp, js = ref.maybe_sync(jp)
        assert ts == js == (step % 3 == 0)
        np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))

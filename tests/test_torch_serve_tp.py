"""Port parity: tensor-parallel serving (``serving/tp.py``, the TP branches
of ``serving/decode.py`` and ``serving/engine.py``, ``fold_tp``) against
the JAX serving plane.

* The fold's units: ``fold_width``, ``validate_tp_config`` naming the
  failing dimension, ``logical_shape`` kept across a fold, the program
  memo's key changing with ``(logical, physical)``, and a speculating
  pair refusing a draft at another tp with the reference's message.
* In a spawned gloo world of 2 on the CPU, a small Llama with GQA (2
  layers, d 64, 4 heads, 2 KV heads, vocab 128; fp32, JAX init carried
  across): the greedy streams at ``tp=2`` equal the JAX
  ``ServingEngine(tp=2)``'s on 2 virtual devices and the port's at tp=1
  token for token, with logprobs within ``LOGP_ATOL`` (1e-5: the
  row-parallel sums and the vocab gather reassociate fp32 sums); both
  ranks emit the same streams, sampled ones too; each rank's KV pool
  holds 1 of the 2 KV heads and at most 0.5 x 1.15 of tp=1's bytes, as
  the reference's test holds them.
* A fold 2 -> 1 -> 2 mid-serve loses no request and keeps the streams:
  rank 1 is parked at 1 and takes its shards and rank 0's scheduler
  state back at 2.
* Disaggregated prefill at tp=2 (pages of local heads), and a live
  ``swap_weights`` of each rank's slices with a fold-wide vote.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from dlrover_tpu.models.llama import llama_config as jllama_config
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.rl.generation import SamplingParams as JSampling
from dlrover_tpu.serving import Request as JRequest
from dlrover_tpu.serving import ServingEngine as JEngine
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.serving import (
    ServingEngine,
    ServeTPMesh,
    build_tp_mesh,
    clear_programs,
    fold_width,
    get_programs,
    get_spec_programs,
)
from dlrover_tpu_torch.serving.tp import validate_tp_config

LOGP_ATOL = 1e-5
KV_SHARE = 0.5 * 1.15


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama_config("tiny", **torch_worlds.SERVE_LLAMA,
                         dtype=jnp.float32)
    params = jax.tree.map(np.asarray, nn.meta.unbox(JModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]))
    state = {k: v.numpy() for k, v in state_dict_from_jax(
        params, torch_worlds.serve_config()).items()}
    return jcfg, params, state


@pytest.fixture(scope="module")
def swap_state():
    from dlrover_tpu_torch.models import init_params

    return init_params(torch_worlds.serve_config(), seed=1, device="cpu")


@pytest.fixture(scope="module")
def world(setup, swap_state, tmp_path_factory):
    """The world's results; before it, a seed-1 state saved through
    Flash Checkpoint for the swap (``serve_tp_swap``)."""
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    root = tmp_path_factory.mktemp("serve_tp")
    swap_dir = str(root / "swap")
    saver = AsyncCheckpointSaver(swap_dir, host_index=0, num_hosts=1)
    saver.start()
    ckpt = CheckpointEngine(swap_dir, host_index=0, num_hosts=1,
                            agree_step_fn=lambda c: c, device="cpu")
    try:
        assert ckpt.save_to_storage(7, {"params": swap_state})
        assert ckpt.wait_saver(timeout=60)
        return torch_worlds.run_world(
            2, torch_worlds.run_serve_tp,
            {"state": setup[2], "swap_dir": swap_dir}, root)
    finally:
        ckpt._shm.close(unlink=True)
        saver.stop()


@pytest.fixture(scope="module")
def plain(setup):
    """The port's tp=1 streams and KV bytes."""
    state = {k: torch.from_numpy(v) for k, v in setup[2].items()}
    engine = ServingEngine(torch_worlds.serve_config(), state,
                           slots=torch_worlds.SERVE_SLOTS,
                           buckets=torch_worlds.SERVE_BUCKETS, seed=0,
                           device="cpu")
    streams = torch_worlds._streams(engine.run(torch_worlds.serve_requests()))
    return streams, engine.kv_device_bytes()


def _same(got, want):
    assert set(got) == set(want)
    for uid, (tokens, logps) in want.items():
        assert got[uid][0] == tokens, uid
        np.testing.assert_allclose(got[uid][1], logps, rtol=0,
                                   atol=LOGP_ATOL, err_msg=uid)


# -- the fold's units ----------------------------------------------------------


def test_fold_width_largest_fitting_divisor():
    assert fold_width(4, 8) == 4
    assert fold_width(4, 3) == 2
    assert fold_width(4, 1) == 1
    assert fold_width(6, 4) == 3
    with pytest.raises(ValueError):
        fold_width(0, 4)


@pytest.mark.parametrize("overrides,name", [
    (dict(num_heads=3, num_kv_heads=3, d_model=48), "num_heads"),
    (dict(num_kv_heads=1), "num_kv_heads"),
    (dict(vocab_size=127), "vocab_size"),
    (dict(d_ff=129), "d_ff"),
], ids=["heads", "kv_heads", "vocab", "d_ff"])
def test_validate_tp_config_names_the_failing_dimension(overrides, name):
    from dlrover_tpu_torch.models import llama_config

    cfg = llama_config("tiny", **{**torch_worlds.SERVE_LLAMA, **overrides})
    with pytest.raises(ValueError, match=name):
        validate_tp_config(cfg, 2)
    validate_tp_config(torch_worlds.serve_config(), 2)


def test_a_fold_keeps_the_logical_shape():
    tp = build_tp_mesh(4)  # one process: the logical 4 folds onto it
    assert isinstance(tp, ServeTPMesh)
    assert (tp.logical_tp, tp.physical_tp, tp.fold) == (4, 1, 4)
    folded = ServeTPMesh(4, 2).fold_to(1)
    assert (folded.logical_tp, folded.physical_tp) == (4, 1)
    assert ServeTPMesh(4, 2).logical_shape == tp.logical_shape == \
        folded.logical_shape == (1, 1, 1, 1, 1, 4)
    with pytest.raises(ValueError, match="must divide"):
        ServeTPMesh(4, 3)


def test_the_memo_key_carries_logical_and_physical():
    clear_programs()
    cfg = torch_worlds.serve_config()

    def programs(tp):
        return get_programs(cfg, 2, (16,), device="cpu", tp=tp)

    plain, a, b = programs(None), programs(ServeTPMesh(2, 1)), \
        programs(ServeTPMesh(2, 2))
    assert len({plain.cache_key, a.cache_key, b.cache_key}) == 3
    assert a.cache_key[-1] == (2, 1) and plain.cache_key[-1] == ()
    assert programs(ServeTPMesh(2, 1)) is a  # a fold back is a memo hit
    assert ServeTPMesh(2, 2).logical_shape == ServeTPMesh(2, 1).logical_shape
    clear_programs()


def test_a_draft_at_another_tp_is_refused():
    clear_programs()
    cfg = torch_worlds.serve_config()
    target = get_programs(cfg, 2, (16,), device="cpu", tp=ServeTPMesh(2, 1))
    draft = get_programs(cfg, 2, (16,), device="cpu")
    with pytest.raises(ValueError, match=r"draft tp \(\) != target tp "
                       r"\(2, 1\): the draft shares the TP decode path"):
        get_spec_programs(target, draft, 3)
    clear_programs()


# -- a world of 2 ----------------------------------------------------------------


def test_tp2_greedy_streams_equal_the_jax_tp2_engine_and_tp1(setup, world,
                                                             plain):
    jcfg, params, _ = setup
    engine = JEngine(jcfg, params, slots=torch_worlds.SERVE_SLOTS,
                     buckets=torch_worlds.SERVE_BUCKETS, seed=0, tp=2,
                     tp_devices=2)
    want = engine.run([JRequest(r.uid, r.prompt, sampling=JSampling(
        max_new_tokens=r.sampling.max_new_tokens, temperature=0.0))
        for r in torch_worlds.serve_requests()])
    want = {u: (r.tokens.tolist(), r.logprobs.tolist())
            for u, r in want.items()}
    for rank in world:
        _same(rank["streams"], want)
        _same(rank["streams"], plain[0])
    # Every rank drew the same sampled tokens.
    assert world[0]["sampled"] == world[1]["sampled"]
    sampled = world[0]["sampled"]
    assert sorted(sampled) == [f"s{i}" for i in range(
        len(torch_worlds.SERVE_GREEDY))]
    for i, (_, n) in enumerate(torch_worlds.SERVE_GREEDY):
        assert len(sampled[f"s{i}"][0]) == n
        assert all(0 <= t < torch_worlds.SERVE_LLAMA["vocab_size"]
                   for t in sampled[f"s{i}"][0])


def test_tp2_kv_pool_bytes_halve(world, plain):
    for rank in world:
        assert rank["local_kv_heads"] == 1
        assert rank["kv_bytes"] == max(r["own_kv_bytes"] for r in world)
        assert rank["kv_bytes"] < plain[1]
        assert rank["kv_bytes"] <= plain[1] * KV_SHARE
    # Two sums a layer a step and the lookup's, one logits gather a step.
    assert set(world[0]["wire"]) == {"tensor/all_reduce",
                                     "tensor/all_gather"}


def test_fold_2_1_2_mid_serve_keeps_every_request_and_stream(world, plain):
    r0, r1 = world
    assert (r0["folded"]["parked"], r1["folded"]["parked"]) == (False, True)
    assert r0["folded"]["model"] and not r1["folded"]["model"]
    assert r0["folded"]["physical"] == r1["folded"]["physical"] == 1
    # At a fold of 1 rank 0 holds the whole pool.
    assert r0["folded"]["kv_bytes"] == plain[1]
    for rank in world:
        assert rank["unfolded"] == {"parked": False, "physical": 2,
                                    "local_kv_heads": 1}
        _same(rank["fold_streams"], plain[0])


def test_tp2_pages_carry_local_heads(world, plain):
    """Disaggregated prefill at tp=2: each rank's prefill engine puts
    pages of its own KV heads (half a tp=1 page's bytes) on its outbox,
    the same rank's decode engine takes them, and the streams equal
    tp=1's."""
    want = {"d" + u[1:]: v for u, v in plain[0].items()}
    cfg = torch_worlds.serve_config()
    whole = 2 * cfg.num_layers * cfg.max_seq_len * cfg.resolved_kv_heads \
        * cfg.resolved_head_dim * 4
    for rank in world:
        assert rank["page_heads"] == [1]
        assert rank["page_bytes"] == [whole // 2] * len(want)
        _same(rank["page_streams"], want)


def test_tp2_swap_weights_swaps_each_ranks_slices(world, swap_state):
    """``swap_weights`` at tp=2 with a request live: each rank lands its
    own slices of the seed-1 checkpoint and checks its digest against its
    own host copy of them; the live request finishes, and the streams
    after the swap equal a tp=1 engine's on the new weights.
    A flipped bit on rank 1 alone rolls both ranks back (the fold votes),
    leaving the new weights in place."""
    from dlrover_tpu_torch.models.transformer import (
        TransformerLM,
        param_logical_axes,
        param_shapes,
    )
    from dlrover_tpu_torch.parallel import sharding
    from dlrover_tpu_torch.runtime.mesh import MESH_AXES
    from dlrover_tpu_torch.serving import hotswap
    from dlrover_tpu_torch.serving.decode import decode_config
    from dlrover_tpu_torch.serving.tp import SERVE_TP_RULES

    cfg = decode_config(torch_worlds.serve_config())
    sizes = dict.fromkeys(MESH_AXES, 1)
    sizes["tensor"] = 2
    layouts = sharding.leaf_layouts(
        param_logical_axes(TransformerLM(cfg, device="meta")),
        param_shapes(cfg), SERVE_TP_RULES, sizes)
    fresh = ServingEngine(torch_worlds.serve_config(), swap_state,
                          slots=torch_worlds.SERVE_SLOTS,
                          buckets=torch_worlds.SERVE_BUCKETS, seed=0,
                          device="cpu")
    want = torch_worlds._streams(fresh.run(
        torch_worlds.serve_requests(prefix="w")))
    for rank, got in enumerate(world):
        coords = dict.fromkeys(MESH_AXES, 0)
        coords["tensor"] = rank
        mine = {n: lay.take(swap_state[n], coords, sizes).contiguous()
                for n, lay in layouts.items()}
        assert got["swap"] == {
            "ok": True, "rolled_back": False, "version": 1, "step": 7,
            "digest": f"{hotswap.host_digest(mine):08x}"}
        # The request live across the swap finishes its tokens.
        live = got["swap_streams"].pop("v0")
        assert len(live[0]) == torch_worlds.SERVE_GREEDY[0][1]
        _same(got["swap_streams"], want)
        assert got["swap_fault"]["ok"] is False
        assert got["swap_fault"]["rolled_back"] is True
        assert got["swap_fault"]["version"] == 1
        for name, t in mine.items():
            np.testing.assert_array_equal(got["params_after"][name],
                                          t.numpy(), err_msg=name)

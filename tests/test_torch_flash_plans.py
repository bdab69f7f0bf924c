"""The host side of the Hopper kernels K1, K3, K2a, K2b and K11 on the
CPU: their launch plans, pure functions of the shapes, on every shape that
``chip_smoke.py`` runs the kernels at (``KERNEL_CASES`` for K1,
``BWD_CASES`` for K3, K2a and K2b, ``pin_kernel_check``'s views for K11),
numpy mirrors of K2a's kv walk, the split path's one pre-pass, and the
delta pre-pass's plain version against ``rowsum(o * do)`` from the JAX
package's own forward.  The kernels themselves run only on the card,
where ``chip_smoke.py`` holds them against the plain versions.
"""

import importlib.util
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import kernel_lib
from dlrover_tpu_torch.ops import layout_pin as tpin


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
FWD = {c["case"]: c for c in CS.KERNEL_CASES}
BWD = {c["case"]: c for c in CS.BWD_CASES}


@pytest.mark.parametrize("name", sorted(FWD))
def test_forward_plan_covers_every_row_and_fills_the_card(name):
    c = FWD[name]
    b, s, hq, d = c["b"], c["s"], c["hq"], c["d"]
    plan = tfa.fwd_launch_plan(b, s, hq, d)
    bm = plan["block_m"]
    # 128-row tiles where they give at least one block per SM.
    assert bm == (128 if b * hq * math.ceil(s / 128) >= 132 else 64)
    assert plan["grid"] == (b * hq, math.ceil(s / bm))
    tiles = plan["grid"][1]
    assert (tiles - 1) * bm < s <= tiles * bm
    assert plan["q_box"] == (64, 1, bm, 1)
    assert plan["kv_box"] == (64, 1, tfa.MASK_TILE, 1)
    assert plan["boxes_per_row"] * 64 == d


def test_forward_plan_at_the_main_path_shapes():
    train = tfa.fwd_launch_plan(16, 1024, 25, 64)
    assert train["block_m"] == 128 and train["grid"] == (400, 8)
    serve = tfa.fwd_launch_plan(1, 512, 25, 64)  # 100 blocks of 128 rows
    assert serve["block_m"] == 64 and serve["grid"] == (25, 8)
    assert tfa.fwd_launch_plan(1, 512, 25, 64, num_sms=100)["block_m"] == 128


@pytest.mark.parametrize("name", sorted(BWD))
def test_backward_plan_covers_every_kv_row_and_stat_row(name):
    c = BWD[name]
    b, s, hq, hkv, d = c["b"], c["s"], c["hq"], c["hkv"], c["d"]
    plan = tfa.bwd_launch_plan(b, s, s, hq, hkv, d)
    bkv = plan["block_kv"]
    assert bkv == (128 if d == 64 else 64)
    assert plan["grid"] == (b * hkv, math.ceil(s / bkv))
    tiles = plan["grid"][1]
    assert (tiles - 1) * bkv < s <= tiles * bkv
    assert plan["q_box"] == (64, 1, tfa.MASK_TILE, 1)
    assert plan["kv_box"] == (64, 1, bkv, 1)
    assert plan["boxes_per_row"] * 64 == d
    pad = plan["sq_pad"]
    assert pad % tfa.MASK_TILE == 0 and s <= pad < s + tfa.MASK_TILE
    rows_per_block = 256 // (d // 8)
    assert (plan["prep_grid"] - 1) * rows_per_block < b * pad * hq
    assert b * pad * hq <= plan["prep_grid"] * rows_per_block


def test_backward_plan_at_the_training_shape():
    plan = tfa.bwd_launch_plan(16, 1024, 1024, 25, 25, 64)
    assert plan["grid"] == (400, 8) and plan["block_kv"] == 128
    assert plan["sq_pad"] == 1024 and plan["prep_grid"] == 12800
    gqa = tfa.bwd_launch_plan(1, 2048, 2048, 32, 8, 128)
    assert gqa["block_kv"] == 64 and gqa["grid"] == (8, 32)
    ragged = tfa.bwd_launch_plan(1, 1000, 1000, 25, 25, 64)
    assert ragged["sq_pad"] == 1024 and ragged["grid"] == (25, 8)


@pytest.mark.parametrize("hq,hkv,causal", [(4, 4, True), (8, 2, False)])
def test_delta_reference_matches_rowsum_of_the_jax_forward(hq, hkv, causal):
    rng = np.random.default_rng(3)
    b, s, d = 2, 100, 64
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    o = jfa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal, block_q=64, block_kv=64)
    want = np.asarray(jnp.sum(o * jnp.asarray(do), axis=-1)).transpose(
        0, 2, 1)
    got = tfa.delta_reference(torch.tensor(np.asarray(o)),
                              torch.as_tensor(do))
    assert got.shape == (b, hq, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- K2b: the kv-tile kernel without dq --------------------------------------


def _kv_rows_covered(plan, b, skv, hkv):
    """How often the kernel of ``plan`` writes each (b, kv row, kv head):
    block (x, y) = (b * hkv + hk, kv tile), warpgroup wg its 64 rows."""
    hits = np.zeros((b, skv, hkv), dtype=np.int64)
    for x in range(plan["grid"][0]):
        for y in range(plan["grid"][1]):
            for wg in range(plan["block_kv"] // tfa.MASK_TILE):
                n0w = y * plan["block_kv"] + wg * tfa.MASK_TILE
                rows = np.arange(n0w, min(n0w + tfa.MASK_TILE, skv))
                hits[x // hkv, rows, x % hkv] += 1
    return hits


def _stat_rows_read(plan, sq, hq, hkv, causal):
    """How often one kv-row tile of each block reads each lse / delta row
    (b, q head, q row < sq): the (q head, q tile) pairs of its loop."""
    group = hq // hkv
    reads = np.zeros((plan["grid"][0], plan["grid"][1], hq, plan["sq_pad"]),
                     dtype=np.int64)
    for y in range(plan["grid"][1]):
        q_begin = y * plan["block_kv"] if causal else 0
        n_qt = -(-(sq - q_begin) // tfa.MASK_TILE) if q_begin < sq else 0
        for x in range(plan["grid"][0]):
            hk = x % hkv
            for i in range(group * n_qt):
                h = hk * group + i // n_qt
                q0 = q_begin + (i % n_qt) * tfa.MASK_TILE
                reads[x, y, h, q0:q0 + tfa.MASK_TILE] += 1
    return reads


def _prep_rows_written(plan, b, hq, d):
    """How often the pre-pass writes each lse / delta row (b, s, h), s <
    sq_pad: thread part 0 of each row of each block."""
    rows_per_block = 256 // (d // 8)
    row = np.arange(plan["prep_grid"] * rows_per_block)
    row = row[row < b * plan["sq_pad"] * hq]
    return np.bincount(row, minlength=b * plan["sq_pad"] * hq)


@pytest.mark.parametrize("name", sorted(BWD))
def test_dkv_plan_covers_every_kv_row_and_stat_row_once(name):
    """K2b's plan on every ``BWD_CASES`` shape (``check_bwd_case`` runs
    each through the split path): every kv row of every (b, kv head) is one
    warpgroup's, once; the pre-pass writes every lse / delta row once; and
    a block reads the row of every q head of its group and every q row it
    can see (from its tile's diagonal on under causal masking) once."""
    c = BWD[name]
    b, s, hq, hkv, d = c["b"], c["s"], c["hq"], c["hkv"], c["d"]
    plan = tfa.bwd_launch_plan(b, s, s, hq, hkv, d, kind="dkv")
    assert plan["kind"] == "dkv" and plan["boxes_per_row"] * 64 == d
    assert plan["block_kv"] == tfa.MASK_TILE
    assert plan["blocks_per_sm"] == (2 if d == 64 else 1)
    assert plan["kv_box"] == (64, 1, plan["block_kv"], 1)
    assert plan["q_box"] == (64, 1, tfa.MASK_TILE, 1)
    assert plan["stages"] == tfa.BWD_STAGES["dkv"] == 4
    assert (_kv_rows_covered(plan, b, s, hkv) == 1).all()
    assert (_prep_rows_written(plan, b, hq, d) == 1).all()
    reads = _stat_rows_read(plan, s, hq, hkv, c["causal"])
    group = hq // hkv
    for x in range(plan["grid"][0]):
        for y in range(plan["grid"][1]):
            q_begin = y * plan["block_kv"] if c["causal"] else 0
            want = np.zeros((hq, plan["sq_pad"]), dtype=np.int64)
            heads = slice((x % hkv) * group, (x % hkv + 1) * group)
            want[heads, q_begin:s] = 1
            assert (reads[x, y, :, :s] == want[:, :s]).all()


@pytest.mark.parametrize("d", [64, 128])
def test_dkv_workspace_holds_no_dq_accumulator(d):
    """K2b's workspace is the pre-pass's lse / delta rows alone; K3's adds
    the fp32 dq accumulator."""
    dkv = tfa.bwd_launch_plan(2, 1000, 1000, 8, 2, d, kind="dkv")
    fused = tfa.bwd_launch_plan(2, 1000, 1000, 8, 2, d)
    assert dkv["workspace"] == {"rows": (2, 2, 8, 1024)}
    assert fused["workspace"] == {"rows": (2, 2, 8, 1024),
                                  "dq_acc": (2, 1000, 8, d)}
    for key in ("sq_pad", "prep_grid", "q_box"):
        assert dkv[key] == fused[key]
    with pytest.raises(ValueError, match="no kv-tile"):
        tfa.bwd_launch_plan(2, 1000, 1000, 8, 2, d, kind="dq")


def _build_table(macro):
    """The rows of a build table of ``flash_bwd_bf16`` (``DQ_BUILD`` or
    ``KV_BUILD``), as tuples of ints."""
    src = open(os.path.join(os.path.dirname(tfa.__file__), "csrc",
                            "flash_attention_bwd.cu")).read()
    entry = src[src.index('extern "C" int flash_bwd_bf16('):]
    rows = re.findall(rf"^  {macro}\(([\d, ]+)\)$", entry, re.M)
    assert rows, macro
    return {tuple(int(v) for v in row.split(",")) for row in rows}


def test_kv_tile_plans_are_builds_of_the_kernel_source():
    """Every plan the K3 and K2b wrappers make names a (kind, head dim,
    warpgroups, stages, blocks an SM, shared-memory bytes) of the source's
    ``KV_BUILD`` table, which ``flash_bwd_bf16`` dispatches on (it refuses
    any other; a static_assert holds each row's bytes to the kernel's
    layout)."""
    builds = _build_table("KV_BUILD")
    for c in CS.BWD_CASES:
        for kind, code in (("fused", 2), ("dkv", 1)):
            plan = tfa.bwd_launch_plan(c["b"], c["s"], c["s"], c["hq"],
                                       c["hkv"], c["d"], kind=kind)
            row = (code, c["d"], plan["block_kv"] // tfa.MASK_TILE,
                   plan["stages"], plan["blocks_per_sm"], plan["smem_bytes"])
            assert row in builds, row


# -- K2a: the q-tile kernel ------------------------------------------------------


def _dq_walk(plan, b, sq, skv, hq, causal):
    """The K2a kernel's walk for ``plan``, block by block in launch order:
    ``(launch index, b, h, q tile, warpgroup, q0 of the warpgroup, kv
    tiles it computes, kv tiles the block streams)``."""
    bm = plan["block_m"]
    n_qt = plan["grid"][1]
    out = []
    for y in range(plan["grid"][1]):
        for x in range(plan["grid"][0]):
            qt = n_qt - 1 - y if causal else y
            q0 = qt * bm
            kv_end = min(skv, q0 + bm) if causal else skv
            n_tiles = -(-kv_end // tfa.MASK_TILE)
            for wg in range(bm // tfa.MASK_TILE):
                wq0 = q0 + wg * tfa.MASK_TILE
                wg_end = min(skv, wq0 + tfa.MASK_TILE) if causal else skv
                n_w = -(-wg_end // tfa.MASK_TILE) if wq0 < sq else 0
                out.append((y * plan["grid"][0] + x, x // hq, x % hq, qt, wg,
                            wq0, n_w, n_tiles))
    return out


@pytest.mark.parametrize("name", sorted(BWD))
def test_dq_plan_covers_every_q_row_and_stat_row_once(name):
    """K2a's plan on every ``BWD_CASES`` shape: every q row of every (b,
    q head) is one warpgroup's, once; every lse2 / delta row below
    ``sq_pad`` is read by one block, once (a block reads its rows up to
    ``sq_pad``); the split path's pre-pass writes each once; and under
    causal masking the q tiles launch heaviest first."""
    c = BWD[name]
    b, s, hq, hkv, d = c["b"], c["s"], c["hq"], c["hkv"], c["d"]
    plan = tfa.dq_launch_plan(b, s, s, hq, hkv, d)
    bm = plan["block_m"]
    assert plan["kind"] == "dq" and plan["boxes_per_row"] * 64 == d
    assert plan["grid"] == (b * hq, math.ceil(s / bm))
    assert plan["q_box"] == (64, 1, bm, 1)
    assert plan["kv_box"] == (64, 1, tfa.MASK_TILE, 1)
    assert plan["sq_pad"] == math.ceil(s / 64) * 64
    rows = np.zeros((b, hq, plan["sq_pad"]), dtype=np.int64)
    stats = np.zeros_like(rows)
    for _, bb, h, qt, wg, wq0, n_w, n_tiles in _dq_walk(
            plan, b, s, s, hq, c["causal"]):
        if wq0 < s:
            rows[bb, h, wq0:min(wq0 + 64, s)] += 1
        if wg == 0:
            q0 = qt * bm
            stats[bb, h, q0:min(q0 + bm, plan["sq_pad"])] += 1
    assert (rows[:, :, :s] == 1).all() and (rows[:, :, s:] == 0).all()
    assert (stats == 1).all()
    assert (_prep_rows_written(plan, b, hq, d) == 1).all()
    if c["causal"]:
        # The kv tiles each block streams, in launch order: never
        # increasing.
        work = {launch: n_tiles for launch, _, _, _, _, _, _, n_tiles
                in _dq_walk(plan, b, s, s, hq, True)}
        order = [work[i] for i in sorted(work)]
        assert order == sorted(order, reverse=True)
        assert order[0] > order[-1]


#: Ragged sequences beside those of ``BWD_CASES``, at lengths no multiple
#: of 64: a causal GQA one and a non-causal one at D 128.
RAGGED = {
    "ragged_causal_s1000": dict(b=1, s=1000, hq=4, hkv=2, d=64,
                                causal=True),
    "ragged_noncausal_s300_d128": dict(b=2, s=300, hq=2, hkv=2, d=128,
                                       causal=False),
}


def _segment_ids(c):
    """``(seg_q, seg_kv)`` [B, S] as ``chip_smoke._case_inputs`` makes
    them, or ``(None, None)``."""
    b, s, seg = c["b"], c["s"], c.get("seg")
    if seg is None:
        return None, None
    ids = np.tile(np.arange(s) // (100 if seg == "pad" else 40), (b, 1))
    if seg == "pad":
        ids[:, -40:] = -1
        return ids, ids
    kv = ids.copy()
    kv[:, :40] = 7  # q rows of segment 0 find no kv of their segment
    return ids, kv


@pytest.mark.parametrize("name", sorted(BWD) + sorted(RAGGED))
def test_dq_kv_walk_visits_exactly_the_live_tile_pairs(name):
    """A numpy mirror of K2a's kv walk: each warpgroup computes kv tiles
    ``[0, n_w)``, masks only where a mask can bite (the causal diagonal,
    the ragged kv edge, segment ids) and passes the rest of the block's
    streamed tiles.  The (64-row q tile, kv tile) pairs computed are
    exactly those that hold a pair the causal mask and the sequence ends
    leave live; every live pair of the case (segments included) lies in
    one of them; and a tile computed without the mask holds no masked
    pair on a row below Sq."""
    c = BWD.get(name) or RAGGED[name]
    b, s, hq, hkv, d = c["b"], c["s"], c["hq"], c["hkv"], c["d"]
    causal = c["causal"]
    seg_q, seg_kv = _segment_ids(c)
    qi, kj = np.arange(s)[:, None], np.arange(s)[None, :]
    allowed = (kj <= qi) if causal else np.ones((s, s), dtype=bool)
    plan = tfa.dq_launch_plan(b, s, s, hq, hkv, d)
    t = tfa.MASK_TILE
    n_t = -(-s // t)
    want = np.array([[allowed[a * t:(a + 1) * t, i * t:(i + 1) * t].any()
                      for i in range(n_t)] for a in range(n_t)])
    walk = _dq_walk(plan, b, s, s, hq, causal)
    for bb in range(b):
        live = allowed.copy()
        if seg_q is not None:
            live &= seg_q[bb][:, None] == seg_kv[bb][None, :]
        for h in range(hq):
            visited = np.zeros((n_t, n_t), dtype=bool)
            for _, b2, h2, _, _, wq0, n_w, n_tiles in walk:
                if (b2, h2) != (bb, h):
                    continue
                assert n_w <= n_tiles
                for i in range(n_w):
                    assert not visited[wq0 // t, i]
                    visited[wq0 // t, i] = True
                    n0 = i * t
                    need_mask = (seg_q is not None or n0 + t > s
                                 or (causal and n0 + t - 1 > wq0))
                    if not need_mask:
                        assert live[wq0:min(wq0 + t, s), n0:n0 + t].all()
            assert (visited == want).all()
            rows, cols = np.nonzero(live)
            assert visited[rows // t, cols // t].all()


def test_dq_plans_are_builds_of_the_kernel_source():
    """``DQ_BUILDS`` is the source's ``DQ_BUILD`` table, and every plan
    K2a's wrapper makes on the ``BWD_CASES`` shapes, and on small grids,
    names one of its rows: (head dim, warpgroups, stages, blocks an SM,
    shared-memory bytes), the bytes also those of :func:`dq_smem_bytes`
    and the blocks an SM within the card's shared memory."""
    builds = _build_table("DQ_BUILD")
    assert {k + v for k, v in tfa.DQ_BUILDS.items()} == {
        row[:4] for row in builds}
    for row in builds:
        assert tfa.dq_smem_bytes(*row[:3]) == row[4]
        assert row[3] * (row[4] + 1024) <= 233472
    shapes = [(c["b"], c["s"], c["hq"], c["hkv"], c["d"])
              for c in CS.BWD_CASES]
    shapes += [(1, 512, 8, 8, 64), (1, 512, 8, 2, 128)]
    for b, s, hq, hkv, d in shapes:
        plan = tfa.dq_launch_plan(b, s, s, hq, hkv, d)
        row = (d, plan["block_m"] // tfa.MASK_TILE, plan["stages"],
               plan["blocks_per_sm"], plan["smem_bytes"])
        assert row in builds, row


def test_dq_plan_at_the_main_path_shapes():
    split = tfa.dq_launch_plan(16, 1024, 1024, 25, 25, 64)
    assert split["grid"] == (400, 8) and split["block_m"] == 128
    assert split["stages"] == 4 and split["blocks_per_sm"] == 1
    gqa = tfa.dq_launch_plan(1, 2048, 2048, 32, 8, 128)
    assert gqa["block_m"] == 128 and gqa["grid"] == (32, 16)
    assert gqa["stages"] == 4
    # Under the crossover of the two builds (16 waves of 128-row blocks at
    # D 64, half a wave at D 128): one warpgroup a block.
    small = tfa.dq_launch_plan(1, 512, 512, 8, 8, 128)
    assert small["block_m"] == 64 and small["grid"] == (8, 8)
    assert tfa.dq_launch_plan(1, 1024, 1024, 32, 8, 128)["block_m"] == 128
    small = tfa.dq_launch_plan(1, 512, 512, 8, 8, 64)
    assert small["block_m"] == 64 and small["blocks_per_sm"] == 2
    assert tfa.dq_launch_plan(1, 512, 512, 8, 8, 64,
                              num_sms=2)["block_m"] == 128
    assert tfa.dq_launch_plan(8, 900, 900, 8, 2, 64)["block_m"] == 64
    assert tfa.dq_launch_plan(8, 1024, 1024, 25, 25, 64)["block_m"] == 64
    assert tfa.dq_launch_plan(16, 900, 900, 25, 5, 64)["block_m"] == 128


def test_split_path_shares_one_prepass_rows_buffer(monkeypatch):
    """The split backward's workspace is one rows buffer: K2a's launch runs
    the pre-pass into it and K2b's reads it without one; each kernel is
    counted once.  K2a and K2b called alone each run their own."""
    calls = []

    def record(name, q, k, v, o, lse, do, seg_q, seg_kv, dq, dk, dv,
               causal, scale, ws, plan, prep=True):
        calls.append((name, ws, prep, plan))

    monkeypatch.setattr(tfa, "_bwd_launch", record)
    monkeypatch.setattr(tfa, "_check_qkv", lambda q, k, v: q.device)
    monkeypatch.setattr(kernel_lib, "num_sms", lambda index: 132)
    b, s, hq, hkv, d = 2, 200, 4, 2, 64
    q = torch.zeros((b, s, hq, d), dtype=torch.bfloat16)
    kv = torch.zeros((b, s, hkv, d), dtype=torch.bfloat16)
    lse = torch.zeros((b, hq, s))
    before = dict(tfa.LAUNCHES)
    dq, dk, dv = tfa.flash_bwd_split(q, kv, kv, q, lse, q)
    assert dq.shape == q.shape and dk.shape == dv.shape == kv.shape
    assert [(n, p) for n, _, p, _ in calls] == [("flash_bwd_dq", True),
                                                ("flash_bwd_dkv", False)]
    assert calls[0][1] is calls[1][1]
    assert tuple(calls[0][1].shape) == (2, b, hq, 256)
    for _, _, _, plan in calls:
        assert plan["workspace"] == {"rows": (2, b, hq, 256)}
    assert tfa.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert tfa.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    calls.clear()
    tfa.flash_bwd_dq(q, kv, kv, q, lse, q)
    tfa.flash_bwd_dkv(q, kv, kv, q, lse, q)
    assert [(n, p) for n, _, p, _ in calls] == [("flash_bwd_dq", True),
                                                ("flash_bwd_dkv", True)]
    assert calls[0][1] is not calls[1][1]


# -- K11: the layout pin ------------------------------------------------------


def _pin_views():
    """``chip_smoke.pin_kernel_check``'s four views, on the CPU."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((CS.TRAIN_BATCH, CS.TRAIN_SEQ, 1600),
                    generator=gen).to(torch.bfloat16)
    odd = torch.randn((7, 1, 33), generator=gen)
    return {
        "contiguous": x,
        "transposed": x.transpose(1, 2),
        "sliced_expanded_fp32": odd.expand(7, 5, 33)[1:, :, 2::3],
        "bytes": (x[0, :77, :13].contiguous().view(torch.uint8))[:, 3:],
    }


def _vector_writes(plan):
    """How often the vector route writes each 16-byte vector: block b's
    thread t copies, at its k-th step, vectors s + u * threads + t for u <
    unroll, s = (b + k * blocks) * threads * unroll."""
    threads, unroll, blocks = plan["threads"], plan["unroll"], plan["blocks"]
    step = threads * unroll
    steps = -(-plan["n_vec"] // (step * blocks))
    blk, k, u, t = np.meshgrid(np.arange(blocks), np.arange(steps),
                               np.arange(unroll), np.arange(threads),
                               indexing="ij")
    j = (blk + k * blocks) * step + u * threads + t
    j = j[j < plan["n_vec"]]
    return np.bincount(j, minlength=plan["n_vec"])


def _strided_sources(view, plan):
    """Source element offset of each output element, in the order the
    strided route's grid-stride loop writes them, from the merged dims."""
    sizes, strides = tpin.merged_dims(view)
    sizes = [1] * (tpin.MAX_DIMS - len(sizes)) + sizes
    strides = [0] * (tpin.MAX_DIMS - len(strides)) + strides
    n = view.numel()
    step = plan["blocks"] * plan["threads"]
    i = np.concatenate([np.arange(start, n, step)
                        for start in range(min(step, n))])
    rest, off = i.copy(), np.zeros_like(i)
    for k in range(tpin.MAX_DIMS - 1, -1, -1):
        off += (rest % sizes[k]) * strides[k]
        rest //= sizes[k]
    return i, off


@pytest.mark.parametrize("name", ["contiguous", "transposed",
                                  "sliced_expanded_fp32", "bytes"])
def test_pin_plan_covers_every_byte_once(name):
    """K11's plan for each view of ``pin_kernel_check``: the vector route
    (the dense view) writes every 16-byte vector once, with at most
    ``BLOCKS_PER_SM`` blocks an SM; the strided route writes every output
    element once, from the view's own element."""
    view = _pin_views()[name]
    dense = view.is_contiguous()
    plan = tpin.pin_launch_plan(view.numel(), view.element_size(), dense)
    nbytes = view.numel() * view.element_size()
    if name == "contiguous":
        assert plan["route"] == "vectors" and plan["n_vec"] * 16 == nbytes
        assert plan["blocks"] == kernel_lib.H100_SMS * tpin.BLOCKS_PER_SM
        assert (_vector_writes(plan) == 1).all()
        return
    assert plan["route"] == "strided"
    i, off = _strided_sources(view, plan)
    assert (np.bincount(i, minlength=view.numel()) == 1).all()
    base = torch.arange(view.untyped_storage().nbytes()
                        // view.element_size())
    want = base.as_strided(view.shape, view.stride(),
                           view.storage_offset()).reshape(-1).numpy()
    got = np.empty_like(off)
    got[i] = off + view.storage_offset()
    assert (got == want).all()


def test_pin_plan_struct_matches_the_kernel_source():
    src = open(os.path.join(os.path.dirname(tpin.__file__), "csrc",
                            "layout_pin.cu")).read()
    body = re.search(r"struct PinPlan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = re.findall(r"\w+", re.sub(r"\blong\b", " ", body))
    assert fields == [name for name, _ in tpin.PinPlan._fields_]
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("THREADS"), const("UNROLL")) == (tpin.THREADS,
                                                   tpin.UNROLL)
    plan = tpin.pin_launch_plan(1 << 20, 2, True, num_sms=100)
    packed = tpin.PinPlan.of(plan)
    assert (packed.route, packed.blocks, packed.unroll) == (
        tpin.ROUTES["vectors"], plan["blocks"], plan["unroll"])
    # A small input: no block without a step; the strided route where the
    # bytes are no multiple of 16.
    tiny = tpin.pin_launch_plan(3, 16, True)
    assert tiny["blocks"] == 1 and (_vector_writes(tiny) == 1).all()
    assert tpin.pin_launch_plan(33, 2, True)["route"] == "strided"

"""The host side of the Hopper kernels K1, K3, K2b and K11 on the CPU:
their launch plans, pure functions of the shapes, on every shape that
``chip_smoke.py`` runs the kernels at (``KERNEL_CASES`` for K1,
``BWD_CASES`` for K3 and K2b, ``pin_kernel_check``'s views for K11), and
K3's delta pre-pass's plain version against ``rowsum(o * do)`` from the
JAX package's own forward.  The kernels themselves run only on the card,
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


def test_kv_tile_plans_are_builds_of_the_kernel_source():
    """Every plan the K3 and K2b wrappers make names a (head dim,
    block_kv, stages, blocks an SM) that ``flash_bwd_bf16`` dispatches to
    for its kind (it refuses any other)."""
    src = open(os.path.join(os.path.dirname(tfa.__file__), "csrc",
                            "flash_attention_bwd.cu")).read()
    entry = src[src.index('extern "C" int flash_bwd_bf16('):]
    for c in CS.BWD_CASES:
        for kind, code in (("fused", 2), ("dkv", 1)):
            plan = tfa.bwd_launch_plan(c["b"], c["s"], c["s"], c["hq"],
                                       c["hkv"], c["d"], kind=kind)
            branch = entry[entry.index(
                f"if (kind == {code} && stages == {plan['stages']}"):]
            branch = branch[:branch.index("\n  }\n")]
            blocks = plan["blocks_per_sm"]
            build = (f"launch_kv_tiles<{c['d']}, "
                     f"{plan['block_kv'] // tfa.MASK_TILE}, "
                     f"{'true' if kind == 'fused' else 'false'}, "
                     f"{plan['stages']}{f', {blocks}' if blocks > 1 else ''}>")
            assert build in branch, build
            assert f"block_kv == {plan['block_kv']}" in branch


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

"""The host side of the Hopper flash kernels (K1, K3) on the CPU: their
launch plans, pure functions of the shapes, on every shape that
``chip_smoke.py`` runs the kernels at (``KERNEL_CASES`` for K1,
``BWD_CASES`` for K3), and K3's delta pre-pass's plain version against
``rowsum(o * do)`` from the JAX package's own forward.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them
against the plain versions.
"""

import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu_torch.ops import flash_attention as tfa


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

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100).

    python3 chip_smoke.py

Drives the port's two main paths, serving and training, at the full width
and depth of GPT-2 1.5B with random weights from a seed, and holds every
CUDA kernel of those paths against its plain PyTorch version.  Imports
nothing of JAX or of the JAX package.  Phases, each one JSON line on
stdout:

1. ``device``  the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``   nvcc builds every kernel under ``dlrover_tpu_torch/ops/csrc``
               into ``build/kernels/`` (seconds, ptxas register report).
3. ``kernel_checks``  the flash-attention forward at the serving shapes
               (B=1, H=25, D=64, S in 16/128/512/1000, causal; q/k/v as
               strided views of one fused projection), at the training
               shape (B=16, S=1024) and at GQA, segment, non-causal and
               fully-masked-row shapes: error against ``mha_reference``
               computed in fp32 from the same bf16 inputs (TF32 off),
               tolerance |o - ref| <= 1e-2 + 1e-2 |ref| and
               |lse - ref| <= 1e-3; kernel, plain and
               ``F.scaled_dot_product_attention`` (yardstick only, never
               called by the port) device times from CUDA events around
               CUDA-graph replays (``eager_*``: back-to-back eager calls,
               host launch gaps included); the roofline bound from this
               call's bytes and unmasked FLOPs.
4. ``bwd_kernel_checks``  the three backward kernels (fused, and the
               split dq + dkv pair) at the training shape B=16, H=25,
               D=64, S=1024 (fused, and split as ``block_kv=512`` takes
               it), GQA 32/8 D=128 S=2048, segments with a pad segment,
               non-causal S=512 and fully masked rows; every case through
               both paths against ``mha_backward_reference`` in fp32 from
               the same bf16 inputs and the kernel's own o and lse.  Each
               of dq, dk, dv: every row (one (b, s, h) vector) within
               ``BWD_ROW_TOL`` of that row's largest |ref| and the tensor
               within ``BWD_NORM_TOL`` in norm-relative error (the limits'
               reasons are where they are set), and exactly 0 where no
               (q, kv) pair is live.  At the training shape the check is
               also shown to fail on planted faults: the diagonal tiles of
               the second half of the sequence dropped or halved in one
               tensor at a time.  Times as in phase 3, each kernel beside
               its own plain version; the yardstick is the backward of
               ``F.scaled_dot_product_attention`` through
               ``torch.autograd.grad`` (eager, back-to-back).
5. ``dispatch``  host microseconds per flash forward under ``no_grad``
               at the S=16 and S=512 prefill shapes, through the custom
               op against the bare kernel call, and the op's first call.
6. ``serve``   ``ServingEngine`` on ``gpt2_config("1.5b",
               attention_impl="flash", param_dtype=bfloat16)``, 8 slots, 16
               requests over every prefill bucket (half greedy, half
               temperature 0.8 / top-k 8): every request returns exactly
               its ``max_new_tokens`` with finite logprobs, and the flash
               kernel launched 48 times (one per layer) per prefill.
               Prefill ms per bucket, decode-step p50/p95, generated
               tokens/s, peak device memory.
7. ``profile`` device time by kernel for one 512-token prefill and one
               decode step (``torch.profiler``).
8. ``parity``  prefill logits through the kernel vs the same model with
               ``mha_reference`` in its place, and one decode step's logits
               vs a no-cache forward of the same prefix, both bf16, within
               atol 0.1 (the logits' std is about 0.8) and the same argmax.
9. ``train``   ``build_train`` on ``gpt2_config("1.5b",
               attention_impl="flash", remat="flash_only",
               param_dtype=bfloat16)`` as ``bench.py`` builds it: batch 16
               x seq 1024, Adafactor lr 1e-4 behind a global-norm clip of
               1.0, full logits (no chunked CE); 2 warm-up then 5 measured
               steps re-fed with one batch (tokens from numpy seed 0).  The
               loss is finite at every step and lower at the end; every
               step launches the flash forward 48 times, the fused backward
               48 times and the split kernels never.  Step time, tokens/s,
               MFU and HFU against 989 TFLOP/s (``bench.py``'s FLOP
               formulas), peak memory, and one profiled step's device-busy
               share and top kernels.
10. ``train_split``  full width, 4 layers, ``flash_block_kv=512``: every
               step launches ``flash_bwd_dq`` and ``flash_bwd_dkv`` 4 times
               each and the fused kernel never.
11. ``train_parity``  full width, 4 layers, bf16, batch 4: one step's loss
               and gradients through the kernels against the same model
               with the plain forward and backward swapped in: loss gap,
               global grad-norm gap, and every parameter's gradient cosine
               and norm-relative error, within the ``PARITY_*`` limits;
               the same check must fail on the planted backward faults of
               ``PARITY_FAULTS``.

Then the ``{"kernels": [...]}`` line (launches summed over the counted
runs of the serve, train and train_split paths, each driven with the
counts set to 0 just before it and read just after), the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``.  Any failed check
raises: the script exits non-zero and prints no result.  Without a GPU,
or without the package beside it, it exits non-zero before any phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
O_ATOL = O_RTOL = 1e-2
LSE_ATOL = 1e-3
LOGIT_ATOL = 0.1
# Backward kernels, for each of dq, dk and dv (see ``bwd_errors``): the
# worst row's error over that row's scale, and the tensor's norm-relative
# error.  One scale per tensor would not do: a causal dk/dv is about 100x
# larger in its first kv rows, which every q row attends, than in its
# last.  Sound kernels read at most 0.0077 (row) and 0.0024 (norm) at
# every shape here on an H100, from the bf16 rounding of p, ds and the
# outputs (the fused dq's atomic order moves it by fp32 rounding only);
# the limits are about 2.5x that.  Planted faults (``planted_faults``)
# read 0.49 and more by row.
BWD_ROW_TOL, BWD_NORM_TOL, BWD_ROW_FLOOR = 0.02, 0.006, 1e-3
SLOTS = 8
TRAIN_BATCH, TRAIN_SEQ = 16, 1024     # bench.py:35-36
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
TRAIN_LR = 1e-4                       # bench.py:383
SPLIT_LAYERS, SPLIT_BLOCK_KV = 4, 512
PARITY_LAYERS, PARITY_BATCH = 4, 4
# Kernels against plain versions over one 4-layer step.  Sound kernels
# read (H100): loss gap 5.6e-5, grad-norm gap 1.5e-4, lowest cosine
# 0.999945 and worst per-parameter error 0.0105 (``pos_embedding``); the
# limits are about 3x that.  The planted faults read grad-norm gaps of
# 0.011 and 0.076, cosines of 0.993 and 0.952 and errors of 0.12 and 0.32.
PARITY_LOSS_ATOL, PARITY_NORM_RTOL = 2e-4, 5e-4
PARITY_MIN_COSINE, PARITY_PARAM_RTOL = 0.99985, 0.03
# Planted backward faults the parity must catch: (name, first 64-row tile,
# share of the diagonal tiles' contribution lost).
PARITY_FAULTS = [("late_diagonal_dropped", TRAIN_SEQ // 128, 1.0),
                 ("every_diagonal_halved", 0, 0.5)]
# (prompt length, max_new_tokens): every bucket 16..512, one prompt > 256.
SERVE_REQUESTS = [
    (5, 16), (16, 24), (12, 64), (20, 32), (32, 40), (40, 16), (64, 48),
    (70, 20), (100, 64), (128, 16), (200, 32), (256, 24), (300, 40),
    (400, 16), (480, 56), (500, 64),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _event_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of ``iters`` back-to-back eager calls (CUDA
    events): device time plus any gap the host leaves between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _event_ms(lambda: [fn() for _ in range(iters)]) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch gap is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(lambda: [graph.replay() for _ in range(replays)])
    del graph
    return ms / (iters * replays)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# -- kernel checks -------------------------------------------------------------

KERNEL_CASES = [
    dict(case="serve_s16", b=1, s=16, hq=25, hkv=25, d=64, causal=True,
         fused=True),
    dict(case="serve_s128", b=1, s=128, hq=25, hkv=25, d=64, causal=True,
         fused=True),
    dict(case="serve_s512", b=1, s=512, hq=25, hkv=25, d=64, causal=True,
         fused=True),
    dict(case="serve_s1000", b=1, s=1000, hq=25, hkv=25, d=64, causal=True,
         fused=True),
    dict(case="train_b16_s1024", b=16, s=1024, hq=25, hkv=25, d=64,
         causal=True, fused=True),
    dict(case="gqa_32_8_d128", b=1, s=512, hq=32, hkv=8, d=128,
         causal=True),
    dict(case="segments", b=2, s=512, hq=25, hkv=25, d=64, causal=True,
         seg="packed"),
    dict(case="noncausal", b=1, s=512, hq=25, hkv=25, d=64, causal=False,
         fused=True),
    dict(case="masked_rows", b=1, s=256, hq=8, hkv=8, d=64, causal=True,
         seg="masked"),
]
SERVE_CASE = "serve_s512"  # the largest serving bucket
TRAIN_CASE = "train_b16_s1024"  # the training step's shape


def _case_inputs(c, gen):
    b, s, hq, hkv, d = c["b"], c["s"], c["hq"], c["hkv"], c["d"]
    dev = "cuda"
    if c.get("fused"):
        # The main path's layout: views of one [B, S, H, 3*D] projection.
        qkv = torch.randn((b, s, hq, 3 * d), generator=gen, device=dev)
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q, k, v = (
            torch.randn((b, s, h, d), generator=gen, device=dev).to(
                torch.bfloat16)
            for h in (hq, hkv, hkv)
        )
    seg_q = seg_kv = None
    if c.get("seg") == "packed":
        seg_q = (torch.arange(s, device=dev) // 100).repeat(b, 1).int()
        seg_kv = seg_q
    elif c.get("seg") == "pad":
        # Packed segments of 100 and a pad tail of segment -1.
        seg_q = (torch.arange(s, device=dev) // 100).repeat(b, 1).int()
        seg_q[:, -40:] = -1
        seg_kv = seg_q
    elif c.get("seg") == "masked":
        # q rows of segment 0 find no kv of their segment: o = 0 and
        # lse = -1e30 there.
        seg_q = (torch.arange(s, device=dev) // 40).repeat(b, 1).int()
        seg_kv = seg_q.clone()
        seg_kv[:, :40] = 7
    return q, k, v, seg_q, seg_kv


def check_kernel_case(c, gen):
    from dlrover_tpu_torch.ops import flash_attention as fa

    q, k, v, seg_q, seg_kv = _case_inputs(c, gen)
    b, s, hq, hkv, d, causal = (c[x] for x in
                                ("b", "s", "hq", "hkv", "d", "causal"))
    o, lse = fa.flash_fwd(q, k, v, causal=causal, seg_q=seg_q,
                          seg_kv=seg_kv)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.mha_reference(
        q.float(), k.float(), v.float(), causal=causal, seg_q=seg_q,
        seg_kv=seg_kv,
    )
    o_err = (o.float() - ref_o).abs()
    lse_err = (lse - ref_lse).abs()
    o_ok = bool((o_err <= O_ATOL + O_RTOL * ref_o.abs()).all())
    lse_ok = bool((lse_err <= LSE_ATOL).all())
    masked = ref_lse <= -1e29
    masked_ok = bool(
        (lse[masked] == ref_lse[masked]).all()
        and (o.float().permute(0, 2, 1, 3)[masked] == 0).all()
    )

    # Unmasked (q, k) pairs of this input: the work the function needs.
    allowed = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        allowed = torch.tril(allowed)
    allowed = allowed[None]
    if seg_q is not None:
        allowed = allowed & (seg_q[:, :, None] == seg_kv[:, None, :])
    pairs = int(allowed.expand(b, s, s).sum())
    flops = 4.0 * pairs * hq * d
    nbytes = 2.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    bound_ms, bound_by = bound(nbytes, flops)

    def kernel():
        fa.flash_fwd(q, k, v, causal=causal, seg_q=seg_q, seg_kv=seg_kv,
                     return_lse=False)

    def plain():
        fa.mha_reference(q, k, v, causal=causal, seg_q=seg_q,
                         seg_kv=seg_kv)

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = None if seg_q is None else allowed[:, None]

    def library():
        F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask,
            is_causal=causal and sdpa_mask is None,
            enable_gqa=hq != hkv,
        )

    out = dict(
        case=c["case"], b=b, s=s, hq=hq, hkv=hkv, d=d, causal=causal,
        seg=c.get("seg"), strided_views=bool(c.get("fused")),
        max_abs_err=float(o_err.max()), lse_max_abs_err=float(
            lse_err.max()),
        masked_rows=int(masked.sum()),
        ms=device_ms(kernel), plain_ms=device_ms(plain, iters=5),
        library_ms=device_ms(library), eager_ms=eager_ms(kernel),
        eager_library_ms=eager_ms(library),
        bound_ms=bound_ms, bound_by=bound_by,
        bytes=nbytes, flops=flops,
        ok=o_ok and lse_ok and masked_ok,
    )
    return out


# -- backward kernel checks ---------------------------------------------------

BWD_CASES = [
    dict(case="train_fused", b=16, s=1024, hq=25, hkv=25, d=64, causal=True,
         fused=True, kernel="fused", plant=True),
    dict(case="train_split", b=16, s=1024, hq=25, hkv=25, d=64, causal=True,
         fused=True, kernel="split", plant=True),
    dict(case="gqa_32_8_d128_s2048", b=1, s=2048, hq=32, hkv=8, d=128,
         causal=True, kernel="split"),
    dict(case="segments_pad", b=2, s=512, hq=25, hkv=25, d=64, causal=True,
         seg="pad", kernel="fused"),
    dict(case="noncausal_s512", b=1, s=512, hq=25, hkv=25, d=64,
         causal=False, fused=True, kernel="fused"),
    dict(case="masked_rows", b=1, s=256, hq=8, hkv=8, d=64, causal=True,
         seg="masked", kernel="fused"),
]
BWD_FUSED_CASE, BWD_SPLIT_CASE = "train_fused", "train_split"


def _live_pairs(c, seg_q, seg_kv):
    """``[B, Sq, Skv]`` bool: the (q, kv) pairs the mask leaves live."""
    b, s = c["b"], c["s"]
    allowed = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if c["causal"]:
        allowed = torch.tril(allowed)
    allowed = allowed[None].expand(b, s, s)
    if seg_q is not None:
        allowed = allowed & (seg_q[:, :, None] == seg_kv[:, None, :])
    return allowed


def _bwd_bound(c, pairs, products, outputs):
    """Least time for a backward function that does ``products`` S x S x D
    products over the live pairs and writes ``outputs`` (of dq, dk, dv):
    q, k, v, o, do and lse read once, the outputs written once."""
    b, s, hq, hkv, d = (c[x] for x in ("b", "s", "hq", "hkv", "d"))
    q_bytes, kv_bytes = 2.0 * b * s * hq * d, 2.0 * b * s * hkv * d
    nbytes = 3 * q_bytes + 2 * kv_bytes + 4.0 * b * hq * s
    nbytes += sum(q_bytes if o == "dq" else kv_bytes for o in outputs)
    flops = 2.0 * products * pairs * hq * d
    return bound(nbytes, flops) + (nbytes, flops)


def bwd_errors(g, r, dead):
    """Errors of one gradient ``g`` ``[B, S, H, D]`` against its fp32
    reference ``r``, a row being one (b, s, h) vector of D values:
    ``row`` the worst row's largest error over that row's scale,
    ``norm`` ``||g - r|| / ||r||`` over the tensor, ``max_abs`` the
    largest error, and ``dead_rows_exact``: the rows ``dead`` ``[B, S]``
    marks (no live (q, kv) pair) are exactly 0.  A row's scale is its
    largest |ref| plus ``BWD_ROW_FLOOR`` of the tensor's: a row whose exact
    value cancels to 0 (the first q row of a causal dq, whose one key has
    p = 1 and dp - delta = 0) holds only rounding noise, which a scale of
    its own would turn into an error of order 1."""
    diff = g.float() - r
    err = diff.abs().amax(-1)
    row_max = r.abs().amax(-1)
    scale = row_max + BWD_ROW_FLOOR * row_max.max()
    return dict(
        row=float((err / scale.clamp_min(1e-30)).max()),
        norm=float(torch.linalg.vector_norm(diff)
                   / torch.linalg.vector_norm(r).clamp_min(1e-30)),
        max_abs=float(err.max()),
        dead_rows_exact=bool((g[dead] == 0).all()),
        finite=bool(torch.isfinite(g).all()),
    )


def bwd_ok(e) -> bool:
    return (e["row"] <= BWD_ROW_TOL and e["norm"] <= BWD_NORM_TOL
            and e["dead_rows_exact"] and e["finite"])


def diagonal_tiles(q, k, v, o, lse, do, *, causal, first_tile):
    """``(dq, dk, dv)`` over the (q, kv) pairs of the diagonal 64 x 64
    blocks (the kernels' tile) from tile ``first_tile`` on, in fp32: what a
    backward kernel that skipped those blocks would lose.  The plain backward with
    segment ids that keep exactly those pairs (p from the full lse, delta
    from the full o)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    b, s = q.shape[:2]
    idx = torch.arange(s, device=q.device) // 64
    late = idx >= first_tile
    seg_q = torch.where(late, idx, -1).int().expand(b, s)
    seg_kv = torch.where(late, idx, -2).int().expand(b, s)
    return fa.mha_backward_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        causal=causal, seg_q=seg_q, seg_kv=seg_kv)


def planted_faults(grads, ref, dead, lost):
    """The check applied to ``grads`` with planted faults: each region's
    ``lost`` contribution (``diagonal_tiles``) dropped, as a kernel that
    skipped those tiles would give, or halved, in one of dq, dk, dv at a
    time.  Each must fail.  ``old_check_passes``: whether the earlier
    tolerance of one scale per tensor (|err| <= 1e-2 max|ref| + 1e-2 |ref|)
    lets it through."""
    out = {}
    for region, region_lost in lost.items():
        for frac_name, frac in (("drop", 1.0), ("halve", 0.5)):
            for i, name in enumerate(("dq", "dk", "dv")):
                g = (grads[i].float() - frac * region_lost[i]).to(
                    grads[i].dtype)
                e = bwd_errors(g, ref[i], dead[i])
                old = bool(((g.float() - ref[i]).abs() <= 1e-2 * float(
                    ref[i].abs().max()) + 1e-2 * ref[i].abs()).all())
                out[f"{region}_{frac_name}_{name}"] = dict(
                    row=e["row"], norm=e["norm"], caught=not bwd_ok(e),
                    old_check_passes=old)
    return out


def check_bwd_case(c, gen):
    from dlrover_tpu_torch.ops import flash_attention as fa

    q, k, v, seg_q, seg_kv = _case_inputs(c, gen)
    causal = c["causal"]
    do = torch.randn(q.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    kw = dict(causal=causal, seg_q=seg_q, seg_kv=seg_kv)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ref = fa.mha_backward_reference(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(), **kw)
    live = _live_pairs(c, seg_q, seg_kv)
    dead_q, dead_kv = ~live.any(2), ~live.any(1)    # [B, S]: no live pair
    dead = (dead_q, dead_kv, dead_kv)
    out = dict(case=c["case"], b=c["b"], s=c["s"], hq=c["hq"],
               hkv=c["hkv"], d=c["d"], causal=causal, seg=c.get("seg"),
               strided_views=bool(c.get("fused")), timed=c["kernel"],
               dead_q_rows=int(dead_q.sum()), dead_kv_rows=int(dead_kv.sum()))
    ok = True
    for path in ("fused", "split"):
        grads = fa.flash_bwd(q, k, v, o, lse, do, fused=path == "fused",
                             **kw)
        torch.cuda.synchronize()
        for name, g, r, dd in zip(("dq", "dk", "dv"), grads, ref, dead):
            e = bwd_errors(g, r, dd)
            out[f"{path}_{name}"] = e
            ok = ok and bwd_ok(e)
        if c.get("plant") and path == ("fused" if c["kernel"] == "fused"
                                       else "split"):
            tiles = c["s"] // 64
            lost = {region: diagonal_tiles(q, k, v, o, lse, do,
                                           causal=causal, first_tile=first)
                    for region, first in (("late_half", tiles // 2),
                                          ("last_tile", tiles - 1))}
            faults = planted_faults(grads, ref, dead, lost)
            del lost
            out["planted_faults"] = faults
            ok = ok and all(f["caught"] for f in faults.values())
        del grads
    out["ok"] = ok
    out["max_abs_err"] = max(out[f"{p}_{n}"]["max_abs"]
                             for p in ("fused", "split")
                             for n in ("dq", "dk", "dv"))

    pairs = int(live.sum())

    def run(fn):
        return lambda: fn(q, k, v, o, lse, do, **kw)

    if c["kernel"] == "fused":
        timed = {"fused": (fa.flash_bwd_fused, fa.mha_backward_reference, 5,
                           ("dq", "dk", "dv"))}
    else:
        timed = {"dq": (fa.flash_bwd_dq, fa.mha_backward_dq_reference, 3,
                        ("dq",)),
                 "dkv": (fa.flash_bwd_dkv, fa.mha_backward_dkv_reference, 4,
                         ("dk", "dv"))}
    for name, (kernel, plain, products, outputs) in timed.items():
        b_ms, b_by, nbytes, flops = _bwd_bound(c, pairs, products, outputs)
        out[name] = dict(ms=device_ms(run(kernel)),
                         eager_ms=eager_ms(run(kernel)),
                         plain_ms=device_ms(run(plain), iters=2, replays=2),
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         flops=flops)

    # Yardstick: SDPA's backward (dq, dk and dv together) at the same
    # shape, eager and back to back.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_mask = None if seg_q is None else live[:, None]
    sdpa_out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask,
        is_causal=causal and sdpa_mask is None, enable_gqa=c["hq"] != c["hkv"],
    )
    dot = do.transpose(1, 2)
    out["library_ms"] = eager_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dot, retain_graph=True), warmup=10)
    return out


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call of ``iters`` back-to-back calls, not
    waiting for the card: what a launch costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def mha_dispatch():
    """The flash forward's host cost under ``no_grad`` at two prefill
    shapes of the serve phase: through the custom op
    ``dlrover_tpu_torch::flash_fwd`` (``mha``'s differentiable path)
    against the bare kernel call, and the op's first call in the
    process."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"phase": "dispatch"}
    with torch.no_grad():
        for s in (16, 512):
            c = dict(b=1, s=s, hq=25, hkv=25, d=64, fused=True)
            q, k, v, _, _ = _case_inputs(c, gen)
            fused = fa.uses_fused_backward(s, 1024)

            def op():
                fa.flash_fwd_op(q, k, v, None, None, True, 0.125, fused)

            def bare():
                fa.flash_fwd(q, k, v, causal=True, scale=0.125,
                             return_lse=False)

            if "op_first_call_s" not in out:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                op()
                torch.cuda.synchronize()
                out["op_first_call_s"] = time.perf_counter() - t0
            op_us, bare_us = host_us(op), host_us(bare)
            out[f"s{s}"] = {"op_host_us": op_us, "bare_host_us": bare_us,
                            "op_extra_ms_per_48_calls":
                                48 * (op_us - bare_us) / 1e3}
    emit(out)


# -- training -----------------------------------------------------------------


def num_params(cfg) -> int:
    """The JAX config's ``num_params`` (dense model), copied: parameter
    count for the MFU/HFU accounting."""
    d, v, layers = cfg.d_model, cfg.vocab_size, cfg.num_layers
    h = cfg.resolved_head_dim * cfg.num_heads
    hkv = cfg.resolved_head_dim * cfg.resolved_kv_heads
    attn = d * h + 2 * d * hkv + h * d
    ff = (3 if cfg.activation == "swiglu" else 2) * d * cfg.resolved_d_ff
    embed = v * d + (cfg.max_seq_len * d if cfg.position == "learned" else 0)
    head = 0 if cfg.tie_embeddings else v * d
    return layers * (attn + ff) + embed + head


def flops_per_token(cfg, seq: int) -> float:
    """``bench.py``'s model FLOPs per token: 6 N plus attention."""
    return 6 * num_params(cfg) + 12 * cfg.num_layers * cfg.d_model * seq


def recompute_flops_per_token(cfg, remat: str, seq: int) -> float:
    """``bench.py``'s extra hardware FLOPs per token the backward re-runs
    under ``remat`` (``none``, ``full`` and ``flash_only`` here)."""
    if remat == "none":
        return 0.0
    d = cfg.d_model
    hd = cfg.resolved_head_dim * cfg.num_heads
    ff = cfg.resolved_d_ff
    qkv, wi, wo = 2 * d * 3 * hd, 2 * d * ff, 2 * ff * d
    attn_fwd, out_proj = 4 * d * seq, 2 * hd * d
    per_layer = {
        "full": qkv + wi + wo + attn_fwd + out_proj,
        "flash_only": qkv + wi + wo + out_proj,
    }[remat]
    return per_layer * cfg.num_layers


def _counts():
    from dlrover_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.mha.launches,
            "flash_bwd_fused": fa.flash_bwd_fused.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _zero_counts():
    from dlrover_tpu_torch.ops import flash_attention as fa

    for fn in (fa.mha, fa.flash_bwd_fused, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        fn.launches = 0


def _train_batch(vocab: int, batch: int):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(batch, TRAIN_SEQ + 1),
                          dtype=np.int64)
    return {"inputs": torch.as_tensor(tokens[:, :-1], device="cuda"),
            "targets": torch.as_tensor(tokens[:, 1:], device="cuda")}


def _train_steps(train, state, batch, steps, want_per_step):
    """Run ``steps`` steps, each asserted to launch ``want_per_step``;
    returns the state, per-step losses and synchronised seconds."""
    losses, seconds = [], []
    for i in range(steps):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train.step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        after = _counts()
        got = {k: after[k] - before[k] for k in after}
        if got != want_per_step:
            raise AssertionError(
                f"step {i}: kernel launches {got}, want {want_per_step}")
        if not np.isfinite(loss):
            raise AssertionError(f"step {i}: non-finite loss {loss}")
        losses.append(loss)
    return state, losses, seconds


def train_and_check():
    """The training path at full width and depth; returns its counts."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib

    cfg = gpt2_config("1.5b", attention_impl="flash", remat="flash_only",
                      param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, ce_chunks=0,
        device="cuda",
    )
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_step = {"flash_fwd": cfg.num_layers,
                "flash_bwd_fused": cfg.num_layers,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    state, warm_losses, warm_s = _train_steps(train, state, batch,
                                              TRAIN_WARMUP, per_step)
    state, losses, seconds = _train_steps(train, state, batch, TRAIN_STEPS,
                                          per_step)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    all_losses = warm_losses + losses
    if not all_losses[-1] < all_losses[0]:
        raise AssertionError(f"loss did not fall: {all_losses}")

    step_s = statistics.median(seconds)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tokens_per_s = tokens / step_s
    ftok = flops_per_token(cfg, TRAIN_SEQ)
    ftok_hw = ftok + recompute_flops_per_token(cfg, "flash_only", TRAIN_SEQ)
    prof = _profile(lambda: train.step(state, batch), top=16)
    busy = prof.get("device_busy_ms")
    emit({
        "phase": "train",
        "model": "gpt2-1.5b (48 layers, d_model 1600, 25 heads x 64, vocab "
                 "50304, bf16 params and compute, random weights seed 0)",
        "remat": cfg.remat, "optimizer": "adafactor lr 1e-4, clip 1.0",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "ce_chunks": 0,
        "losses": all_losses, "warmup_step_s": warm_s, "step_s": seconds,
        "step_s_median": step_s, "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * ftok / PEAK_BF16_FLOPS,
        "hfu": tokens_per_s * ftok_hw / PEAK_BF16_FLOPS,
        "model_flops_per_token": ftok, "hardware_flops_per_token": ftok_hw,
        "launches": counts, "launches_per_step": per_step,
        "peak_memory_allocated_bytes": peak, "setup_s": setup_s,
        "profiled_step": prof,
        "device_busy_share_of_median_step": (
            busy / (step_s * 1e3) if isinstance(busy, float) else
            "not measured"),
    })
    del state, train, batch
    torch.cuda.empty_cache()
    return counts


def train_split_and_check():
    """Reduced depth, ``flash_block_kv=512``: the split backward path."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib

    cfg = gpt2_config("1.5b", num_layers=SPLIT_LAYERS, attention_impl="flash",
                      remat="flash_only", param_dtype=torch.bfloat16,
                      flash_block_kv=SPLIT_BLOCK_KV)
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda",
    )
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    per_step = {"flash_fwd": SPLIT_LAYERS, "flash_bwd_fused": 0,
                "flash_bwd_dq": SPLIT_LAYERS, "flash_bwd_dkv": SPLIT_LAYERS}
    _zero_counts()
    state, losses, seconds = _train_steps(train, state, batch, 2, per_step)
    counts = _counts()
    emit({"phase": "train_split", "layers": SPLIT_LAYERS,
          "flash_block_kv": SPLIT_BLOCK_KV, "losses": losses,
          "step_s": seconds, "launches": counts,
          "launches_per_step": per_step})
    del state, train, batch
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def _flash_through_reference():
    """Swap the flash forward and backward kernels for their plain
    versions (fp32 math from the same bf16 inputs) while the block runs:
    the training model's op calls these module functions."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    kernel_fwd, kernel_bwd = fa.flash_fwd, fa.flash_bwd

    def reference_fwd(q, k, v, *, causal=True, seg_q=None, seg_kv=None,
                      scale=None, **_):
        return fa.mha_reference(q, k, v, causal=causal, seg_q=seg_q,
                                seg_kv=seg_kv, scale=scale)

    def reference_bwd(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                      seg_kv=None, scale=None, **_):
        return fa.mha_backward_reference(q, k, v, o, lse, do, causal=causal,
                                         seg_q=seg_q, seg_kv=seg_kv,
                                         scale=scale)

    fa.flash_fwd, fa.flash_bwd = reference_fwd, reference_bwd
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = kernel_fwd, kernel_bwd


@contextlib.contextmanager
def _planted_backward_fault(first_tile, fraction):
    """Swap in a faulty backward while the block runs: the kernels'
    gradients less ``fraction`` of the diagonal tiles' share from tile
    ``first_tile`` on (``diagonal_tiles``), as a kernel that skipped or
    half-counted them would give."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    kernel_bwd = fa.flash_bwd

    def faulty_bwd(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                   seg_kv=None, scale=None, fused=True):
        if seg_q is not None:
            raise ValueError("the planted fault takes no segment ids")
        grads = kernel_bwd(q, k, v, o, lse, do, causal=causal, scale=scale,
                           fused=fused)
        lost = diagonal_tiles(q, k, v, o, lse, do, causal=causal,
                              first_tile=first_tile)
        return tuple((g.float() - fraction * x).to(g.dtype)
                     for g, x in zip(grads, lost))

    fa.flash_bwd = faulty_bwd
    try:
        yield
    finally:
        fa.flash_bwd = kernel_bwd


def _grad_gap(grads, ref):
    """How far ``grads`` is from ``ref``: the global norms' relative gap,
    and per parameter the cosine and ``||g - r|| / ||r||``, worst each."""
    def norm(tree):
        return float(torch.sqrt(sum(g.square().sum() for g in tree.values())))

    g_norm, r_norm = norm(grads), norm(ref)
    names = [n for n in ref if float(ref[n].abs().max()) > 0]
    cos = {n: float(F.cosine_similarity(grads[n].flatten(),
                                        ref[n].flatten(), dim=0))
           for n in names}
    rel = {n: float(torch.linalg.vector_norm(grads[n] - ref[n])
                    / torch.linalg.vector_norm(ref[n])) for n in names}
    worst_cos, worst_rel = min(cos, key=cos.get), max(rel, key=rel.get)
    return {
        "grad_norm": g_norm, "grad_norm_reference": r_norm,
        "grad_norm_rel_diff": abs(g_norm - r_norm) / r_norm,
        "min_grad_cosine": cos[worst_cos], "min_grad_cosine_param": worst_cos,
        "max_grad_rel_err": rel[worst_rel],
        "max_grad_rel_err_param": worst_rel,
        "params_compared": len(names),
    }


def _parity_ok(loss_diff, gap) -> bool:
    return (loss_diff <= PARITY_LOSS_ATOL
            and gap["grad_norm_rel_diff"] <= PARITY_NORM_RTOL
            and gap["min_grad_cosine"] >= PARITY_MIN_COSINE
            and gap["max_grad_rel_err"] <= PARITY_PARAM_RTOL)


def train_parity():
    from dlrover_tpu_torch.models import gpt2_config, init_params
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.trainer import train_lib

    cfg = gpt2_config("1.5b", num_layers=PARITY_LAYERS,
                      attention_impl="flash", remat="flash_only",
                      param_dtype=torch.bfloat16)
    model = TransformerLM(cfg, device="cuda")
    model.load_state_dict(init_params(cfg, seed=0, device="cuda"))
    batch = _train_batch(cfg.vocab_size, PARITY_BATCH)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        logits, aux = model.forward_aux(batch["inputs"])
        loss, _ = train_lib.cross_entropy_loss(logits, batch["targets"])
        (loss + aux).backward()
        return loss.item(), {n: p.grad.float().clone()
                             for n, p in model.named_parameters()}

    before = _counts()
    k_loss, k_grads = loss_and_grads()
    after = _counts()
    if after["flash_fwd"] == before["flash_fwd"] or (
            after["flash_bwd_fused"] == before["flash_bwd_fused"]):
        raise AssertionError("the kernel leg of the parity ran no kernel")
    with _flash_through_reference():
        r_loss, r_grads = loss_and_grads()
    if _counts() != after:
        raise AssertionError("the reference leg launched a kernel")
    gap = _grad_gap(k_grads, r_grads)
    out = {
        "phase": "train_parity", "layers": PARITY_LAYERS,
        "batch": PARITY_BATCH, "seq": TRAIN_SEQ,
        "loss_kernel": k_loss, "loss_reference": r_loss,
        "loss_abs_diff": abs(k_loss - r_loss), **gap,
        "limits": {"loss_atol": PARITY_LOSS_ATOL,
                   "grad_norm_rtol": PARITY_NORM_RTOL,
                   "min_grad_cosine": PARITY_MIN_COSINE,
                   "max_grad_rel_err": PARITY_PARAM_RTOL},
    }
    out["ok"] = _parity_ok(out["loss_abs_diff"], gap)
    # The same check on planted backward faults: each must fail it.
    faults = {}
    for name, first_tile, fraction in PARITY_FAULTS:
        with _planted_backward_fault(first_tile, fraction):
            f_loss, f_grads = loss_and_grads()
        f_gap = _grad_gap(f_grads, r_grads)
        faults[name] = {k_: f_gap[k_] for k_ in (
            "grad_norm_rel_diff", "min_grad_cosine", "max_grad_rel_err",
            "max_grad_rel_err_param")}
        faults[name]["caught"] = not _parity_ok(abs(f_loss - r_loss), f_gap)
        del f_grads
    out["planted_faults"] = faults
    emit(out)
    if not out["ok"] or not all(f["caught"] for f in faults.values()):
        raise AssertionError(f"train parity failed: {out}")
    del model
    torch.cuda.empty_cache()


# -- serving --------------------------------------------------------------------


def _requests(vocab: int):
    from dlrover_tpu_torch.rl.generation import SamplingParams
    from dlrover_tpu_torch.serving import Request

    gen = torch.Generator().manual_seed(1)
    out = []
    for i, (n, m) in enumerate(SERVE_REQUESTS):
        prompt = torch.randint(1, vocab, (n,), generator=gen).numpy()
        sampling = (
            SamplingParams(temperature=0.0, max_new_tokens=m) if i % 2 == 0
            else SamplingParams(temperature=0.8, top_k=8, max_new_tokens=m)
        )
        out.append(Request(f"r{i:02d}", prompt, sampling))
    return out


def _profile(fn, top: int = 8):
    """Device time by kernel for one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # Kernels and copies only: a CPU op's row repeats its kernels'
        # device time.
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key[:70]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    return {
        "wall_ms_under_profiler": wall_ms,
        "device_busy_ms": busy,
        "kernels": len(rows),
        "top": [{"ms": ms, "count": n, "name": name}
                for ms, n, name in rows[:top]],
    }


@contextlib.contextmanager
def _attention_through_reference():
    """Swap the model's flash call for ``mha_reference`` (fp32 math from
    the same bf16 inputs) while the block runs."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    kernel_mha = fa.mha

    def reference_mha(q, k, v, *, causal=True, segment_ids=None, **_):
        o, _ = fa.mha_reference(q, k, v, causal=causal, seg_q=segment_ids,
                                seg_kv=segment_ids)
        return o

    fa.mha = reference_mha
    try:
        yield
    finally:
        fa.mha = kernel_mha


def serve_and_check():
    from dlrover_tpu_torch.models import gpt2_config, init_params
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.serving import ServingEngine, pad_to_bucket

    # bf16 weights: no fp32 master copy and no per-step cast.
    cfg = gpt2_config("1.5b", attention_impl="flash",
                      param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    engine = ServingEngine(cfg, params, slots=SLOTS, device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warmup_s = engine.warmup()
    requests = _requests(cfg.vocab_size)

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    t0 = time.perf_counter()
    results = engine.run(requests)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts["flash_fwd"]
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()

    for req in requests:
        res = results[req.uid]
        want = req.sampling.max_new_tokens
        if len(res.tokens) != want or len(res.logprobs) != want:
            raise AssertionError(
                f"{req.uid}: {len(res.tokens)} tokens, wanted {want}"
            )
        if not np.isfinite(res.logprobs).all():
            raise AssertionError(f"{req.uid}: non-finite logprobs")
        if ((res.tokens < 0) | (res.tokens >= cfg.vocab_size)).any():
            raise AssertionError(f"{req.uid}: token outside the vocab")
    prefills = int(stats["prefills"])
    if prefills != len(requests) or launches != prefills * cfg.num_layers:
        raise AssertionError(
            f"flash launches {launches} != prefills {prefills} x "
            f"{cfg.num_layers} layers"
        )
    if any(counts[k] for k in counts if k != "flash_fwd"):
        raise AssertionError(f"serving launched a backward kernel: {counts}")
    tokens = int(stats["tokens"])

    # -- prefill time per bucket (after the counted run) ---------------------
    programs, model = engine.programs, engine.model
    gen = torch.Generator(device="cuda").manual_seed(2)
    prefill_ms = {}
    for bucket in programs.buckets:
        toks = torch.randint(1, cfg.vocab_size, (1, bucket), generator=gen,
                             device="cuda")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            programs.prefill_logits(model, toks, bucket)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        prefill_ms[str(bucket)] = statistics.median(times[1:])
    emit({
        "phase": "serve",
        "model": "gpt2-1.5b (48 layers, d_model 1600, 25 heads x 64, vocab "
                 "50304, bf16, random weights seed 0)",
        "slots": SLOTS, "requests": len(requests), "prefills": prefills,
        "flash_launches": launches,
        "flash_launches_per_prefill": launches / prefills,
        "generated_tokens": tokens, "run_s": run_s,
        "generated_tokens_per_s": tokens / run_s,
        "decode_step_p50_s": stats["decode_step_p50_s"],
        "decode_step_p95_s": stats["decode_step_p95_s"],
        "decode_steps": stats["decode_step_n"],
        "request_p50_s": stats["p50_s"], "request_p95_s": stats["p95_s"],
        "occupancy": stats["occupancy"],
        "prefill_ms_by_bucket": prefill_ms,
        "peak_memory_allocated_bytes": peak,
        "setup_s": setup_s, "warmup_s": warmup_s,
    })

    # -- where the device time goes ------------------------------------------
    toks512 = torch.randint(1, cfg.vocab_size, (1, 512), generator=gen,
                            device="cuda")
    pool = programs.init_cache()
    step_tokens = torch.randint(1, cfg.vocab_size, (SLOTS,), generator=gen,
                                device="cuda")
    step_pos = torch.full((SLOTS,), 600, device="cuda")
    programs.decode_logits(model, pool, step_tokens, step_pos)
    emit({
        "phase": "profile",
        "prefill_512": _profile(
            lambda: programs.prefill_logits(model, toks512, 512)),
        "decode_step_8_slots": _profile(
            lambda: programs.decode_logits(model, pool, step_tokens,
                                           step_pos)),
    })
    del pool

    # -- parity on the card ---------------------------------------------------
    prompt = requests[8].prompt  # greedy, 100 tokens -> bucket 128
    padded, n = pad_to_bucket(prompt, programs.buckets)
    padded = torch.as_tensor(padded[None], device="cuda")
    before = fa.mha.launches
    row, kernel_logits = programs.prefill_logits(model, padded, n)
    if fa.mha.launches != before + cfg.num_layers:
        raise AssertionError("parity prefill did not run the kernel")
    with _attention_through_reference():
        _, ref_logits = programs.prefill_logits(model, padded, n)
    prefill_err = float((kernel_logits - ref_logits).abs().max())
    first = kernel_logits.argmax(-1)
    step_logits = programs.decode_logits(
        model, row, first, torch.tensor([n], device="cuda")
    )
    twin = TransformerLM(dataclasses.replace(cfg, decode=False),
                         device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    full = torch.cat([torch.as_tensor(prompt, device="cuda"), first])
    with torch.no_grad():
        full_logits = twin(full[None])[:, -1]
    decode_err = float((step_logits - full_logits).abs().max())
    parity = {
        "phase": "parity",
        "prompt_len": n, "bucket": int(padded.shape[1]),
        "logits_std": float(ref_logits.std()),
        "prefill_kernel_vs_reference_max_abs": prefill_err,
        "prefill_argmax_equal": bool(
            kernel_logits.argmax() == ref_logits.argmax()),
        "decode_vs_full_forward_max_abs": decode_err,
        "decode_argmax_equal": bool(
            step_logits.argmax() == full_logits.argmax()),
        "atol": LOGIT_ATOL,
    }
    emit(parity)
    if not (prefill_err <= LOGIT_ATOL and decode_err <= LOGIT_ATOL
            and parity["prefill_argmax_equal"]
            and parity["decode_argmax_equal"]):
        raise AssertionError(f"parity failed: {parity}")
    del engine, programs, model, twin, row
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "dlrover_tpu_torch")):
        print(f"chip_smoke: the dlrover_tpu_torch package is not beside "
              f"{__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dlrover_tpu_torch.ops import kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "allow_tf32": False,
    })

    build_s = kernel_lib.build_all()
    for name in kernel_lib.sources():
        kernel_lib.load(name)
    ptxas = {
        name: re.findall(r"Used \d+ registers[^\n]*|\d+ bytes spill[^\n]*",
                         log)
        for name, log in kernel_lib.BUILD_LOGS.items()
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "build_dir": os.path.relpath(kernel_lib.BUILD_DIR, REPO)})

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [check_kernel_case(c, gen) for c in KERNEL_CASES]
    emit({"phase": "kernel_checks",
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "lse_atol": LSE_ATOL},
          "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"flash kernel disagrees on {bad}")

    bwd_cases = [check_bwd_case(c, gen) for c in BWD_CASES]
    emit({"phase": "bwd_kernel_checks",
          "tolerance": {"row": BWD_ROW_TOL, "norm": BWD_NORM_TOL},
          "library": "F.scaled_dot_product_attention backward via "
                     "torch.autograd.grad, eager back-to-back",
          "cases": bwd_cases})
    bad = [c["case"] for c in bwd_cases if not c["ok"]]
    if bad:
        raise AssertionError(f"flash backward kernels disagree on {bad}")

    mha_dispatch()
    paths = {"serve": serve_and_check(), "train": train_and_check(),
             "train_split": train_split_and_check()}
    train_parity()

    def launches(name):
        return sum(p[name] for p in paths.values())

    def by_path(name):
        return {path: p[name] for path, p in paths.items()}

    for name in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if launches(name) == 0:
            raise AssertionError(f"{name} was never launched on a path")

    def shape(c):
        return {k: c[k] for k in ("b", "s", "hq", "hkv", "d", "causal")}

    fwd = next(c for c in cases if c["case"] == TRAIN_CASE)
    fused = next(c for c in bwd_cases if c["case"] == BWD_FUSED_CASE)
    split = next(c for c in bwd_cases if c["case"] == BWD_SPLIT_CASE)
    src = "dlrover_tpu_torch/ops/csrc/"
    entries = [dict(
        name="flash_fwd", route="cuda", source=src + "flash_attention.cu",
        replaces="dlrover_tpu/ops/flash_attention.py:58",
        launches=launches("flash_fwd"),
        launches_by_path=by_path("flash_fwd"),
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
        bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
        shape=shape(fwd),
    )]
    for name, replaces, case, key in (
            ("flash_bwd_fused", 318, fused, "fused"),
            ("flash_bwd_dq", 246, split, "dq"),
            ("flash_bwd_dkv", 278, split, "dkv")):
        path = "fused" if key == "fused" else "split"
        outs = {"fused": ("dq", "dk", "dv"), "dq": ("dq",),
                "dkv": ("dk", "dv")}[key]
        entries.append(dict(
            name=name, route="cuda", source=src + "flash_attention_bwd.cu",
            replaces=f"dlrover_tpu/ops/flash_attention.py:{replaces}",
            launches=launches(name), launches_by_path=by_path(name),
            max_abs_err=max(c[f"{path}_{o}"]["max_abs"]
                            for c in bwd_cases for o in outs),
            ms=case[key]["ms"], plain_ms=case[key]["plain_ms"],
            bound_ms=case[key]["bound_ms"], bound_by=case[key]["bound_by"],
            # SDPA's backward computes dq, dk and dv in one call: no
            # library call computes dq or (dk, dv) alone.
            library_ms=case["library_ms"] if key == "fused" else None,
            sdpa_whole_backward_ms=case["library_ms"], shape=shape(case),
        ))
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

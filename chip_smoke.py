#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --flags-ab    # a measurement, see ``flags_ab``
    python3 chip_smoke.py --flash       # build and the flash checks only
    python3 chip_smoke.py --gmm         # build and the MoE work only
    python3 chip_smoke.py --pin         # build and the layout pin's check
    python3 chip_smoke.py --norm        # build and the norm backward's check
    python3 chip_smoke.py --ab DIR ...  # K2a, K4 against other trees

Drives the port's main paths, serving, training (with Adafactor, and
with the fused norm backward, the layout pin and the low-bit Adam
optimizers) and mixture-of-experts training, at the full width of GPT-2
1.5B and of its MoE variant (full depth but for the MoE run) with random
weights from a seed, and the CTR loop on the embedding plane at MLPerf
DLRM width, and holds every CUDA kernel of those paths against its plain
PyTorch version.  Imports nothing of JAX or
of the JAX package.  Phases, each one JSON line on stdout:

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
               non-causal S=512, fully masked rows, and ragged GQA S=900
               (causal, D=64 and D=128) and S=1000 (non-causal, D=128);
               every case through both paths against
               ``mha_backward_reference`` in fp32 from the same bf16
               inputs and the kernel's own o and lse.  Each
               of dq, dk, dv: every row (one (b, s, h) vector) within
               ``BWD_ROW_TOL`` of that row's largest |ref| and the tensor
               within ``BWD_NORM_TOL`` in norm-relative error (the limits'
               reasons are where they are set), and exactly 0 where no
               (q, kv) pair is live.  At the training shape the check is
               also shown to fail on planted faults: the diagonal tiles of
               the second half of the sequence dropped or halved in one
               tensor at a time.  Times as in phase 3, each kernel beside
               its own plain version; the yardstick, at the training shape,
               is the backward of ``F.scaled_dot_product_attention``
               through ``torch.autograd.grad`` (device time: forward and
               backward replayed as one CUDA graph, less the forward's;
               the eager time beside it).  Two runs of the fused kernel
               must give bit-equal dk and dv and dq within one bf16 ulp
               of each row's largest value; two runs of the split dkv
               kernel bit-equal dk and dv, equal to the fused kernel's;
               two runs of the split dq kernel (the split path's, on its
               shared pre-pass, and ``flash_bwd_dq``'s own) bit-equal dq.
               On the split cases K2a's time is also read without its
               pre-pass (``prep_share``).
4b. ``gmm_kernel_checks``  the grouped-matmul kernels K8 (forward, and
               dx with w read transposed) and K9 (dw) on every grouped
               product of one MoE layer routed by a real gate (uneven
               groups, one expert empty, padding rows at the tail): the
               MoE step's shape (16 x 1024 tokens, top-2 of 8 experts,
               d_model 1600, d_ff 3200: 33,792 rows), a small ragged one
               with the last expert empty, and a swiglu one; against
               ``grouped_matmul_reference`` / ``grouped_matmul_dw_reference``
               in fp32 from the same bf16 inputs, each output row within
               ``GMM_ROW_TOL`` of its largest |ref| and the tensor within
               ``GMM_NORM_TOL``, padding rows and empty experts exactly 0;
               three planted faults (a row block times the wrong expert,
               the last K tile (``grouped_matmul.BLOCK_K`` wide) skipped,
               one expert's dw zeroed) must each fail the check.  Every
               product run twice must give bit-equal outputs.  At the MoE
               step's shape: kernel, plain and ``torch._grouped_mm``
               (yardstick only) times, and the host microseconds a wrapper
               call costs.
               Then ``moe_sync_check``:
               one ``MoEMlp`` forward and backward at full width under
               ``torch.cuda.set_sync_debug_mode("error")``.
4c. ``norm_kernel_checks``  the fused norm backward K4 at the training
               step's [16384, 1600] bf16 (LayerNorm with bias, RMSNorm), a
               ragged shape whose width is no multiple of 8, an fp32 one
               and a wide one, against ``layernorm_backward_reference`` in
               fp32 from the same inputs and saved statistics: dx by row
               and by norm (``NORM_ROW_TOL``, ``NORM_NORM_TOL``), dscale
               and dbias by norm (``NORM_PARAM_TOL``); two runs bit-equal
               (dx, dscale, dbias); two planted faults (the mean(g) term
               dropped, the first block's partial row lost) must fail.
               Yardstick ``aten.native_layer_norm_backward``.  ``--norm``
               runs the build and this phase alone.
4d. ``quant_kernel_checks``  K5a and K5b (round trip, and codes and values
               equal to the plain versions'), K6 and K7 on the largest
               leaf's shape [48, 1600, 6400] bf16, one layer of it and two
               ragged shapes, from a state K5a made of a random m and a
               plain-made v, against the plain updates: codes equal but
               for ``QUANT_CODE_SHARE`` of them one level off, scales
               within ``QUANT_SCALE_RTOL``, updates within
               ``QUANT_UPD_NORM_TOL``; two planted faults (v decoded
               linearly, the high nibble dropped) must fail.  No one
               PyTorch call computes these functions: no yardstick.
4e. ``pin_kernel_check``  K11 on [16, 1024, 1600] bf16 contiguous and
               transposed, and on sliced, expanded and byte-sized views:
               contiguous and bit-equal.  Yardstick ``clone()``, timed
               against the kernel in ``PIN_PAIRS`` alternating pairs
               (medians and spreads).  ``--pin`` runs the build and this
               phase alone.
4f. ``embed_kernel_checks``  the hot-row cache's gather K10a and scatter
               K10b (``EMBED_CASES``): the CTR loop's shape (cache
               [4,194,304, 128] fp32, 32,768 slots with a padded tail at
               slot 0), dim 16, the unaligned dim 129, one slot, and a
               scatter whose only duplicates are slot 0 with zero rows, each
               bit-equal to the plain versions; a gather that reads
               ``slots[i] + 1`` and a scatter that drops the last real row
               must fail.  Times over ``EMBED_TIMED_SETS`` slot sets (L2
               cold); yardsticks ``index_select`` and ``index_copy_``.
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
               1.0, full logits (no chunked CE); 1 warm-up then 3 measured
               steps re-fed with one batch (tokens from numpy seed 0).  The
               loss is finite at every step and lower at the end; every
               step launches the flash forward 48 times, the fused backward
               48 times and the split kernels never.  Step time, tokens/s,
               MFU and HFU against 989 TFLOP/s (``bench.py``'s FLOP
               formulas), peak memory, and one profiled step's device-busy
               share and top kernels.
10. ``train_split``  full width, 4 layers, ``flash_block_kv=512``, 1
               warm-up then 3 measured steps: every step launches
               ``flash_bwd_dq`` and ``flash_bwd_dkv`` 4 times each and the
               fused kernel never.  Step time (median).
11. ``train_parity``  full width, 4 layers, bf16, batch 4: one step's loss
               and gradients through the kernels against the same model
               with the plain forward and backward swapped in: loss gap,
               global grad-norm gap, and every parameter's gradient cosine
               and norm-relative error, within the ``PARITY_*`` limits;
               the same check must fail on the planted backward faults of
               ``PARITY_FAULTS``.

12. ``train_moe``  ``build_train`` on ``bench.py``'s MoE entry with the
               dropless grouped dispatch (``moe_config``: 8 experts,
               top-2, expert d_ff 3200) at 24 of its 48 layers (cut for
               the script's time; about 2.3B parameters), batch 16 x 1024,
               Adafactor, 1 warm-up then 3 measured steps: finite, falling
               loss, finite aux loss > 0, and per step and layer 1 flash
               forward, 1 fused backward, 6 K8 and 2 K9 launches and no
               split kernel.  Step time, tokens/s,
               MFU/HFU by ``bench.py``'s activated-FLOP rule, peak memory
               (also split before and inside the optimizer update), and
               one profiled step.
    (``--gmm`` runs the build, ``gmm_kernel_checks``, ``train_moe``,
    ``train_moe_parity`` and then ``train_moe_48``: the same at all 48
    layers, 1 warm-up then 2 measured steps and one profiled.)
13. ``train_moe_parity``  4 layers, batch 4: one step through K8/K9
               against the plain grouped matmuls swapped in, within the
               ``MOE_PARITY_*`` limits, with the kernel leg's own rerun
               as the noise floor; two planted faults (one expert's dw
               dropped, one expert's dx halved) must fail the same check.
               Every leg replays the kernel leg's top-k choices, so a
               rounding difference cannot reroute a token between legs.

14. ``train_lowbit``  ``build_train`` on ``lowbit_config()``: the train
               phase's model with ``fused_ln=True`` and
               ``pin_attn_layouts=True``, at full width and depth, with
               ``make_optimizer("q8_adam", learning_rate=1e-4,
               grad_clip=1.0)``, 1 warm-up then 3 measured steps, then
               again from seed 0 with ``"q4_adam"`` (1 + 2 steps):
               finite, falling loss; per step the launches derived in
               ``_lowbit_per_step`` (48 + 48 flash, 96 K4, 288 K11, one K6
               or K7 per quantized leaf); step time, tokens/s, MFU/HFU,
               peak memory, optimizer-state bytes beside Adafactor's, one
               profiled step; then a q8 first moment is read back through
               K5b (finite, non-zero) and requantized through K5a.
15. ``train_lowbit_parity``  4 layers, batch 4: one step's loss and
               gradients through K4 and K11 against their plain versions
               swapped in (``LOWBIT_PARITY_*``), and the same step's
               update through K6 against the plain update from the same
               gradients and one-step-old state (codes, scales, updates);
               one planted fault per kernel must fail.
16. ``train_rec``  ``dlrover_tpu_torch.examples.train_rec.run`` at MLPerf
               DLRM width (``REC_ARGV``: batch 8,192, 26 fields, dim 128,
               40M ids, hidden 1024, world 4 folding to 3 after step 16,
               4,194,304 cached rows), 1 + 30 steps: after every step the
               cache's rows of the batch's keys, gathered through K10a,
               equal the plane's bit for bit; finite loss, lower at the end;
               per step one K10a and 1 + (fetches) K10b launches, equal to
               the cache's own counts; hit rate above 0; the reshard moved
               rows and lost none.  Step time, examples/s, rows/s, one
               profiled step's device-busy share, one step's host profile
               (cProfile).  Then 3 steps with a K10b that drops the last
               real row must fail the invariant.

``--ab DIR [DIR ...]`` times K2a and K4 (``time_kernels``) of each tree
at DIR (a ``git archive`` of a parent commit under ``build/``, or a copy
of this tree with one constant changed; named by its directory) and of
this one, each reading in a process of its own, in turns: DIR, change,
change, DIR for each DIR, twice.

Then the ``{"kernels": [...]}`` line (launches summed over the counted
runs of the serve, train, train_split, train_moe, train_lowbit and
train_rec paths,
each driven with the counts set to 0 just before it and read just after),
the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any failed check
raises: the script exits non-zero and prints no result.  Without a GPU,
or without the package beside it, it exits non-zero before any phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
PEAK_FP32_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
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
# Two runs of the fused backward: dq's fp32 reductions land in another
# order, so its bf16 values may differ by one rounding, at most one bf16
# ulp (2^-7) of a row's largest value; dk and dv must be bit-equal.
REPRO_DQ_ROW_TOL = 2.0 ** -7
# Grouped-matmul kernels (K8, K9; see ``gmm_errors``): the worst row's
# error over that row's scale and the tensor's norm-relative error.
# Sound kernels read at most 0.0039 (row) and 0.0017 (norm) over every
# product of the three cases on an H100: the bf16 rounding of the output
# (half an ulp, 2^-9 of the row's largest value); the limits are about 3x
# that.  The planted faults (``_gmm_planted_faults``) read 0.27 and more
# by row, 0.088 and more by norm.
GMM_ROW_TOL, GMM_NORM_TOL, GMM_ROW_FLOOR = 0.012, 0.005, 1e-3
SLOTS = 8
TRAIN_BATCH, TRAIN_SEQ = 16, 1024     # bench.py:35-36
# bench.py's MoE entry (MOE_* constants, bench.py:367-376): 8 experts,
# top-2, capacity 1.25, expert d_ff = the dense 6400 // top_k.
MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY, MOE_D_FF = 8, 2, 1.25, 3200
GMM_BLOCK = 128                       # MoEMlp.gmm_block_rows
TRAIN_WARMUP, TRAIN_STEPS = 1, 3
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
# Planted backward faults the parity must catch: (name, first row of the
# diagonal tiles hit (``diagonal_tiles``), share of their contribution lost).
PARITY_FAULTS = [("late_diagonal_dropped", TRAIN_SEQ // 2, 1.0),
                 ("every_diagonal_halved", 0, 0.5)]
# Half of the 48 layers, cut for the script's time; the widths are whole.
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 24, 3
# K8/K9 against their plain versions over one 4-layer MoE step (the flash
# kernels in both legs, every leg routed as the kernel leg was).  Sound
# kernels read (H100): loss gap 4.3e-5, grad-norm gap 7.7e-5, lowest
# cosine 0.999979 and worst per-parameter error 0.0065, both in the last
# layer's ``moe.wi``; the kernel leg's rerun reads 0.9999968 and 0.0026.
# The limits are about 3x the readings.  The planted faults read cosines
# of 0.437 and 0.949 and errors of 0.90 and 0.45.
MOE_PARITY_LOSS_ATOL, MOE_PARITY_NORM_RTOL = 1.5e-4, 2.5e-4
MOE_PARITY_MIN_COSINE, MOE_PARITY_PARAM_RTOL = 0.99993, 0.02
MOE_PARITY_FAULTS = ("expert_dw_dropped", "expert_dx_halved")
MOE_PARITY_FAULT_EXPERT = 0
# Fused norm backward (K4; see ``check_norm_case``): dx by row and by norm
# as the grouped products are held, dscale and dbias by norm-relative
# error against the fp32 plain version from the same inputs and saved
# statistics.  Sound kernels read at most 0.0039 (row) and 0.00166 (norm)
# in bf16 on an H100, the rounding of dx to bf16, and 2.3e-7 on dscale and
# dbias (fp32 sums in another order); the limits are about 3x that.  The
# planted faults read 0.098 by row and 0.24 by norm (mean(g) dropped) and
# 0.045 on dscale (a partial row lost).
NORM_ROW_TOL, NORM_NORM_TOL, NORM_ROW_FLOOR = 0.012, 0.005, 1e-3
NORM_PARAM_TOL = 1e-6
# Low-bit Adam (K6, K7; see ``_adam_errors``) and block quantization (K5a,
# K5b).  The kernels do the plain versions' fp32 operations one IEEE
# rounding at a time and in their order, so codes, scales and updates are
# expected equal, and read equal at every shape on an H100 (no code, scale
# or update off); the limits leave room for a value an ulp from a .5
# boundary.  K5a's codes and K5b's values must be equal.  The planted
# faults read 0.56 and 0.71 on the update's norm.
QUANT_CODE_SHARE, QUANT_SCALE_RTOL, QUANT_UPD_NORM_TOL = 1e-4, 1e-6, 1e-3
LOWBIT_STEPS, LOWBIT_Q4_STEPS = 3, 2
PIN_PAIRS = 10  # K11 against clone(), alternating (``pin_kernel_check``)
# K4 and K11 against their plain versions over one 4-layer step (the flash
# kernels in both legs).  Sound kernels read (H100): loss gap 0 (neither
# kernel changes a forward value), lowest cosine 0.9999877 and worst
# per-parameter error 0.0049 (``pos_embedding``); the kernel leg's rerun
# reads 0.9999937 and 0.0036 (the fused flash dq's atomic order).  The
# grad-norm gap varies more from run to run: 5.9e-6, 4.0e-6, 1.49e-5,
# 1.72e-5 and 2.60e-5 over five runs.  The limits are about 3x the largest
# readings.  The planted faults read cosines of 0.9934 and 0.8555, errors
# of 0.18 and 0.53 and grad-norm gaps of 0.063 and 0.034.
LOWBIT_PARITY_LOSS_ATOL, LOWBIT_PARITY_NORM_RTOL = 1e-5, 8e-5
LOWBIT_PARITY_MIN_COSINE, LOWBIT_PARITY_PARAM_RTOL = 0.99996, 0.015
# (prompt length, max_new_tokens): every bucket 16..512, one prompt > 256.
SERVE_REQUESTS = [
    (5, 16), (16, 24), (12, 64), (20, 32), (32, 40), (40, 16), (64, 48),
    (70, 20), (100, 64), (128, 16), (200, 32), (256, 24), (300, 40),
    (400, 16), (480, 56), (500, 64),
]


_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        # Seconds since the script started: where its time goes.
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
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


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
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

    ms, library_ms = device_ms(kernel), device_ms(library)
    out = dict(
        case=c["case"], b=b, s=s, hq=hq, hkv=hkv, d=d, causal=causal,
        seg=c.get("seg"), strided_views=bool(c.get("fused")),
        max_abs_err=float(o_err.max()), lse_max_abs_err=float(
            lse_err.max()),
        masked_rows=int(masked.sum()),
        ms=ms, plain_ms=device_ms(plain, iters=5), library_ms=library_ms,
        tflops=flops / ms / 1e9, library_ratio=ms / library_ms,
        eager_ms=eager_ms(kernel), eager_library_ms=eager_ms(library),
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
    # Ragged sequences, the last q and kv tiles running past S, on each of
    # K2a's builds that the main-path cases leave out: its 64-row blocks at
    # D 64 (causal) and D 128 (non-causal), and its 128-row blocks at D
    # 128, the last one's second warpgroup wholly past S.
    dict(case="ragged_gqa_s900", b=8, s=900, hq=8, hkv=2, d=64,
         causal=True, kernel="split"),
    dict(case="ragged_small_s1000_d128", b=1, s=1000, hq=4, hkv=2, d=128,
         causal=False, kernel="split"),
    dict(case="ragged_gqa_s900_d128", b=2, s=900, hq=8, hkv=2, d=128,
         causal=True, kernel="split"),
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
    """``(dq, dk, dv)`` over the (q, kv) pairs of the diagonal ``MASK_TILE``
    square blocks (a warpgroup's tile in the kernels, inside which they
    mask) from tile ``first_tile`` on, in fp32: what a backward kernel that
    skipped those blocks would lose.  The plain backward with segment ids
    that keep exactly those pairs (p from the full lse, delta from the full
    o)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    b, s = q.shape[:2]
    idx = torch.arange(s, device=q.device) // fa.MASK_TILE
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
    fused_dkv = None
    for path in ("fused", "split"):
        grads = fa.flash_bwd(q, k, v, o, lse, do, fused=path == "fused",
                             **kw)
        torch.cuda.synchronize()
        for name, g, r, dd in zip(("dq", "dk", "dv"), grads, ref, dead):
            e = bwd_errors(g, r, dd)
            out[f"{path}_{name}"] = e
            ok = ok and bwd_ok(e)
        if path == "fused":
            # Two runs: dk and dv bit for bit, dq within the rounding of
            # its reductions' order.
            again = fa.flash_bwd(q, k, v, o, lse, do, fused=True, **kw)
            torch.cuda.synchronize()
            repro = dict(
                dk_dv_bit_equal=bool(torch.equal(grads[1], again[1])
                                     and torch.equal(grads[2], again[2])),
                dq_row=bwd_errors(again[0], grads[0].float(), dead_q)["row"])
            out["fused_repro"] = repro
            ok = ok and repro["dk_dv_bit_equal"] and (
                repro["dq_row"] <= REPRO_DQ_ROW_TOL)
            fused_dkv = grads[1:]
            del again
        else:
            # Two runs of K2b bit for bit; and K2b is K3 without dq: each
            # kv row's dk and dv are summed over the same q tiles, in the
            # same order and with the same instructions, whichever block
            # holds the row, so they equal K3's bit for bit.
            again = fa.flash_bwd_dkv(q, k, v, o, lse, do, **kw)
            dq_again = fa.flash_bwd_dq(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            # K2a's dq accumulates in registers and is written once: two
            # runs (the split path's, on its shared pre-pass, and one with
            # its own) are bit-equal.
            repro = dict(
                dq_bit_equal=bool(torch.equal(grads[0], dq_again)),
                dk_dv_bit_equal=bool(torch.equal(grads[1], again[0])
                                     and torch.equal(grads[2], again[1])),
                dk_dv_equal_fused=bool(torch.equal(grads[1], fused_dkv[0])
                                       and torch.equal(grads[2],
                                                       fused_dkv[1])))
            out["split_repro"] = repro
            ok = ok and all(repro.values())
            del again, dq_again, fused_dkv
        if c.get("plant") and path == ("fused" if c["kernel"] == "fused"
                                       else "split"):
            tiles = c["s"] // fa.MASK_TILE
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
        ms = device_ms(run(kernel))
        out[name] = dict(ms=ms, tflops=flops / ms / 1e9,
                         eager_ms=eager_ms(run(kernel)),
                         plain_ms=device_ms(run(plain), iters=2, replays=2),
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         flops=flops)
    if "dq" in out:
        # The pre-pass's share of K2a's launch: K2a on rows filled once.
        rows, scale = fa._rows(q), c["d"] ** -0.5
        fa._dq_launch(q, k, v, o, lse, do, rows, prep=True, scale=scale,
                      **kw)
        main_ms = device_ms(lambda: fa._dq_launch(
            q, k, v, o, lse, do, rows, prep=False, scale=scale, **kw))
        plan = fa.dq_launch_plan(c["b"], c["s"], c["s"], c["hq"], c["hkv"],
                                 c["d"], torch.cuda.get_device_properties(
                                     0).multi_processor_count)
        out["dq"].update(
            without_prep_ms=main_ms, prep_share=1.0 - main_ms / out["dq"]["ms"],
            plan={key: plan[key] for key in ("block_m", "stages",
                                             "blocks_per_sm", "smem_bytes",
                                             "grid")})

    # Yardstick: SDPA's backward (dq, dk and dv together), at the training
    # shape only (its first call at a new shape takes 1 to 7 s of set-up).
    # Device time: forward and backward captured in one CUDA graph, less
    # the forward alone on the same inputs (a backward alone does not
    # capture: its kernels follow the stream of a forward run outside the
    # graph).  Its eager time, host gaps included, read 0.69 to 5.1 ms over
    # the runs of one day at this shape; it is kept beside.
    out["library_ms"] = None
    if c.get("plant"):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdpa_mask = None if seg_q is None else live[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask,
                is_causal=causal and sdpa_mask is None,
                enable_gqa=c["hq"] != c["hkv"],
            )

        dot = do.transpose(1, 2)
        fwd_bwd_ms = device_ms(
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), iters=5)
        out["library_ms"] = fwd_bwd_ms - device_ms(sdpa, iters=5)
        out["library_fwd_bwd_ms"] = fwd_bwd_ms
        sdpa_out = sdpa()
        out["library_eager_ms"] = eager_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True), warmup=10)
        if "fused" in out:
            out["fused"]["library_ratio"] = (out["fused"]["ms"]
                                             / out["library_ms"])
    return out


# -- grouped matmul kernel checks (K8, K9) ------------------------------------

GMM_CASES = [
    # The MoE step's shape: 16 x 1024 tokens, top-2 of 8 experts, d_model
    # 1600, expert d_ff 3200 (33,792 rows); expert 5 gets no token, the
    # last expert owns the padding rows at the tail.
    dict(case="slice", tokens=TRAIN_BATCH * TRAIN_SEQ, d=1600, f=3200,
         activation="gelu", empty=5, timed=True, plant=True),
    # Ragged widths (not multiples of the 32-wide reduction step or the
    # 128-wide tiles) and an empty last expert, whose dw must stay 0 though
    # the padding rows are its.
    dict(case="ragged_small", tokens=200, d=40, f=72, activation="gelu",
         empty=MOE_EXPERTS - 1),
    # swiglu: three grouped products in each direction.
    dict(case="swiglu", tokens=2048, d=1600, f=3200, activation="swiglu",
         empty=2),
]
GMM_SLICE_CASE = "slice"
GMM_PRODUCTS = tuple(f"{kind}_{w}" for kind in ("fwd", "dx", "dw")
                     for w in ("wi", "wg", "wo"))


def moe_layer(d, f, activation, gen, param_dtype=torch.bfloat16):
    """A grouped-dispatch ``MoEMlp`` on the card with weights drawn as
    ``init_params`` draws them (router N(0, 1/d), experts N(0, 1/(E in)))."""
    from dlrover_tpu_torch.models import layers
    from dlrover_tpu_torch.models.moe import MoEMlp

    layer = MoEMlp(d, MOE_EXPERTS, f, top_k=MOE_TOP_K,
                   capacity_factor=MOE_CAPACITY, activation=activation,
                   dtype=torch.bfloat16, param_dtype=param_dtype,
                   dispatch="grouped", device="cuda")
    layers.normal_(layer.router.kernel, d ** -0.5, gen)
    for p in layer.expert_params():
        layers.normal_(p, (p.shape[0] * p.shape[1]) ** -0.5, gen)
    return layer


def row_errors(g, r, row_floor):
    """Errors of ``g`` against its fp32 reference ``r``, a row being one
    vector along the last axis: ``row`` the worst row's largest error over
    that row's scale (its max |ref| plus ``row_floor`` of the tensor's),
    ``norm`` ``||g - r|| / ||r||``."""
    r2 = r.reshape(-1, r.shape[-1])
    diff = g.float().reshape(r2.shape) - r2
    err = diff.abs().amax(-1)
    row_max = r2.abs().amax(-1)
    scale = row_max + row_floor * row_max.max()
    return dict(
        row=float((err / scale.clamp_min(1e-30)).max()),
        norm=float(torch.linalg.vector_norm(diff)
                   / torch.linalg.vector_norm(r2).clamp_min(1e-30)),
        max_abs=float(err.max()), finite=bool(torch.isfinite(g).all()))


def gmm_errors(g, r):
    """``row_errors`` of a grouped-matmul output with ``GMM_ROW_FLOOR``."""
    return row_errors(g, r, GMM_ROW_FLOOR)


def gmm_ok(e) -> bool:
    return (e["row"] <= GMM_ROW_TOL and e["norm"] <= GMM_NORM_TOL
            and e["finite"] and e.get("exact_zeros", True))


def _gmm_products(activation, rows, h, g, dh, dg, dout, layer):
    """The grouped products of one MoE layer's forward and backward, as
    ``name -> (kind, a, b)``: kind ``fwd`` (K8, b = w), ``dx`` (K8 against
    w transposed) or ``dw`` (K9, b = dy)."""
    wi, wo = layer.wi.detach(), layer.wo.detach()
    act = (torch.nn.functional.silu(g) * h if g is not None
           else torch.nn.functional.gelu(h, approximate="tanh"))
    out = {"fwd_wi": ("fwd", rows, wi), "fwd_wo": ("fwd", act, wo),
           "dx_wi": ("dx", dh, wi), "dx_wo": ("dx", dout, wo),
           "dw_wi": ("dw", rows, dh), "dw_wo": ("dw", act, dout)}
    if activation == "swiglu":
        wg = layer.wg.detach()
        out.update({"fwd_wg": ("fwd", rows, wg), "dx_wg": ("dx", dg, wg),
                    "dw_wg": ("dw", rows, dg)})
    return out


def _gmm_runner(kind, a, b, gs):
    """The kernel for one product."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    if kind == "dw":
        return lambda: gm.gmm_dw(a, b, gs)
    return lambda: gm.gmm_fwd(a, b, gs, transpose_w=kind == "dx")


def _gmm_bound(kind, a, b, rows_used):
    """Least time for one product: each operand read once and the output
    written once; FLOPs over every row the function multiplies (K8: all
    N rows, the tail padding rows included, as it defines out for them;
    K9: the rows of the experts that own rows)."""
    n, red = a.shape
    if kind == "dw":
        m = b.shape[1]
        nbytes = 2.0 * (rows_used * (red + m) + MOE_EXPERTS * red * m)
        flops = 2.0 * rows_used * red * m
    else:
        cols = b.shape[1] if kind == "dx" else b.shape[2]
        nbytes = 2.0 * (n * red + b.numel() + n * cols) + 4 * MOE_EXPERTS
        flops = 2.0 * n * red * cols
    return bound(nbytes, flops) + (nbytes, flops)


def _library_gmm(kind, a, b, gs):
    """The yardstick for one product, timed and never called by the port:
    ``torch._grouped_mm`` over the groups' end offsets (it leaves the
    tail padding rows out)."""
    ends = torch.cumsum(gs, 0).to(torch.int32)
    if kind == "dw":
        return lambda: torch._grouped_mm(a.t(), b, offs=ends)
    bb = b.transpose(1, 2) if kind == "dx" else b
    return lambda: torch._grouped_mm(a, bb, offs=ends)


def check_gmm_case(c, gen):
    """K8 and K9 on every grouped product of one MoE layer, routed by a
    real gate, against the plain versions in fp32 from the same bf16
    inputs."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    d, f = c["d"], c["f"]
    layer = moe_layer(d, f, c["activation"], gen)
    x = torch.randn((c["tokens"], d), generator=gen, device="cuda").to(
        torch.bfloat16)
    # Uneven loads from a bias on the router logits; one expert shut out.
    bias = torch.linspace(-1.0, 1.0, MOE_EXPERTS, device="cuda")
    bias[c["empty"]] = -1e4
    with torch.no_grad():
        logits = layer.router(x.float()) + bias
        routing = layer.route(x, logits)
        rows, gs = routing.rows, routing.group_sizes
        h = gm.gmm_fwd(rows, layer.wi.detach(), gs)
        g = (gm.gmm_fwd(rows, layer.wg.detach(), gs)
             if layer.wg is not None else None)
    sizes = [int(v) for v in gs.tolist()]
    n = rows.shape[0]
    ranges = gm._row_ranges(gs, n)
    zero_rows = rows.abs().amax(-1) == 0   # padding: output exactly 0
    rows_used = sum(t - s for (s, t), size in zip(ranges, sizes) if size)

    def rand(cols):
        return torch.randn((n, cols), generator=gen, device="cuda").to(
            torch.bfloat16)

    products = _gmm_products(c["activation"], rows, h, g, rand(f),
                             rand(f) if g is not None else None, rand(d),
                             layer)
    out = dict(case=c["case"], tokens=c["tokens"], d=d, f=f, rows=n,
               activation=c["activation"], group_sizes=sizes,
               padding_rows=int(zero_rows.sum()), rows_used_by_k9=rows_used)
    ok = True
    results = {}
    for name, (kind, a, b) in products.items():
        run = _gmm_runner(kind, a, b, gs)
        got = run()
        if kind == "dw":
            ref = gm.grouped_matmul_dw_reference(a.float(), b.float(), gs)
        else:
            ref = gm.grouped_matmul_reference(a.float(), b.float(), gs,
                                              transpose_w=kind == "dx")
        torch.cuda.synchronize()
        e = gmm_errors(got, ref)
        if kind == "dw":
            e["exact_zeros"] = all(bool((got[i] == 0).all())
                                   for i, size in enumerate(sizes)
                                   if size == 0)
        elif kind == "fwd":
            e["exact_zeros"] = bool((got[zero_rows] == 0).all())
        # No atomics, a fixed order of sums: a second run is bit-equal.
        e["bit_equal_rerun"] = bool(torch.equal(run(), got))
        ok = ok and gmm_ok(e) and e["bit_equal_rerun"]
        out[name] = e
        results[name] = (got, ref)
    out["max_abs_err"] = max(out[p]["max_abs"] for p in products)

    if c.get("plant"):
        out["planted_faults"] = _gmm_planted_faults(products, results, gs,
                                                    sizes, ranges)
        ok = ok and all(v["caught"] for v in out["planted_faults"].values())
    del results
    out["ok"] = ok

    if c.get("timed"):
        timed = {}
        for name, (kind, a, b) in products.items():
            run = _gmm_runner(kind, a, b, gs)
            if kind == "dw":
                def plain(a=a, b=b):
                    gm.grouped_matmul_dw_reference(a, b, gs)
            else:
                def plain(a=a, b=b, kind=kind):
                    gm.grouped_matmul_reference(a, b, gs,
                                                transpose_w=kind == "dx")
            library = _library_gmm(kind, a, b, gs)
            b_ms, b_by, nbytes, flops = _gmm_bound(kind, a, b, rows_used)
            m = b.shape[1] if kind == "dx" else b.shape[-1]
            plan = gm.gmm_launch_plan(kind, n, a.shape[1], m, MOE_EXPERTS)
            ms = device_ms(run)
            timed[name] = dict(
                ms=ms, eager_ms=eager_ms(run),
                # The wrapper's host cost, its two tensor maps encoded.
                host_us=host_us(run, iters=50),
                grid=plan["grid"], tiles=plan["tiles"],
                # The plain versions read the group sizes back to the host
                # (no graph capture): eager, back to back.
                plain_ms=eager_ms(plain, iters=3, warmup=1),
                library_ms=device_ms(library),
                library_eager_ms=eager_ms(library),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                tflops=flops / ms / 1e9)
        out["timed"] = timed
    del layer, products
    torch.cuda.empty_cache()
    return out


def _gmm_planted_faults(products, results, gs, sizes, ranges):
    """The check applied to planted faults, each of which must fail it: one
    row block of the largest expert multiplied by another expert's
    weights, the last reduction step (the kernels' K tile, ``BLOCK_K``
    wide) skipped, and the largest expert's dw zeroed."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    big = max(range(len(sizes)), key=lambda i: sizes[i])
    other = next(i for i in range(len(sizes)) if i != big and sizes[i])
    faults = {}
    _, a, w = products["fwd_wi"]
    got, ref = results["fwd_wi"]
    s = ranges[big][0]
    blk = slice(s, s + GMM_BLOCK)
    wrong = got.clone()
    wrong[blk] = (a[blk].float() @ w[other].float()).to(got.dtype)
    a_last = torch.zeros_like(a)
    a_last[:, -gm.BLOCK_K:] = a[:, -gm.BLOCK_K:]
    skipped = (got.float() - gm.grouped_matmul_reference(
        a_last.float(), w.float(), gs)).to(got.dtype)
    dw, dw_ref = results["dw_wi"]
    zeroed = dw.clone()
    zeroed[big] = 0
    for name, g, r in (("wrong_expert_block", wrong, ref),
                       ("last_k_tile_skipped", skipped, ref),
                       ("expert_dw_zeroed", zeroed, dw_ref)):
        e = gmm_errors(g, r)
        faults[name] = dict(row=e["row"], norm=e["norm"],
                            caught=not gmm_ok(e))
    return faults


def moe_sync_check(gen):
    """One ``MoEMlp`` forward and backward at full width (d 1600, 8
    experts of d_ff 3200, 4 x 1024 tokens) under
    ``torch.cuda.set_sync_debug_mode("error")``: the grouped dispatch and
    the kernels' wrappers must not make the host wait for the card."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    layer = moe_layer(1600, MOE_D_FF, "gelu", gen)
    x = torch.randn((4, 1024, 1600), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()

    def run():
        out, aux = layer(x)
        (out.float().square().mean() + aux).backward()

    run()  # first call: the op's registration and the library load
    torch.cuda.synchronize()
    before = dict(gm.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = {k: gm.LAUNCHES[k] - before[k] for k in before}
    want = {"gmm_fwd": 4, "gmm_dw": 2}
    res = {"phase": "moe_sync_check", "sync_debug_mode": "error",
           "tokens": 4 * 1024, "launches": got, "launches_wanted": want,
           "router_grad_nonzero": bool(layer.router.kernel.grad.abs().max()
                                       > 0)}
    emit(res)
    if got != want or not res["router_grad_nonzero"]:
        raise AssertionError(f"MoE sync check: {res}")
    del layer, x
    torch.cuda.empty_cache()


def gmm_kernel_checks(gen):
    cases = [check_gmm_case(c, gen) for c in GMM_CASES]
    emit({"phase": "gmm_kernel_checks",
          "tolerance": {"row": GMM_ROW_TOL, "norm": GMM_NORM_TOL,
                        "row_floor": GMM_ROW_FLOOR},
          "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"grouped matmul kernels disagree on {bad}")
    moe_sync_check(gen)
    return cases


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


def _launch_dicts():
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import fused_norm as fn
    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.ops import layout_pin as lp
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.embedding import kernels as ek

    return (fa.LAUNCHES, gm.LAUNCHES, fn.LAUNCHES, lp.LAUNCHES, tq.LAUNCHES,
            ek.LAUNCHES)


def _counts():
    return {k: v for launches in _launch_dicts() for k, v in launches.items()}


def _zero_counts():
    for launches in _launch_dicts():
        for name in launches:
            launches[name] = 0


def _per_step(**launched):
    """A step's wanted launches: ``launched`` and 0 for every other
    kernel."""
    want = dict.fromkeys(_counts(), 0)
    unknown = set(launched) - set(want)
    if unknown:
        raise KeyError(f"no such launch counter: {sorted(unknown)}")
    want.update(launched)
    return want


def _train_batch(vocab: int, batch: int):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(batch, TRAIN_SEQ + 1),
                          dtype=np.int64)
    return {"inputs": torch.as_tensor(tokens[:, :-1], device="cuda"),
            "targets": torch.as_tensor(tokens[:, 1:], device="cuda")}


def _train_steps(train, state, batch, steps, want_per_step, aux_out=None):
    """Run ``steps`` steps, each asserted to launch ``want_per_step``;
    returns the state, per-step losses and synchronised seconds (and
    appends each step's ``aux_loss`` to ``aux_out`` when given)."""
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
        if aux_out is not None:
            aux_out.append(float(metrics["aux_loss"]))
    return state, losses, seconds


def train_and_check():
    """The training path at full width and depth; returns its counts and
    the bytes of its (Adafactor) optimizer state."""
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
    per_step = _per_step(flash_fwd=cfg.num_layers,
                         flash_bwd_fused=cfg.num_layers)

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    state, warm_losses, warm_s = _train_steps(train, state, batch,
                                              TRAIN_WARMUP, per_step)
    state, losses, seconds = _train_steps(train, state, batch, TRAIN_STEPS,
                                          per_step)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    state_bytes = _state_bytes(state.opt_state)
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
        "optimizer_state_bytes": state_bytes,
        "profiled_step": prof,
        "device_busy_share_of_median_step": (
            busy / (step_s * 1e3) if isinstance(busy, float) else
            "not measured"),
    })
    del state, train, batch
    torch.cuda.empty_cache()
    return counts, state_bytes


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
    per_step = _per_step(flash_fwd=SPLIT_LAYERS, flash_bwd_dq=SPLIT_LAYERS,
                         flash_bwd_dkv=SPLIT_LAYERS)
    _zero_counts()
    state, warm_losses, warm_s = _train_steps(train, state, batch,
                                              TRAIN_WARMUP, per_step)
    state, losses, seconds = _train_steps(train, state, batch, TRAIN_STEPS,
                                          per_step)
    counts = _counts()
    emit({"phase": "train_split", "layers": SPLIT_LAYERS,
          "flash_block_kv": SPLIT_BLOCK_KV,
          "losses": warm_losses + losses, "warmup_step_s": warm_s,
          "step_s": seconds, "step_s_median": statistics.median(seconds),
          "launches": counts, "launches_per_step": per_step})
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


def _parity_ok(loss_diff, gap, limits=None) -> bool:
    """``limits``: (loss atol, grad-norm rtol, lowest cosine, per-parameter
    rtol); the dense parity's by default."""
    loss_atol, norm_rtol, min_cosine, param_rtol = limits or (
        PARITY_LOSS_ATOL, PARITY_NORM_RTOL, PARITY_MIN_COSINE,
        PARITY_PARAM_RTOL)
    return (loss_diff <= loss_atol
            and gap["grad_norm_rel_diff"] <= norm_rtol
            and gap["min_grad_cosine"] >= min_cosine
            and gap["max_grad_rel_err"] <= param_rtol)


def train_parity():
    from dlrover_tpu_torch.models import gpt2_config, init_params
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.ops import flash_attention as fa
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
    for name, first_row, fraction in PARITY_FAULTS:
        with _planted_backward_fault(first_row // fa.MASK_TILE, fraction):
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


# -- MoE training ---------------------------------------------------------------


def moe_config(**overrides):
    """``bench.py``'s MoE entry on the port (bench.py:367-376) with the
    dropless grouped dispatch in place of its einsum."""
    from dlrover_tpu_torch.models import gpt2_config

    return gpt2_config(
        "1.5b", attention_impl="flash", remat="flash_only",
        param_dtype=torch.bfloat16, num_experts=MOE_EXPERTS,
        top_k=MOE_TOP_K, capacity_factor=MOE_CAPACITY, d_ff=MOE_D_FF,
        moe_dispatch="grouped", **overrides)


def _moe_per_step(cfg):
    """Launches per MoE step under ``flash_only``: per layer the flash
    forward once (saved) and the fused backward once; K8 for each of the
    two expert products (gelu: wi, wo) in the forward, again in the
    recompute and once for dx; K9 once per product."""
    n_layers, products = cfg.num_layers, 3 if cfg.activation == "swiglu" else 2
    return _per_step(flash_fwd=n_layers, flash_bwd_fused=n_layers,
                     gmm_fwd=3 * products * n_layers,
                     gmm_dw=products * n_layers)


def _memory_split(train, state, batch):
    """One step with the peak read twice: up to the optimizer update
    (forward, backward, the stacked gradients) and inside it."""
    update = train.optimizer.update
    marks = {}

    def spy(grads, opt_state, params):
        marks["forward_backward_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = update(grads, opt_state, params)
        marks["update_peak_bytes"] = torch.cuda.max_memory_allocated()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train.optimizer = train.optimizer._replace(update=spy)
    try:
        state, _ = train.step(state, batch)
    finally:
        train.optimizer = train.optimizer._replace(update=update)
    torch.cuda.synchronize()
    return state, marks


def train_moe_and_check(layers=MOE_TRAIN_LAYERS, steps=MOE_TRAIN_STEPS,
                        phase="train_moe"):
    """The MoE training path at full width and ``layers`` layers (48 is
    the whole model); returns its counts."""
    from dlrover_tpu_torch.trainer import train_lib

    cfg = moe_config(num_layers=layers)
    torch.cuda.synchronize()
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
    resident = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in state.model.parameters())
    per_step = _moe_per_step(cfg)

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    aux = []
    state, warm_losses, warm_s = _train_steps(train, state, batch,
                                              TRAIN_WARMUP, per_step, aux)
    state, losses, seconds = _train_steps(train, state, batch, steps,
                                          per_step, aux)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    allocator = {k: torch.cuda.memory_stats()[k] for k in (
        "num_alloc_retries", "num_device_alloc", "num_device_free")}
    allocator["max_memory_reserved_bytes"] = torch.cuda.max_memory_reserved()
    all_losses = warm_losses + losses
    if not all_losses[-1] < all_losses[0]:
        raise AssertionError(f"MoE loss did not fall: {all_losses}")
    if not all(np.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"MoE aux loss not finite and > 0: {aux}")

    step_s = statistics.median(seconds)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tokens_per_s = tokens / step_s
    # bench.py:418-426: MoE FLOPs counted at the activated dense shape
    # (top_k experts of d_ff each per token; the router and the padding
    # rows of the grouped products are not counted).
    flops_cfg = dataclasses.replace(cfg, num_experts=0,
                                    d_ff=cfg.resolved_d_ff * cfg.top_k)
    ftok = flops_per_token(flops_cfg, TRAIN_SEQ)
    ftok_hw = ftok + recompute_flops_per_token(flops_cfg, "flash_only",
                                               TRAIN_SEQ)
    choices = tokens * cfg.top_k
    n_pad = ((choices + GMM_BLOCK - 1) // GMM_BLOCK + cfg.num_experts) * \
        GMM_BLOCK
    state, memory = _memory_split(train, state, batch)
    prof = _profile(lambda: train.step(state, batch), top=16)
    busy = prof.get("device_busy_ms")
    emit({
        "phase": phase,
        "model": f"gpt2-1.5b MoE ({cfg.num_layers} of 48 layers, d_model "
                 "1600, 25 heads x 64, "
                 "vocab 50304, 8 experts top-2 of d_ff 3200, grouped "
                 "dispatch, bf16 params and compute, random weights seed 0)",
        "params": n_params, "remat": cfg.remat,
        "optimizer": "adafactor lr 1e-4, clip 1.0",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "ce_chunks": 0,
        "losses": all_losses, "aux_losses": aux, "warmup_step_s": warm_s,
        "step_s": seconds, "step_s_median": step_s,
        "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * ftok / PEAK_BF16_FLOPS,
        "hfu": tokens_per_s * ftok_hw / PEAK_BF16_FLOPS,
        "model_flops_per_token": ftok, "hardware_flops_per_token": ftok_hw,
        "grouped_rows": n_pad, "token_choices": choices,
        "padding_row_share_not_counted": (n_pad - choices) / n_pad,
        "launches": counts, "launches_per_step": per_step,
        "peak_memory_allocated_bytes": peak,
        "resident_after_setup_bytes": resident, **memory,
        "allocator": allocator,
        "setup_s": setup_s, "profiled_step": prof,
        "device_busy_share_of_median_step": (
            busy / (step_s * 1e3) if isinstance(busy, float) else
            "not measured"),
    })
    del state, train, batch
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def _gmm_swapped(fwd=None, dw=None):
    """Swap the grouped-matmul wrappers that the MoE op calls (module
    globals) while the block runs."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    kernel_fwd, kernel_dw = gm.gmm_fwd, gm.gmm_dw
    gm.gmm_fwd, gm.gmm_dw = fwd or kernel_fwd, dw or kernel_dw
    try:
        yield kernel_fwd, kernel_dw
    finally:
        gm.gmm_fwd, gm.gmm_dw = kernel_fwd, kernel_dw


def _gmm_reference_fns():
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    def fwd(x, w, group_sizes, block_rows=GMM_BLOCK, transpose_w=False):
        return gm.grouped_matmul_reference(x, w, group_sizes, transpose_w)

    def dw(x, dy, group_sizes, block_rows=GMM_BLOCK):
        return gm.grouped_matmul_dw_reference(x, dy, group_sizes)

    return fwd, dw


def _gmm_fault_fns(name, kernel_fwd, kernel_dw):
    """A planted fault in the kernels' results: expert
    ``MOE_PARITY_FAULT_EXPERT``'s dw dropped, or its rows of every dx
    halved."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    e = MOE_PARITY_FAULT_EXPERT
    if name == "expert_dw_dropped":
        def dw(x, dy, group_sizes, block_rows=GMM_BLOCK):
            out = kernel_dw(x, dy, group_sizes, block_rows)
            out[e] = 0
            return out

        return None, dw

    def fwd(x, w, group_sizes, block_rows=GMM_BLOCK, transpose_w=False):
        out = kernel_fwd(x, w, group_sizes, block_rows, transpose_w)
        if transpose_w:
            s, t = gm._row_ranges(group_sizes, out.shape[0])[e]
            out[s:t] *= 0.5
        return out

    return fwd, None


@contextlib.contextmanager
def _routing_recorded(record):
    """Append every top-k index tensor the MoE gate computes to
    ``record`` while the block runs."""
    from dlrover_tpu_torch.models import moe

    kernel_gate = moe.gate

    def recording_gate(logits, k):
        out = kernel_gate(logits, k)
        record.append(out[1].detach())
        return out

    moe.gate = recording_gate
    try:
        yield
    finally:
        moe.gate = kernel_gate


@contextlib.contextmanager
def _routing_replayed(record):
    """Make the MoE gate choose, call by call, the experts of ``record``
    (filled by ``_routing_recorded`` on a run of the same step) while the
    block runs; the gate values and the aux loss are computed as
    ``moe.gate`` computes them, from this call's logits at those choices.
    A rounding difference upstream then cannot move a choice to another
    expert, so two legs differ only by their products."""
    from dlrover_tpu_torch.models import moe

    kernel_gate = moe.gate
    calls = iter(record)

    def replaying_gate(logits, k):
        gate_idx = next(calls)
        e = logits.shape[-1]
        probs = torch.softmax(logits.float(), dim=-1)
        gate_vals = probs.gather(-1, gate_idx)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
        density = moe._one_hot(gate_idx[..., 0], e).mean(dim=(0, 1))
        aux_loss = (density * probs.mean(dim=(0, 1))).sum() * (e ** 2) / k
        return gate_vals, gate_idx, aux_loss

    moe.gate = replaying_gate
    try:
        yield
    finally:
        moe.gate = kernel_gate
    if next(calls, None) is not None:
        raise AssertionError("the replayed step made fewer gate calls than "
                             "the recorded one")


def train_moe_parity():
    """One MoE step's loss and gradients through K8/K9 against the same
    model with the plain grouped matmuls swapped in (the flash kernels
    run in both legs), and the same check on two planted faults.  Every
    leg after the first routes as the first did (``_routing_replayed``),
    so the gaps measure the grouped products alone."""
    from dlrover_tpu_torch.models import init_params
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.trainer import train_lib

    cfg = moe_config(num_layers=PARITY_LAYERS)
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
    route = []
    with _routing_recorded(route):
        k_loss, k_grads = loss_and_grads()
    after = _counts()
    want = _moe_per_step(cfg)
    got = {k: after[k] - before[k] for k in after}
    if got != want:
        raise AssertionError(f"MoE parity kernel leg launched {got}, want "
                             f"{want}")
    # The gate runs in each layer's forward, then in its recompute (last
    # layer first): choices the recompute routed elsewhere, per layer.
    layers = cfg.num_layers
    recompute_moved = [int((f != r).sum()) for f, r in
                       zip(route[:layers], route[layers:][::-1])]
    ref_fwd, ref_dw = _gmm_reference_fns()
    with _gmm_swapped(ref_fwd, ref_dw), _routing_replayed(route):
        r_loss, r_grads = loss_and_grads()
    end = _counts()
    if (end["gmm_fwd"], end["gmm_dw"]) != (after["gmm_fwd"],
                                           after["gmm_dw"]):
        raise AssertionError("the reference leg launched a grouped kernel")
    moe_names = [n for n in r_grads if ".moe." in n]
    dead = [n for n in moe_names if float(r_grads[n].abs().max()) == 0]
    if dead or not moe_names:
        raise AssertionError(f"MoE parameters without gradient: {dead}")
    gap = _grad_gap(k_grads, r_grads)
    # The noise floor: the kernel leg again (the atomic order of the
    # combine's index_add and of the fused flash dq differs run to run).
    with _routing_replayed(route):
        k2_loss, k2_grads = loss_and_grads()
    rerun = _grad_gap(k2_grads, k_grads)
    del k2_grads
    out = {
        "phase": "train_moe_parity", "layers": PARITY_LAYERS,
        "batch": PARITY_BATCH, "seq": TRAIN_SEQ,
        "loss_kernel": k_loss, "loss_reference": r_loss,
        "loss_abs_diff": abs(k_loss - r_loss), **gap,
        "moe_params_compared": len(moe_names),
        "token_choices_per_layer": PARITY_BATCH * TRAIN_SEQ * cfg.top_k,
        "routing": "every leg replays the kernel leg's top-k choices",
        "kernel_leg_recompute_choices_moved_by_layer": recompute_moved,
        "kernel_rerun": {"loss_abs_diff": abs(k2_loss - k_loss),
                         **{k_: rerun[k_] for k_ in (
                             "grad_norm_rel_diff", "min_grad_cosine",
                             "min_grad_cosine_param", "max_grad_rel_err",
                             "max_grad_rel_err_param")}},
        "limits": {"loss_atol": MOE_PARITY_LOSS_ATOL,
                   "grad_norm_rtol": MOE_PARITY_NORM_RTOL,
                   "min_grad_cosine": MOE_PARITY_MIN_COSINE,
                   "max_grad_rel_err": MOE_PARITY_PARAM_RTOL},
    }
    out["ok"] = _moe_parity_ok(out["loss_abs_diff"], gap)
    faults = {}
    for name in MOE_PARITY_FAULTS:
        with _gmm_swapped() as (kernel_fwd, kernel_dw):
            fwd, dw = _gmm_fault_fns(name, kernel_fwd, kernel_dw)
            with _gmm_swapped(fwd, dw), _routing_replayed(route):
                f_loss, f_grads = loss_and_grads()
        f_gap = _grad_gap(f_grads, r_grads)
        faults[name] = {k_: f_gap[k_] for k_ in (
            "grad_norm_rel_diff", "min_grad_cosine", "min_grad_cosine_param",
            "max_grad_rel_err", "max_grad_rel_err_param")}
        faults[name]["caught"] = not _moe_parity_ok(abs(f_loss - r_loss),
                                                    f_gap)
        del f_grads
    out["planted_faults"] = faults
    emit(out)
    if not out["ok"] or not all(f["caught"] for f in faults.values()):
        raise AssertionError(f"MoE train parity failed: {out}")
    del model
    torch.cuda.empty_cache()


def gmm_only():
    """``--gmm``: the MoE work alone, to repeat it cheaply on the card: the
    grouped-matmul checks, the 24-layer MoE step, its parity, and the
    whole 48-layer MoE step (1 warm-up, 2 measured steps, one profiled),
    each step's launches asserted as in the whole run."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    gmm_kernel_checks(gen)
    train_moe_and_check()
    train_moe_parity()
    train_moe_and_check(48, 2, "train_moe_48")


def _moe_parity_ok(loss_diff, gap) -> bool:
    return _parity_ok(loss_diff, gap, (
        MOE_PARITY_LOSS_ATOL, MOE_PARITY_NORM_RTOL, MOE_PARITY_MIN_COSINE,
        MOE_PARITY_PARAM_RTOL))


# -- the dense step's opt-in kernels (K4, K5a, K5b, K6, K7, K11) --------------


def _norm_rel(g, r) -> float:
    return float(torch.linalg.vector_norm(g.float() - r.float())
                 / torch.linalg.vector_norm(r.float()).clamp_min(1e-30))


NORM_CASES = [
    # The block norms of the training step: 16 x 1024 rows of d_model 1600.
    dict(case="train_layernorm", n=TRAIN_BATCH * TRAIN_SEQ, d=1600,
         dtype="bf16", center=True, bias=True, timed=True, plant=True),
    dict(case="train_rmsnorm", n=TRAIN_BATCH * TRAIN_SEQ, d=1600,
         dtype="bf16", center=False, bias=False, timed=True),
    # Rows no multiple of a block's run, a width no multiple of 8 (loads
    # element by element behind a mask).
    dict(case="ragged_bf16", n=1237, d=1001, dtype="bf16", center=True,
         bias=False),
    dict(case="fp32", n=4099, d=1600, dtype="fp32", center=True, bias=True),
    # More than one chunk per thread (5120 / 8 = 640 chunks on 256 threads).
    dict(case="wide_bf16", n=515, d=5120, dtype="bf16", center=False,
         bias=False),
]
NORM_TRAIN_CASE = "train_layernorm"
NORM_EPS = 1e-5


def norm_ok(e) -> bool:
    return (e["dx"]["row"] <= NORM_ROW_TOL and e["dx"]["norm"] <= NORM_NORM_TOL
            and e["dx"]["finite"] and e["dscale"] <= NORM_PARAM_TOL
            and e["dbias"] <= NORM_PARAM_TOL)


def check_norm_case(c, gen):
    """K4 against ``layernorm_backward_reference`` in fp32 from the same
    inputs and the same saved statistics."""
    from dlrover_tpu_torch.ops import fused_norm as fn

    n, d, center = c["n"], c["d"], c["center"]
    dtype = torch.bfloat16 if c["dtype"] == "bf16" else torch.float32

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (rand(n, d) * 2.0 + 0.5).to(dtype)
    # A cotangent with a mean, as a loss gives it: the mean(g) term counts.
    dy = (rand(n, d) + 0.25).to(dtype)
    scale = (rand(d) * 0.3 + 1.0).to(dtype)
    bias = (rand(d) * 0.1).to(dtype) if c["bias"] else None
    with torch.no_grad():
        _, mean, rstd = fn.norm_forward(x, scale, bias, NORM_EPS, center)
        got = fn.layernorm_backward(x, dy, scale, mean, rstd, center)
        again = fn.layernorm_backward(x, dy, scale, mean, rstd, center)
        torch.cuda.synchronize()
        ref = fn.layernorm_backward_reference(
            x.float(), dy.float(), scale.float(), mean, rstd, center)
    # Two runs: dscale and dbias are summed in a fixed order, dx row by
    # row, so all three are bit-equal.
    repro = dict(dscale_dbias_bit_equal=bool(torch.equal(got[1], again[1])
                                             and torch.equal(got[2],
                                                             again[2])),
                 dx_bit_equal=bool(torch.equal(got[0], again[0])))
    del again

    def errors(dx, dscale, dbias):
        return {"dx": row_errors(dx, ref[0], NORM_ROW_FLOOR),
                "dscale": _norm_rel(dscale, ref[1]),
                "dbias": _norm_rel(dbias, ref[2])}

    e = errors(*got)
    plan = fn.norm_launch_plan(n, d, torch.cuda.get_device_properties(
        0).multi_processor_count, x.element_size(), d % fn.CHUNK == 0)
    out = dict(case=c["case"], n=n, d=d, dtype=c["dtype"], center=center,
               dx_dtype=str(got[0].dtype), max_abs_err=e["dx"]["max_abs"],
               repro=repro, plan={k: plan[k] for k in (
                   "warps_per_row", "rows_per_group", "stages",
                   "blocks_per_sm", "blocks", "smem_bytes")},
               **e)
    ok = (norm_ok(e) and got[0].dtype == dtype and got[0].shape == x.shape
          and all(repro.values()))

    if c.get("plant"):
        # The check on planted faults, each of which must fail it: the
        # mean(g) term left out of dx; the first block's partial row of
        # dscale lost.
        g32 = dy.float() * scale.float()
        no_mean = (got[0].float()
                   + rstd[:, None] * g32.mean(-1, keepdim=True)).to(dtype)
        run = plan["rows_per_block"]
        xhat = (x[:run].float() - mean[:run, None]) * rstd[:run, None]
        lost = got[1] - (dy[:run].float() * xhat).sum(0)
        faults = {}
        for name, f in (("mean_g_term_dropped", (no_mean, got[1], got[2])),
                        ("first_partial_row_lost", (got[0], lost, got[2]))):
            fe = errors(*f)
            faults[name] = dict(dx_row=fe["dx"]["row"],
                                dx_norm=fe["dx"]["norm"],
                                dscale=fe["dscale"], caught=not norm_ok(fe))
        out["planted_faults"] = faults
        ok = ok and all(f["caught"] for f in faults.values())
    out["ok"] = ok

    if c.get("timed"):
        item = x.element_size()
        nbytes = 3.0 * n * d * item + 8.0 * n + item * d + 8.0 * d
        flops = 14.0 * n * d
        b_ms, b_by = bound(nbytes, flops, PEAK_FP32_FLOPS)

        def kernel():
            fn.layernorm_backward(x, dy, scale, mean, rstd, center)

        def plain():
            fn.layernorm_backward_reference(x, dy, scale, mean, rstd, center)

        timed = dict(ms=device_ms(kernel), eager_ms=eager_ms(kernel),
                     plain_ms=device_ms(plain, iters=5, replays=3),
                     bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                     library_ms=None)
        if center:
            # The yardstick, never called by the port: ATen's layer-norm
            # backward on its own forward's statistics.
            w = scale
            b = bias if bias is not None else torch.zeros_like(scale)
            _, l_mean, l_rstd = torch.ops.aten.native_layer_norm(
                x, [d], w, b, NORM_EPS)

            def library():
                torch.ops.aten.native_layer_norm_backward(
                    dy, x, [d], l_mean, l_rstd, w, b, [True, True, True])

            timed["library_ms"] = device_ms(library)
            timed["library"] = "torch.ops.aten.native_layer_norm_backward"
        out["timed"] = timed
    return out


def norm_kernel_checks(gen):
    cases = [check_norm_case(c, gen) for c in NORM_CASES]
    emit({"phase": "norm_kernel_checks",
          "tolerance": {"dx_row": NORM_ROW_TOL, "dx_norm": NORM_NORM_TOL,
                        "dscale_dbias_norm": NORM_PARAM_TOL,
                        "row_floor": NORM_ROW_FLOOR},
          "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"fused norm backward kernel disagrees on {bad}")
    return cases


QUANT_CASES = [
    # The largest leaf of GPT-2 1.5B's layer-stacked tree (mlp.wi / mlp.wo).
    dict(case="largest_leaf", shape=(48, 1600, 6400), dtype="bf16",
         timed=True),
    # One layer's share of it: the planted faults.
    dict(case="one_layer", shape=(1600, 6400), dtype="bf16", plant=True),
    # Tails: 5005 = 19 x 256 + 141 and 4099 = 16 x 256 + 3.
    dict(case="ragged_bf16", shape=(5, 1001), dtype="bf16"),
    dict(case="ragged_fp32", shape=(4099,), dtype="fp32"),
]
QUANT_LEAF_CASE = "largest_leaf"


def _code_diff(bits, which, got, want):
    """Share of codes that differ and the largest difference in levels."""
    from dlrover_tpu_torch.ops import quantization as tq

    if bits == 8:
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        return float((diff > 0).float().mean()), int(diff.max())
    unpack = (tq.unpack_nibbles_signed if which == "m"
              else tq.unpack_nibbles_unsigned)
    share, worst = 0.0, 0
    rows = 1 << 16   # unpacked in slabs: the codes widen 8x to fp32
    for r0 in range(0, got.shape[0], rows):
        diff = (unpack(got[r0:r0 + rows]) - unpack(want[r0:r0 + rows])).abs()
        share += float((diff > 0).sum())
        worst = max(worst, int(diff.max()))
    return share / (got.shape[0] * 256), worst


def _adam_errors(bits, got, ref):
    """A low-bit Adam result ``(upd, m, v)`` against the plain version's:
    the update by norm and by the share of values that differ at all, the
    codes by the share off and the largest difference in levels, the
    scales by their largest relative difference."""
    out = {"upd_norm": _norm_rel(got[0], ref[0]),
           "upd_differ_share": float((got[0] != ref[0]).float().mean()),
           "finite": bool(torch.isfinite(got[0].float()).all())}
    for which, g, r in (("m", got[1], ref[1]), ("v", got[2], ref[2])):
        share, worst = _code_diff(bits, which, g.q, r.q)
        out[f"{which}_codes_off_share"] = share
        out[f"{which}_codes_max_levels_off"] = worst
        out[f"{which}_scales_rel"] = float(
            ((g.scales - r.scales).abs() / r.scales.abs()).max())
    return out


def adam_ok(e) -> bool:
    return (e["finite"] and e["upd_norm"] <= QUANT_UPD_NORM_TOL
            and all(e[f"{w}_codes_off_share"] <= QUANT_CODE_SHARE
                    and e[f"{w}_codes_max_levels_off"] <= 1
                    and e[f"{w}_scales_rel"] <= QUANT_SCALE_RTOL
                    for w in ("m", "v")))


def _clone_moment(mom):
    return type(mom)(mom.q.clone(), mom.scales.clone())


def check_quant_case(c, gen):
    """K5a and K5b against their plain versions and as a round trip, then
    K6 and K7 against theirs from a state K5a made of a random first
    moment and a plain-made second moment (random codes and scales)."""
    from dlrover_tpu_torch.ops import quantization as tq

    shape = c["shape"]
    dtype = torch.bfloat16 if c["dtype"] == "bf16" else torch.float32
    n = int(np.prod(shape))
    rows = tq.num_blocks(n)

    def rand(*s):
        return torch.randn(s, generator=gen, device="cuda")

    def randint(lo, hi, *s):
        return torch.randint(lo, hi, s, generator=gen, device="cuda",
                             dtype=torch.int8)

    p = (rand(*shape) * 0.02).to(dtype)
    g = (rand(*shape) * 1e-3).to(dtype)
    m_true = rand(*shape) * 1e-3
    # The first 64th of the blocks all zero: scale 1, codes 0.
    m_true.reshape(-1)[: (n // (64 * 256)) * 256] = 0.0
    h = tq.adam_hyper(3, TRAIN_LR, 0.9, 0.95, 1e-8, 0.1)
    out = dict(case=c["case"], shape=list(shape), dtype=c["dtype"], n=n,
               blocks=rows, hyper=h._asdict())

    # -- K5a, K5b ---------------------------------------------------------------
    q, scales = tq.quantize(m_true)
    back = tq.dequantize(q, scales, shape)
    torch.cuda.synchronize()
    q_ref, s_ref = tq.quantize_reference(m_true)
    share, worst = _code_diff(8, "m", q, q_ref)
    half_level = scales.repeat_interleave(256)[:n].reshape(shape) * 0.5
    out["quantize"] = dict(
        codes_off_share=share, codes_max_levels_off=worst,
        scales_rel=float(((scales - s_ref).abs() / s_ref).max()),
        zero_blocks=int((scales == 1.0).sum()))
    out["dequantize"] = dict(
        max_abs_err=float((back - tq.dequantize_reference(
            q, scales, shape)).abs().max()),
        round_trip_within_half_a_level=bool(
            # x / scale is off by up to an ulp of 127: 1.5e-5 of a level.
            ((back - m_true).abs() <= half_level * (1 + 1e-4)).all()))
    ok = (share == 0.0 and out["quantize"]["scales_rel"] <= QUANT_SCALE_RTOL
          and out["dequantize"]["max_abs_err"] == 0.0
          and out["dequantize"]["round_trip_within_half_a_level"]
          and q.shape == (rows, 256) and back.shape == tuple(shape))
    del back, q_ref, s_ref, half_level

    # -- K6, K7 -------------------------------------------------------------------
    states = {
        8: (tq.QMoment(q, scales),
            tq.QMoment(randint(0, 128, rows, 256),
                       torch.rand((rows,), generator=gen, device="cuda")
                       * 1e-6 + 1e-9)),
        4: (tq.QMoment(tq.pack_nibbles(randint(-7, 8, rows, 256)),
                       torch.rand((rows,), generator=gen, device="cuda")
                       * 1e-3 + 1e-6),
            tq.QMoment(tq.pack_nibbles(randint(0, 16, rows, 256)),
                       torch.rand((rows,), generator=gen, device="cuda")
                       * 1e-6 + 1e-9)),
    }
    del m_true
    updates = {8: (tq.q8_adam_update, tq.q8_adam_update_reference),
               4: (tq.q4_adam_update, tq.q4_adam_update_reference)}
    max_err = 0.0
    for bits, (kernel, plain) in updates.items():
        m0, v0 = states[bits]
        ref = plain(g, p, m0, v0, h)
        got = kernel(g, p, _clone_moment(m0), _clone_moment(v0), h)
        torch.cuda.synchronize()
        e = _adam_errors(bits, got, ref)
        e["upd_max_abs_err"] = float(
            (got[0].float() - ref[0].float()).abs().max())
        max_err = max(max_err, e["upd_max_abs_err"])
        out[f"q{bits}_adam"] = e
        ok = ok and adam_ok(e) and got[0].dtype == dtype
        if c.get("plant"):
            out[f"q{bits}_planted_fault"] = _quant_planted_fault(
                bits, g, p, m0, v0, h, ref)
            ok = ok and out[f"q{bits}_planted_fault"]["caught"]
        del got, ref
    out["max_abs_err"] = max_err
    out["ok"] = ok

    if c.get("timed"):
        item = p.element_size()
        timed = {}

        def add(name, kernel, plain, nbytes, flops):
            b_ms, b_by = bound(nbytes, flops, PEAK_FP32_FLOPS)
            ms = device_ms(kernel, iters=5, replays=3)
            timed[name] = dict(
                ms=ms, eager_ms=eager_ms(kernel, iters=5),
                # Eager, back to back: passes over gigabytes, where launch
                # gaps count for nothing and a graph's private pool would
                # double the temporaries.
                plain_ms=eager_ms(plain, iters=2, warmup=1),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                gbytes_per_s=nbytes / ms / 1e6,
                # No one PyTorch call computes a block quantization or a
                # quantized Adam step.
                library_ms=None)
            torch.cuda.empty_cache()

        m32 = tq.dequantize(q, scales, shape)
        add("quantize", lambda: tq.quantize(m32),
            lambda: tq.quantize_reference(m32), 5.0 * n + 4.0 * rows, 4.0 * n)
        add("dequantize", lambda: tq.dequantize(q, scales, shape),
            lambda: tq.dequantize_reference(q, scales, shape),
            5.0 * n + 4.0 * rows, 1.0 * n)
        del m32
        for bits, (kernel, plain) in updates.items():
            m0, v0 = states[bits]
            mk, vk = _clone_moment(m0), _clone_moment(v0)
            # g and p read and the update written; both moments' codes
            # and scales read and written.
            nbytes = 3.0 * item * n + 4.0 * n * bits / 8 + 16.0 * rows
            add(f"q{bits}_adam",
                lambda kernel=kernel, mk=mk, vk=vk: kernel(g, p, mk, vk, h),
                lambda plain=plain, m0=m0, v0=v0: plain(g, p, m0, v0, h),
                nbytes, 40.0 * n)
        out["timed"] = timed
    del states, p, g
    torch.cuda.empty_cache()
    return out


def _quant_planted_fault(bits, g, p, m, v, h, ref):
    """The check on a planted fault, which must fail it.  q8: the second
    moment decoded linearly (code / 127 times the scale) where the map is
    the 4th root.  q4: the high nibble of every byte of m and v dropped
    (the odd elements' moments read as 0)."""
    from dlrover_tpu_torch.ops import quantization as tq

    if bits == 8:
        m32 = m.q.float() * m.scales[:, None]
        v32 = v.q.float() * (1.0 / 127.0) * v.scales[:, None]
        upd, m32, v32 = tq._adam(h, tq._to_blocks(g), tq._to_blocks(p), m32,
                                 v32)
        v_codes, v_scale = tq._root4_codes(v32, 127.0)
        got = (tq._from_blocks(upd, p), tq.QMoment(*tq._absmax_int8(m32)),
               tq.QMoment(v_codes.to(torch.int8), v_scale))
        name = "v_decoded_linearly"
    else:
        def low(mom):
            return tq.QMoment((mom.q.view(torch.uint8) & 0xF).view(
                torch.int8), mom.scales)

        got = tq.q4_adam_update_reference(g, p, low(m), low(v), h)
        name = "high_nibble_dropped"
    e = _adam_errors(bits, got, ref)
    return dict(fault=name, upd_norm=e["upd_norm"],
                m_codes_off_share=e["m_codes_off_share"],
                v_codes_off_share=e["v_codes_off_share"],
                caught=not adam_ok(e))


def quant_kernel_checks(gen):
    cases = [check_quant_case(c, gen) for c in QUANT_CASES]
    emit({"phase": "quant_kernel_checks",
          "tolerance": {"codes_off_share": QUANT_CODE_SHARE,
                        "codes_max_levels_off": 1,
                        "scales_rtol": QUANT_SCALE_RTOL,
                        "upd_norm": QUANT_UPD_NORM_TOL,
                        "quantize_codes": "equal"},
          "library": None, "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"quantization kernels disagree on {bad}")
    return cases


def pin_kernel_check(gen):
    """K11 on the attention's input at the training shape, contiguous and
    as a transposed view, and on a sliced, expanded odd-sized view: the
    result is contiguous and bit-equal to its input."""
    from dlrover_tpu_torch.ops import layout_pin as lp

    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, 1600), generator=gen,
                    device="cuda").to(torch.bfloat16)
    odd = torch.randn((7, 1, 33), generator=gen, device="cuda")
    views = {
        "contiguous": x,
        "transposed": x.transpose(1, 2),
        "sliced_expanded_fp32": odd.expand(7, 5, 33)[1:, :, 2::3],
        "bytes": (x[0, :77, :13].contiguous().view(torch.uint8))[:, 3:],
    }
    results, ok = {}, True
    for name, view in views.items():
        out = lp.pin_copy(view)
        torch.cuda.synchronize()
        res = dict(shape=list(view.shape), strides=list(view.stride()),
                   merged_dims=lp.merged_dims(view),
                   contiguous_in=view.is_contiguous(),
                   contiguous_out=out.is_contiguous(),
                   bit_equal=bool(torch.equal(out, view)),
                   new_storage=out.data_ptr() != view.data_ptr())
        results[name] = res
        ok = (ok and res["contiguous_out"] and res["bit_equal"]
              and res["new_storage"] and out.dtype == view.dtype)
    nbytes = 2.0 * x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, 0.0)
    xt = views["transposed"]
    # The kernel against clone() in PIN_PAIRS alternating pairs: one
    # reading of each is within a few per cent of the other.
    pairs = [(device_ms(lambda: lp.pin_copy(x)),
              device_ms(lambda: x.clone())) for _ in range(PIN_PAIRS)]
    kernel_ms, clone_ms = ([p[i] for p in pairs] for i in (0, 1))
    timed = dict(
        ms=statistics.median(kernel_ms),
        eager_ms=eager_ms(lambda: lp.pin_copy(x)),
        transposed_ms=device_ms(lambda: lp.pin_copy(xt)),
        plain_ms=device_ms(lambda: lp.pin_layout_reference(x)),
        plain_transposed_ms=device_ms(lambda: lp.pin_layout_reference(xt)),
        library_ms=statistics.median(clone_ms), library="Tensor.clone()",
        pairs=dict(kernel_ms=kernel_ms, clone_ms=clone_ms,
                   kernel_spread_ms=max(kernel_ms) - min(kernel_ms),
                   clone_spread_ms=max(clone_ms) - min(clone_ms),
                   kernel_faster_in=sum(a < b for a, b in pairs)),
        share_of_bound=b_ms / statistics.median(kernel_ms),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    res = {"phase": "pin_kernel_check", "views": results, "timed": timed,
           "max_abs_err": 0.0 if ok else float("nan"), "ok": ok}
    emit(res)
    if not ok:
        raise AssertionError(f"pin_layout kernel disagrees: {results}")
    return res


#: Rounds of ``--ab``: other, change, change, other each.
AB_ROUNDS = 2
#: Causal grids beside the split ``BWD_CASES`` at which ``time_kernels``
#: reads K2a, from about 1 to 12 waves of its 128-row blocks on 132 SMs:
#: D 64 at the training step's heads and length, and GQA 32/8 at D 128.
DQ_GRID_CASES = [
    dict(case=f"grid_b{b}_s1024", b=b, s=1024, hq=25, hkv=25, d=64,
         causal=True) for b in (1, 2, 4, 8)
] + [
    dict(case=f"grid_d128_b{b}_s{s}", b=b, s=s, hq=32, hkv=8, d=128,
         causal=True) for b, s in ((1, 512), (1, 1024), (4, 1024))
]


def time_kernels():
    """K2a and K4 of whichever package is first on ``sys.path``, through
    the public wrappers (whose signatures have not changed since the
    kernels were first ported), at the main paths' shapes: K2a at the
    split ``BWD_CASES`` and at ``DQ_GRID_CASES``, K4 at the timed
    ``NORM_CASES``.  Device ms, the median of three CUDA-graph
    readings."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for c in [c for c in BWD_CASES if c["kernel"] == "split"] + \
            DQ_GRID_CASES:
        q, k, v, _, _ = _case_inputs(c, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, lse = fa.flash_fwd(q, k, v, causal=c["causal"])
        out[f"flash_bwd_dq/{c['case']}"] = statistics.median(
            device_ms(lambda: fa.flash_bwd_dq(q, k, v, o, lse, do,
                                              causal=c["causal"]))
            for _ in range(3))
        del q, k, v, o, lse, do
    for c in NORM_CASES:
        if not c.get("timed"):
            continue
        n, d, center = c["n"], c["d"], c["center"]
        x = (torch.randn((n, d), generator=gen, device="cuda") * 2.0
             + 0.5).bfloat16()
        dy = (torch.randn((n, d), generator=gen, device="cuda")
              + 0.25).bfloat16()
        scale = torch.randn((d,), generator=gen, device="cuda") * 0.3 + 1.0
        _, mean, rstd = fn.norm_forward(x, scale, None, NORM_EPS, center)
        out[f"norm_bwd/{c['case']}"] = statistics.median(
            device_ms(lambda: fn.layernorm_backward(x, dy, scale, mean, rstd,
                                                    center))
            for _ in range(3))
    return out


def ab_in_turns(others):
    """``time_kernels`` of each tree in ``others`` (a ``git archive`` of
    the parent commit, or a copy of this tree with one constant changed,
    each of which builds its own kernels there; named by its directory)
    and of this tree, each reading in a process of its own, in turns:
    other, change, change, other for each tree, ``AB_ROUNDS`` times."""
    trees = {os.path.basename(os.path.normpath(t)): os.path.abspath(t)
             for t in others}
    for name, path in trees.items():
        if name == "change" or not os.path.isdir(
                os.path.join(path, "dlrover_tpu_torch")):
            raise FileNotFoundError(f"no other tree at {path}")
    order = [who for _ in range(AB_ROUNDS) for name in trees
             for who in (name, "change", "change", name)]
    trees["change"] = REPO
    readings = {name: [] for name in trees}
    for who in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-tree",
             trees[who]], capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"--time-tree {trees[who]} failed "
                               f"(rc {res.returncode}):\n{res.stderr[-4000:]}")
        readings[who].append(json.loads(res.stdout.splitlines()[-1])["ms"])
    names = sorted(readings["change"][0])
    median = {who: {n: statistics.median(r[n] for r in rs) for n in names}
              for who, rs in readings.items()}
    emit({"phase": "ab_in_turns", "order": order, "readings": readings,
          "median_ms": median,
          "over_change": {who: {n: median[who][n] / median["change"][n]
                                for n in names}
                          for who in trees if who != "change"}})


def _state_bytes(obj) -> int:
    """Bytes of every tensor in a nested optimizer state."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_state_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_state_bytes(v) for v in obj)
    return 0


def lowbit_config(**overrides):
    """The dense step with its opt-in kernels on."""
    from dlrover_tpu_torch.models import gpt2_config

    return gpt2_config("1.5b", attention_impl="flash", remat="flash_only",
                       param_dtype=torch.bfloat16, fused_ln=True,
                       pin_attn_layouts=True, **overrides)


def _lowbit_per_step(cfg, opt_state, bits):
    """Launches per step, from the config and the optimizer state: per
    layer the flash forward once (saved) and the fused backward once; K4
    once per block norm (two) in the backward, ``ln_final`` staying
    unfused; K11 twice in the forward, twice in the ``flash_only``
    recompute and twice on the cotangents; K6 (or K7) once per quantized
    leaf of the layer-stacked tree."""
    from dlrover_tpu_torch.ops import quantization as tq

    quantized = sum(isinstance(m, tq.QMoment) for m in opt_state[-1].m.values())
    n_layers = cfg.num_layers
    return _per_step(flash_fwd=n_layers, flash_bwd_fused=n_layers,
                     norm_bwd=2 * n_layers, pin_copy=6 * n_layers,
                     **{f"q{bits}_adam": quantized}), quantized


def train_lowbit_and_check(adafactor_state_bytes):
    """The dense step with ``fused_ln``, ``pin_attn_layouts`` and
    ``q8_adam``, then ``q4_adam``, at full width and depth; returns each
    run's counts."""
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.trainer import train_lib

    cfg = lowbit_config()
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ftok = flops_per_token(cfg, TRAIN_SEQ)
    ftok_hw = ftok + recompute_flops_per_token(cfg, "flash_only", TRAIN_SEQ)
    counts = {}
    for bits, warmup, steps in ((8, TRAIN_WARMUP, LOWBIT_STEPS),
                                (4, 1, LOWBIT_Q4_STEPS)):
        name = f"q{bits}_adam"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer(name, learning_rate=TRAIN_LR,
                                          grad_clip=1.0),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, ce_chunks=0,
            device="cuda",
        )
        state = train.init(seed=0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in state.model.parameters())
        per_step, quantized = _lowbit_per_step(cfg, state.opt_state, bits)
        state_bytes = _state_bytes(state.opt_state)

        # -- the main path, counted --------------------------------------------
        _zero_counts()
        state, warm_losses, warm_s = _train_steps(train, state, batch,
                                                  warmup, per_step)
        state, losses, seconds = _train_steps(train, state, batch, steps,
                                              per_step)
        # Read a first moment back in fp32 (K5b) and requantize it (K5a),
        # as a caller that inspects or re-blocks the state does.
        leaf = "blocks.mlp.wi.kernel"
        mom = state.opt_state[-1].m[leaf]
        shape = (cfg.num_layers, cfg.d_model, cfg.resolved_d_ff)
        readback = {"leaf": leaf, "shape": list(shape)}
        if bits == 8:
            m32 = tq.dequantize(mom.q, mom.scales, shape)
            q2, s2 = tq.quantize(m32)
            readback.update(
                finite=bool(torch.isfinite(m32).all()),
                abs_max=float(m32.abs().max()),
                requantized_codes_off_share=float(
                    (q2 != mom.q).float().mean()),
                requantized_scales_rel=float(
                    ((s2 - mom.scales).abs() / mom.scales).max()))
            del m32, q2, s2
            if not (readback["finite"] and readback["abs_max"] > 0
                    and readback["requantized_codes_off_share"] <= 1e-3
                    and readback["requantized_scales_rel"] <= 1e-6):
                raise AssertionError(f"q8 state read-back: {readback}")
        run_counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        all_losses = warm_losses + losses
        if not all_losses[-1] < all_losses[0]:
            raise AssertionError(f"{name}: loss did not fall: {all_losses}")
        step_s = statistics.median(seconds)
        tokens_per_s = tokens / step_s
        res = {
            "phase": "train_lowbit", "optimizer": f"{name} lr 1e-4, clip "
            "1.0 (b1 0.9, b2 0.95, weight decay 0.1)",
            "model": "gpt2-1.5b (48 layers, d_model 1600, 25 heads x 64, "
                     "vocab 50304, bf16 params and compute), fused_ln, "
                     "pin_attn_layouts, random weights seed 0",
            "params": n_params, "remat": cfg.remat,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "ce_chunks": 0,
            "losses": all_losses, "warmup_step_s": warm_s,
            "step_s": seconds, "step_s_median": step_s,
            "tokens_per_s": tokens_per_s,
            "mfu": tokens_per_s * ftok / PEAK_BF16_FLOPS,
            "hfu": tokens_per_s * ftok_hw / PEAK_BF16_FLOPS,
            "launches": run_counts, "launches_per_step": per_step,
            "quantized_leaves": quantized,
            "optimizer_state_bytes": state_bytes,
            "optimizer_state_bytes_per_param": state_bytes / n_params,
            "adafactor_state_bytes": adafactor_state_bytes,
            "peak_memory_allocated_bytes": peak, "setup_s": setup_s,
            "state_read_back": readback,
        }
        if bits == 8:
            prof = _profile(lambda: train.step(state, batch), top=28)
            busy = prof.get("device_busy_ms")
            res["profiled_step"] = prof
            res["device_busy_share_of_median_step"] = (
                busy / (step_s * 1e3) if isinstance(busy, float) else
                "not measured")
        emit(res)
        counts[f"train_lowbit_q{bits}"] = run_counts
        del state, train
        torch.cuda.empty_cache()
    return counts


def flags_ab():
    """``python3 chip_smoke.py --flags-ab``: what each opt-in flag costs or
    saves per step with the optimizer held fixed.  The train phase's step
    (Adafactor) under flags off, ``fused_ln``, ``pin_attn_layouts`` and
    both, each setting run twice in mirrored order (off, ln, pin, both,
    both, pin, ln, off), 1 warm-up and 3 measured steps a run."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib

    settings = {"off": {}, "fused_ln": {"fused_ln": True},
                "pin_attn_layouts": {"pin_attn_layouts": True},
                "both": {"fused_ln": True, "pin_attn_layouts": True}}
    order = list(settings) + list(settings)[::-1]
    runs = {name: [] for name in settings}
    for name in order:
        flags = settings[name]
        cfg = gpt2_config("1.5b", attention_impl="flash", remat="flash_only",
                          param_dtype=torch.bfloat16, **flags)
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
        state = train.init(seed=0)
        batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
        n = cfg.num_layers
        per_step = _per_step(
            flash_fwd=n, flash_bwd_fused=n,
            norm_bwd=2 * n if flags.get("fused_ln") else 0,
            pin_copy=6 * n if flags.get("pin_attn_layouts") else 0)
        state, _, _ = _train_steps(train, state, batch, 1, per_step)
        state, losses, seconds = _train_steps(train, state, batch, 3,
                                              per_step)
        runs[name].append({"step_s": seconds,
                           "step_s_median": statistics.median(seconds),
                           "last_loss": losses[-1]})
        del state, train, batch
        torch.cuda.empty_cache()
    medians = {name: [r["step_s_median"] for r in rs]
               for name, rs in runs.items()}
    base = statistics.mean(medians["off"])
    emit({"phase": "flags_ab", "optimizer": "adafactor lr 1e-4, clip 1.0",
          "order": order, "runs": runs,
          "mean_of_medians_s": {k: statistics.mean(v)
                                for k, v in medians.items()},
          "ms_per_step_against_off": {
              k: (statistics.mean(v) - base) * 1e3
              for k, v in medians.items()},
          "off_spread_ms": (max(medians["off"]) - min(medians["off"])) * 1e3})


@contextlib.contextmanager
def _lowbit_swapped(norm_bwd=None, pin=None, adam=None):
    """Swap the wrappers the dense step's opt-in ops call (module globals
    read at call time) while the block runs; yields the kernels'."""
    from dlrover_tpu_torch.ops import fused_norm as fn
    from dlrover_tpu_torch.ops import layout_pin as lp
    from dlrover_tpu_torch.ops import quantization as tq

    kernels = (fn.layernorm_backward, lp.pin_copy, tq._low_bit_update)
    fn.layernorm_backward = norm_bwd or kernels[0]
    lp.pin_copy = pin or kernels[1]
    tq._low_bit_update = adam or kernels[2]
    try:
        yield kernels
    finally:
        fn.layernorm_backward, lp.pin_copy, tq._low_bit_update = kernels


def _lowbit_reference_fns():
    from dlrover_tpu_torch.ops import fused_norm as fn
    from dlrover_tpu_torch.ops import layout_pin as lp
    from dlrover_tpu_torch.ops import quantization as tq

    def adam(bits, g, p, m, v, h):
        plain = (tq.q8_adam_update_reference if bits == 8
                 else tq.q4_adam_update_reference)
        return plain(g, p, m, v, h)

    return fn.layernorm_backward_reference, lp.pin_layout_reference, adam


def _lowbit_grad_ok(loss_diff, gap) -> bool:
    return _parity_ok(loss_diff, gap, (
        LOWBIT_PARITY_LOSS_ATOL, LOWBIT_PARITY_NORM_RTOL,
        LOWBIT_PARITY_MIN_COSINE, LOWBIT_PARITY_PARAM_RTOL))


def _tree_adam_errors(got, ref):
    """The worst of ``_adam_errors`` over the quantized leaves of two
    optimizer results ``(updates, state)``, and the small leaves' update
    error."""
    from dlrover_tpu_torch.ops import quantization as tq

    (g_upd, g_state), (r_upd, r_state) = got, ref
    worst, small = {}, 0.0
    for name, r_m in r_state.m.items():
        if not isinstance(r_m, tq.QMoment):
            small = max(small, _norm_rel(g_upd[name], r_upd[name]))
            continue
        e = _adam_errors(8, (g_upd[name], g_state.m[name], g_state.v[name]),
                         (r_upd[name], r_m, r_state.v[name]))
        for k, val in e.items():
            worst[k] = (min if k == "finite" else max)(worst.get(k, val),
                                                       val)
    worst["small_leaves_upd_norm"] = small
    return worst


def train_lowbit_parity():
    """4 layers, batch 4.  One step's loss and gradients through K4 and
    K11 against the same model with their plain versions swapped in (the
    flash kernels run in both legs), and the same step's optimizer update
    through K6 against the plain update from the same gradients and the
    same non-trivial state (one step old).  One planted fault per kernel
    must fail its check."""
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.optimizers import optax_ports as ox
    from dlrover_tpu_torch.trainer import train_lib

    cfg = lowbit_config(num_layers=PARITY_LAYERS)
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("q8_adam", learning_rate=TRAIN_LR,
                                      grad_clip=1.0),
        global_batch_size=PARITY_BATCH, seq_len=TRAIN_SEQ, device="cuda")
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, PARITY_BATCH)
    state, _ = train.step(state, batch)   # the state the step starts from

    # -- K4, K11: loss and gradients ----------------------------------------------
    model = TransformerLM(cfg, device="cuda")
    model.load_state_dict(state.model.state_dict())

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
    got = {k: after[k] - before[k] for k in after}
    want = _per_step(flash_fwd=PARITY_LAYERS, flash_bwd_fused=PARITY_LAYERS,
                     norm_bwd=2 * PARITY_LAYERS, pin_copy=6 * PARITY_LAYERS)
    if got != want:
        raise AssertionError(f"lowbit parity kernel leg launched {got}, "
                             f"want {want}")
    ref_norm, ref_pin, ref_adam = _lowbit_reference_fns()
    with _lowbit_swapped(ref_norm, ref_pin):
        r_loss, r_grads = loss_and_grads()
    end = _counts()
    if (end["norm_bwd"], end["pin_copy"]) != (after["norm_bwd"],
                                              after["pin_copy"]):
        raise AssertionError("the reference leg launched K4 or K11")
    gap = _grad_gap(k_grads, r_grads)
    k2_loss, k2_grads = loss_and_grads()
    rerun = _grad_gap(k2_grads, k_grads)
    del k2_grads
    out = {
        "phase": "train_lowbit_parity", "layers": PARITY_LAYERS,
        "batch": PARITY_BATCH, "seq": TRAIN_SEQ,
        "loss_kernel": k_loss, "loss_reference": r_loss,
        "loss_abs_diff": abs(k_loss - r_loss), **gap,
        "kernel_rerun": {"loss_abs_diff": abs(k2_loss - k_loss),
                         **{k_: rerun[k_] for k_ in (
                             "grad_norm_rel_diff", "min_grad_cosine",
                             "max_grad_rel_err")}},
        "limits": {"loss_atol": LOWBIT_PARITY_LOSS_ATOL,
                   "grad_norm_rtol": LOWBIT_PARITY_NORM_RTOL,
                   "min_grad_cosine": LOWBIT_PARITY_MIN_COSINE,
                   "max_grad_rel_err": LOWBIT_PARITY_PARAM_RTOL,
                   "adam": {"codes_off_share": QUANT_CODE_SHARE,
                            "scales_rtol": QUANT_SCALE_RTOL,
                            "upd_norm": QUANT_UPD_NORM_TOL}},
    }
    grads_ok = _lowbit_grad_ok(out["loss_abs_diff"], gap)

    faults = {}
    with _lowbit_swapped() as (kernel_norm, kernel_pin, _):
        def faulty_norm(x, dy, scale, mean, rstd, center=True):
            # The second half of the rows' dx a tenth short.
            dx, dscale, dbias = kernel_norm(x, dy, scale, mean, rstd, center)
            half = dx.reshape(-1, dx.shape[-1])
            half[half.shape[0] // 2:] *= 0.9
            return dx, dscale, dbias

        def faulty_pin(x):
            # The last 64 features never copied.
            out_ = kernel_pin(x)
            out_[..., -64:] = 0
            return out_

        for name, fns in (("norm_dx_late_rows_short", (faulty_norm, None)),
                          ("pin_tail_not_copied", (None, faulty_pin))):
            with _lowbit_swapped(*fns):
                f_loss, f_grads = loss_and_grads()
            f_gap = _grad_gap(f_grads, r_grads)
            faults[name] = {k_: f_gap[k_] for k_ in (
                "grad_norm_rel_diff", "min_grad_cosine", "max_grad_rel_err",
                "max_grad_rel_err_param")}
            faults[name]["loss_abs_diff"] = abs(f_loss - r_loss)
            faults[name]["caught"] = not _lowbit_grad_ok(abs(f_loss - r_loss),
                                                         f_gap)
            del f_grads
    del r_grads, model

    # -- K6: the update, from the kernel leg's gradients ---------------------------
    grad_tree = ox.stack_layers(
        {n: g.to(torch.bfloat16) for n, g in k_grads.items()})
    del k_grads
    params = train_lib._param_tree(state.model)

    def clone_state(s):
        clip, adam = s
        def moments(tree):
            return {k: (_clone_moment(v) if hasattr(v, "q") else v.clone())
                    for k, v in tree.items()}
        return clip, type(adam)(adam.count, moments(adam.m), moments(adam.v))

    def update(adam_fn=None):
        with _lowbit_swapped(adam=adam_fn):
            upd, (_, new) = train.optimizer.update(
                grad_tree, clone_state(state.opt_state), params)
        return upd, new

    before = _counts()["q8_adam"]
    k_out = update()
    launched = _counts()["q8_adam"] - before
    r_out = update(ref_adam)
    if _counts()["q8_adam"] != before + launched or launched == 0:
        raise AssertionError("the update legs launched K6 "
                             f"{_counts()['q8_adam'] - before} times")
    adam_e = _tree_adam_errors(k_out, r_out)
    out["adam"] = {"k6_launches": launched, **adam_e}
    adam_fine = adam_ok(adam_e) and adam_e["small_leaves_upd_norm"] <= 1e-6

    with _lowbit_swapped() as (_, _, kernel_adam):
        def faulty_adam(bits, g, p, m, v, h):
            # The first moment's scales written at half their value.
            upd, m, v = kernel_adam(bits, g, p, m, v, h)
            m.scales.mul_(0.5)
            return upd, m, v

        f_e = _tree_adam_errors(update(faulty_adam), r_out)
    faults["adam_m_scales_halved"] = {
        "m_scales_rel": f_e["m_scales_rel"], "upd_norm": f_e["upd_norm"],
        "caught": not adam_ok(f_e)}
    out["planted_faults"] = faults
    out["ok"] = grads_ok and adam_fine
    emit(out)
    if not out["ok"] or not all(f["caught"] for f in faults.values()):
        raise AssertionError(f"lowbit train parity failed: {out}")
    del state, train, grad_tree, params, k_out, r_out
    torch.cuda.empty_cache()


# -- embedding plane -----------------------------------------------------------

# The hot-row cache's kernels K10a/K10b (``embedding/kernels.py``).  Cases:
# (name, capacity, dim, slots, real slots).  Real slots are distinct and
# nonzero; the rest of the padded array points at the scratch slot 0, whose
# scattered rows are zero, as the cache pads them.  The slice case is the
# CTR loop's: a 4,194,304-row cache of dim 128 (2.15 GB), 32,768 padded
# slots, about as many real ones as a batch there has unique keys.
EMBED_CASES = [
    ("slice", 4_194_304, 128, 32_768, 17_300),
    ("dim16", 8_192, 16, 4_096, 2_500),
    ("dim129_unaligned", 8_192, 129, 4_096, 2_500),
    ("single_slot", 64, 128, 1, 1),
    ("scratch_duplicates", 1_024, 128, 8, 3),
]
EMBED_SLICE_CASE = "slice"
# ``train_rec`` at MLPerf DLRM width (Criteo 1TB: 26 categorical features,
# embedding dim 128, max_ind_range 40M, top MLP opening at 1024, 8,192
# examples per chip of the 65,536 global batch): 1 warm-up + 30 measured
# steps, a 4 -> 3 fold after step 16, 4,194,304 cached rows on the card.
REC_ARGV = [
    "--steps", "31", "--batch-size", "8192", "--fields", "26", "--dim",
    "128", "--id-space", "40000000", "--hidden", "1024", "--lr", "0.01",
    "--world", "4", "--num-buckets", "64", "--cache-rows", "4194304",
    "--max-unique", "32768", "--prefetch-depth", "2", "--sparse-optimizer",
    "adam", "--reshard-at", "16:3",
]
REC_WARMUP, REC_PROFILED_STEP, REC_HOST_PROFILED_STEP = 1, 21, 23
REC_FAULT_STEPS = 3
REC_CHECK_GATHERS = 1  # K10a launches a step made by the invariant check
EMBED_TIMED_SETS = 8


def _embed_case(name, capacity, dim, n, real, rng, gen):
    slots = np.zeros(n, np.int32)
    chosen = rng.choice(capacity - 1, size=real, replace=False) + 1
    if name == "scratch_duplicates":
        slots[0::2][:real] = chosen  # [a, 0, b, 0, c, 0, 0, 0]
    else:
        slots[:real] = chosen
    rows = rng.standard_normal((n, dim)).astype(np.float32)
    rows[slots == 0] = 0.0
    cache = torch.randn((capacity, dim), generator=gen, device="cuda")
    return cache, slots, rows


def _gather_fault(gather):
    """A gather that reads ``slots[i] + 1``."""
    def faulty(cache, slots):
        return gather(cache, (np.asarray(slots, np.int64) + 1)
                      % cache.shape[0])
    return faulty


def _scatter_fault(scatter):
    """A scatter that drops the last real (nonzero) slot's row."""
    def faulty(cache, slots, rows):
        slots = np.asarray(slots)
        keep = np.ones(slots.shape, bool)
        real = np.nonzero(slots)[0]
        if real.size:
            keep[real[-1]] = False
        return scatter(cache, slots[keep], np.asarray(rows)[keep])
    return faulty


def _embed_check(gather, scatter, cache, slots, rows):
    """Bit-equality of a gather and a scatter with the plain versions."""
    from dlrover_tpu_torch.embedding import kernels as ek

    s_dev = torch.from_numpy(slots).cuda()
    got = gather(cache, slots)
    want = ek.gather_rows_reference(cache, s_dev)
    kc, rc = cache.clone(), cache.clone()
    scatter(kc, slots, rows)
    ek.scatter_rows_reference_(rc, s_dev, torch.from_numpy(rows).cuda())
    torch.cuda.synchronize()
    return {
        "gather_bit_equal": bool(torch.equal(got, want)),
        "gather_max_abs_err": float((got - want).abs().max()),
        "scatter_bit_equal": bool(torch.equal(kc, rc)),
        "scatter_max_abs_err": float((kc - rc).abs().max()),
        "new_storage": got.data_ptr() != cache.data_ptr(),
    }


def embed_kernel_checks(gen):
    """K10a and K10b against their plain versions, bit for bit, at the CTR
    loop's shape, at dim 16, at the unaligned dim 129, for one slot and
    for a scatter whose only duplicates are slot 0 with zero rows; two
    planted faults must fail.  Times at the slice case."""
    from dlrover_tpu_torch.embedding import kernels as ek

    rng = np.random.default_rng(0)
    results, ok, timed = {}, True, {}
    for name, capacity, dim, n, real in EMBED_CASES:
        cache, slots, rows = _embed_case(name, capacity, dim, n, real, rng,
                                         gen)
        res = dict(capacity=capacity, dim=dim, slots=n, real=real,
                   **_embed_check(ek.gather_rows, ek.scatter_rows, cache,
                                  slots, rows))
        ok = ok and res["gather_bit_equal"] and res["scatter_bit_equal"] \
            and res["new_storage"]
        if name == EMBED_SLICE_CASE:
            faults = _embed_check(_gather_fault(ek.gather_rows),
                                  _scatter_fault(ek.scatter_rows), cache,
                                  slots, rows)
            res["faults"] = {
                "gather_reads_next_slot_caught":
                    not faults["gather_bit_equal"],
                "scatter_drops_last_row_caught":
                    not faults["scatter_bit_equal"],
            }
            ok = ok and all(res["faults"].values())
            timed = _embed_times(cache, slots, rows, rng)
        results[name] = res
        del cache
    torch.cuda.empty_cache()
    res = {"phase": "embed_kernel_checks", "cases": results, "timed": timed,
           "max_abs_err": max(max(r["gather_max_abs_err"],
                                  r["scatter_max_abs_err"])
                              for r in results.values()),
           "ok": ok}
    emit(res)
    if not ok:
        raise AssertionError(f"embedding row kernels disagree: {results}")
    return res


def _embed_times(cache, slots, rows, rng):
    """Kernel, plain and library device times at one case, and the bound
    from the bytes this case's slots need, 4 bytes a slot besides: the
    gather reads each distinct cache row once and writes every slot's row;
    the scatter writes each distinct slot once, from the one row of
    ``rows`` that lands there (the last of a run of equal slots), so it
    reads and writes ``distinct`` rows.
    The timed calls cycle through ``EMBED_TIMED_SETS`` slot and row sets,
    as many bytes as twice the 50 MB L2, so each call finds its rows in
    device memory as a training step does."""
    from dlrover_tpu_torch.embedding import kernels as ek

    n, dim = rows.shape
    capacity = cache.shape[0]
    real = int(np.count_nonzero(slots))
    sets = []
    for _ in range(EMBED_TIMED_SETS):
        s = np.zeros_like(slots)
        s[:real] = rng.choice(capacity - 1, size=real, replace=False) + 1
        r = rng.standard_normal(rows.shape).astype(np.float32)
        r[s == 0] = 0.0
        s_dev = torch.from_numpy(s).cuda()
        sets.append((s, s_dev, s_dev.long(), torch.from_numpy(r).cuda(), r))
    distinct = len(np.unique(slots))
    row_bytes = dim * 4
    kc, rc = cache.clone(), cache.clone()

    def cycled(fn):
        it = itertools.cycle(sets)
        return lambda: fn(*next(it))

    out = {}
    for kind, nbytes, kernel, plain, library, wrapper in (
            ("gather", (distinct + n) * row_bytes + 4 * n,
             lambda s, sd, s64, rd, r: ek.gather_kernel(cache, sd),
             lambda s, sd, s64, rd, r: ek.gather_rows_reference(cache, sd),
             lambda s, sd, s64, rd, r: cache.index_select(0, s64),
             lambda s, sd, s64, rd, r: ek.gather_rows(cache, s)),
            ("scatter", 2 * distinct * row_bytes + 4 * n,
             lambda s, sd, s64, rd, r: ek.scatter_kernel(kc, sd, rd),
             lambda s, sd, s64, rd, r: ek.scatter_rows_reference_(rc, sd,
                                                                  rd),
             lambda s, sd, s64, rd, r: rc.index_copy_(0, s64, rd),
             lambda s, sd, s64, rd, r: ek.scatter_rows(kc, s, r))):
        b_ms, b_by = bound(nbytes, 0.0)
        out[kind] = dict(
            ms=device_ms(cycled(kernel)), plain_ms=device_ms(cycled(plain)),
            library_ms=device_ms(cycled(library)),
            library="Tensor.index_select" if kind == "gather"
            else "Tensor.index_copy_",
            # The wrapper from host slots (and host rows): range check,
            # uploads and the launch, as the cache calls it.
            wrapper_eager_ms=eager_ms(cycled(wrapper)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            distinct_rows=distinct)
    del kc, rc, sets
    return out


def _rec_invariant_holds(cache, uniq) -> bool:
    """The cache's invariant: the rows of ``uniq`` gathered through K10a
    equal ``plane.peek(uniq)`` bit for bit.  The gather is one counted
    K10a launch (``REC_CHECK_GATHERS`` a step)."""
    from dlrover_tpu_torch.embedding import kernels as ek

    got = ek.gather_rows(cache.memory_buffers()[0], cache.slots_of(uniq))
    got = got[: len(uniq)].cpu().numpy()
    return bool(np.array_equal(got, cache.plane.peek(uniq)))


def _host_profile(prof, top: int = 14):
    """The functions a cProfile window spent most time in, by own time."""
    import pstats

    stats = pstats.Stats(prof)
    rows = []
    for (path, line, func), (_, ncalls, tottime, cumtime, _) in \
            stats.stats.items():
        rows.append((tottime, cumtime, ncalls,
                     f"{os.path.basename(path)}:{line}({func})"))
    rows.sort(reverse=True)
    return [{"own_ms": t * 1e3, "cum_ms": c * 1e3, "calls": n, "name": f}
            for t, c, n, f in rows[:top]]


def train_rec_and_check():
    """``train_rec.run`` at MLPerf DLRM width on the card: after every step
    the cache's rows (through K10a) equal the plane's bit for bit, across
    the 4 -> 3 reshard; the loss is finite and falls; the launches equal
    the counts the cache's code gives (one K10a per lookup, one K10b per
    ensure that fetched misses and one per refresh); the hit rate is above
    0; the reshard moved rows and lost none.  Then 3 steps with a K10b that
    drops the last real row must fail the invariant."""
    import cProfile

    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.embedding import kernels as ek
    from dlrover_tpu_torch.examples import train_rec

    args = train_rec.parse_args(REC_ARGV)
    state = {"bad": [], "per_step": [], "prev": None}
    window = {}

    def on_step(step, cache, uniq):
        if step == REC_PROFILED_STEP:
            torch.cuda.synchronize()
            window["prof"].__exit__(None, None, None)
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
        if step == REC_HOST_PROFILED_STEP:
            window["host"].disable()
        if not _rec_invariant_holds(cache, uniq):
            state["bad"].append(step)
        now = dict(cache.stats(), **ek.LAUNCHES)
        prev = state["prev"] or dict.fromkeys(now, 0)
        d = {k: now[k] - prev[k] for k in now}
        state["prev"] = now
        want = {"embed_gather": 1, "embed_scatter": 1 + d["fetches"]}
        got = {"embed_gather": d["embed_gather"] - REC_CHECK_GATHERS,
               "embed_scatter": d["embed_scatter"]}
        calls = {"embed_gather": d["gathers"],
                 "embed_scatter": d["scatters"]}
        state["per_step"].append(dict(step=step, unique=len(uniq),
                                      fetches=d["fetches"], **got))
        if got != want or calls != want:
            raise AssertionError(
                f"step {step}: launches {got}, cache calls {calls}, "
                f"derived {want}")
        if step == REC_PROFILED_STEP - 1:
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        if step == REC_HOST_PROFILED_STEP - 1:
            window["host"] = cProfile.Profile()
            window["host"].enable()

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_rec.run(args, device="cuda", on_step=on_step)
    total_s = time.perf_counter() - t0
    counts = _counts()
    # The path's own launches: take out the invariant check's gathers.
    counts["embed_gather"] -= REC_CHECK_GATHERS * args.steps
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    losses = result["losses"]
    cache, plane = result["cache"], result["plane"]
    (reshard,) = result["reshards"]
    measured = result["step_s"][REC_WARMUP:]
    step_s = statistics.median(measured)
    prof = _profile_summary(window["prof"], window["wall_ms"], top=10)
    busy = prof.get("device_busy_ms")
    checks = {
        "invariant_every_step": not state["bad"],
        "losses_finite": bool(np.isfinite(losses).all()),
        "loss_falls": float(np.mean(losses[-5:])) < min(
            float(np.mean(losses[:5])), losses[0]),
        "launches_derived": (
            counts["embed_gather"] == cache["gathers"] == args.steps
            and counts["embed_scatter"] == cache["scatters"]
            == args.steps + cache["fetches"]),
        "hit_rate_above_0": cache["hit_rate"] > 0,
        "reshard_moved_rows_lost_none": (
            reshard["moved_rows"] > 0
            and reshard["rows_before"] == reshard["rows_after"]),
        "no_eviction": cache["evictions"] == 0,
    }

    # -- the invariant check must catch a faulty scatter ---------------------
    fault_args = train_rec.parse_args(
        REC_ARGV[:1] + [str(REC_FAULT_STEPS)] + REC_ARGV[2:-2])
    caught = []
    kernel_scatter = ek.scatter_rows
    ek.scatter_rows = _scatter_fault(kernel_scatter)
    try:
        train_rec.run(fault_args, device="cuda", on_step=lambda s, c, u: (
            caught.append(s) if not _rec_invariant_holds(c, u) else None))
    finally:
        ek.scatter_rows = kernel_scatter
    torch.cuda.empty_cache()
    checks["scatter_fault_caught"] = bool(caught)

    emit({
        "phase": "train_rec",
        "config": "MLPerf Training DLRM, Criteo 1TB: 26 categorical "
                  "features, dim 128, max_ind_range 40M, top MLP 1024, "
                  "8192 examples per chip; zipf(1.3) ids, numpy seed 0",
        "argv": REC_ARGV,
        "losses": losses, "step_s": result["step_s"],
        "step_s_median": step_s,
        "examples_per_s": args.batch_size / step_s,
        "rows_per_s": args.batch_size * args.fields / step_s,
        "examples_per_s_whole_run": result["examples_per_s"],
        "run_s": total_s,
        "reshard": reshard,
        "reshard_step_s": result["step_s"][reshard["step"] - 1],
        "cache": cache, "plane": plane,
        "launches": {k: counts[k] for k in ek.LAUNCHES},
        "per_step": state["per_step"],
        "peak_memory_allocated_bytes": peak,
        "profiled_step": prof,
        "device_busy_share_of_profiled_step": (
            busy / prof["wall_ms_under_profiler"]
            if isinstance(busy, float) else "not measured"),
        "host_profile_step": _host_profile(window["host"]),
        "fault_run": {"steps": REC_FAULT_STEPS, "failed_at_steps": caught},
        "checks": checks,
    })
    if not all(checks.values()):
        raise AssertionError(f"train_rec failed its checks: {checks} "
                             f"(invariant broken at steps {state['bad']})")
    return counts


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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms, top)


def _profile_summary(prof, wall_ms: float, top: int = 8):
    """Device busy time and the top kernels of a finished profile."""
    from torch.autograd import DeviceType

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
    before = fa.LAUNCHES["flash_fwd"]
    row, kernel_logits = programs.prefill_logits(model, padded, n)
    if fa.LAUNCHES["flash_fwd"] != before + cfg.num_layers:
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
    if sys.argv[1:2] == ["--time-tree"] and len(sys.argv) == 3:
        # One reading of ``ab_in_turns``: the tree's own package, whose
        # kernels build (once) into its own build directory.
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        torch.backends.cuda.matmul.allow_tf32 = False
        emit({"phase": "time_tree", "tree": sys.argv[2],
              "ms": time_kernels()})
        return 0
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
    # Per kernel (its mangled name, template arguments included): the
    # registers, the stack frame and spills, and any warning.
    ptxas = {
        name: re.findall(r"Compiling entry function '[^']*'"
                         r"|Used \d+ registers[^\n]*|\d+ bytes stack[^\n]*"
                         r"|Performance Loss[^\n]*", log)
        for name, log in kernel_lib.BUILD_LOGS.items()
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "build_dir": os.path.relpath(kernel_lib.BUILD_DIR, REPO)})

    if sys.argv[1:] == ["--flags-ab"]:
        flags_ab()
        print(smi, flush=True)
        return 0
    flash_only = sys.argv[1:] == ["--flash"]
    if sys.argv[1:] == ["--gmm"]:
        gmm_only()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--pin"]:
        pin_kernel_check(torch.Generator(device="cuda").manual_seed(0))
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--norm"]:
        norm_kernel_checks(torch.Generator(device="cuda").manual_seed(0))
        print(smi, flush=True)
        return 0
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) >= 3:
        ab_in_turns(sys.argv[2:])
        print(smi, flush=True)
        return 0
    if sys.argv[1:] and not flash_only:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2

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
          "tolerance": {"row": BWD_ROW_TOL, "norm": BWD_NORM_TOL,
                        "repro_dq_row": REPRO_DQ_ROW_TOL},
          "library": "F.scaled_dot_product_attention backward via "
                     "torch.autograd.grad: forward and backward in one "
                     "CUDA graph less the forward's graph replay",
          "cases": bwd_cases})
    bad = [c["case"] for c in bwd_cases if not c["ok"]]
    if bad:
        raise AssertionError(f"flash backward kernels disagree on {bad}")
    if flash_only:
        print(smi, flush=True)
        return 0

    gmm_cases = gmm_kernel_checks(gen)
    norm_cases = norm_kernel_checks(gen)
    quant_cases = quant_kernel_checks(gen)
    pin_check = pin_kernel_check(gen)
    embed_check = embed_kernel_checks(gen)

    mha_dispatch()
    paths = {"serve": serve_and_check()}
    paths["train"], adafactor_state_bytes = train_and_check()
    paths["train_split"] = train_split_and_check()
    train_parity()
    paths["train_moe"] = train_moe_and_check()
    train_moe_parity()
    paths.update(train_lowbit_and_check(adafactor_state_bytes))
    train_lowbit_parity()
    paths["train_rec"] = train_rec_and_check()

    def launches(name):
        return sum(p[name] for p in paths.values())

    def by_path(name):
        return {path: p[name] for path, p in paths.items()}

    for name in _counts():
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
    gmm = next(c for c in gmm_cases if c["case"] == GMM_SLICE_CASE)
    for name, replaces, product, kinds in (
            ("gmm_fwd", 31, "fwd_wi", ("fwd", "dx")),
            ("gmm_dw", 90, "dw_wi", ("dw",))):
        t = gmm["timed"][product]
        entries.append(dict(
            name=name, route="cuda", source=src + "grouped_matmul.cu",
            replaces=f"dlrover_tpu/ops/grouped_matmul.py:{replaces}",
            launches=launches(name), launches_by_path=by_path(name),
            max_abs_err=max(c[p]["max_abs"] for c in gmm_cases
                            for p in GMM_PRODUCTS
                            if p in c and p.split("_")[0] in kinds),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library="torch._grouped_mm (CUDA-graph replay)",
            shape={"product": product, "rows": gmm["rows"], "d": gmm["d"],
                   "f": gmm["f"], "experts": MOE_EXPERTS,
                   "group_sizes": gmm["group_sizes"]},
            products={p: {k: v[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms",
                "library_eager_ms", "host_us")}
                for p, v in gmm["timed"].items()},
        ))
    norm = next(c for c in norm_cases if c["case"] == NORM_TRAIN_CASE)
    t = norm["timed"]
    entries.append(dict(
        name="norm_bwd", route="cuda", source=src + "fused_norm.cu",
        replaces="dlrover_tpu/ops/fused_norm.py:43",
        launches=launches("norm_bwd"), launches_by_path=by_path("norm_bwd"),
        max_abs_err=max(c["max_abs_err"] for c in norm_cases),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        library=t.get("library"),
        shape={k: norm[k] for k in ("n", "d", "dtype", "center")},
        rmsnorm_ms=next(c for c in norm_cases
                        if c["case"] == "train_rmsnorm")["timed"]["ms"],
    ))
    quant = next(c for c in quant_cases if c["case"] == QUANT_LEAF_CASE)
    for name, replaces, err in (
            ("quantize", 53, lambda c: c["quantize"]["codes_max_levels_off"]),
            ("dequantize", 61, lambda c: c["dequantize"]["max_abs_err"]),
            ("q8_adam", 120, lambda c: c["q8_adam"]["upd_max_abs_err"]),
            ("q4_adam", 309, lambda c: c["q4_adam"]["upd_max_abs_err"])):
        t = quant["timed"][name]
        entries.append(dict(
            name=name, route="cuda", source=src + "quantization.cu",
            replaces=f"dlrover_tpu/ops/quantization.py:{replaces}",
            launches=launches(name), launches_by_path=by_path(name),
            max_abs_err=float(max(err(c) for c in quant_cases)),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"],
            # No one PyTorch call computes this function.
            library_ms=None, gbytes_per_s=t["gbytes_per_s"],
            shape={"leaf": quant["shape"], "dtype": quant["dtype"],
                   "blocks": quant["blocks"]},
        ))
    t = pin_check["timed"]
    entries.append(dict(
        name="pin_copy", route="cuda", source=src + "layout_pin.cu",
        replaces="dlrover_tpu/ops/layout_pin.py:30",
        launches=launches("pin_copy"), launches_by_path=by_path("pin_copy"),
        max_abs_err=pin_check["max_abs_err"],
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        library=t["library"], transposed_ms=t["transposed_ms"],
        pairs=t["pairs"],
        shape={"x": [TRAIN_BATCH, TRAIN_SEQ, 1600], "dtype": "bf16"},
    ))
    for name, replaces, kind in (("embed_gather", 67, "gather"),
                                 ("embed_scatter", 72, "scatter")):
        t = embed_check["timed"][kind]
        _, capacity, dim, n, real = next(
            c for c in EMBED_CASES if c[0] == EMBED_SLICE_CASE)
        entries.append(dict(
            name=name, route="cuda", source=src + "embedding_rows.cu",
            replaces=f"dlrover_tpu/embedding/kernels.py:{replaces}",
            launches=launches(name), launches_by_path=by_path(name),
            max_abs_err=embed_check["max_abs_err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library=t["library"], wrapper_eager_ms=t["wrapper_eager_ms"],
            shape={"cache": [capacity, dim], "slots": n, "real": real,
                   "dtype": "fp32"},
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

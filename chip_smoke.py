#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100).

    python3 chip_smoke.py

Drives the port's main path, serving, at the full width and depth of
GPT-2 1.5B with random weights from a seed, and holds every CUDA kernel of
that path against its plain PyTorch version.  Imports nothing of JAX or of
the JAX package.  Phases, each one JSON line on stdout:

1. ``device``  the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``   nvcc builds every kernel under ``dlrover_tpu_torch/ops/csrc``
               into ``build/kernels/`` (seconds, ptxas register report).
3. ``kernel_checks``  the flash-attention forward at the serving shapes
               (B=1, H=25, D=64, S in 16/128/512/1000, causal; q/k/v as
               strided views of one fused projection) and at GQA, segment,
               non-causal and fully-masked-row shapes: error against
               ``mha_reference`` computed in fp32 from the same bf16 inputs
               (TF32 off), tolerance |o - ref| <= 1e-2 + 1e-2 |ref| and
               |lse - ref| <= 1e-3; kernel, plain and
               ``F.scaled_dot_product_attention`` (yardstick only, never
               called by the port) device times from CUDA events around
               CUDA-graph replays (``eager_*``: back-to-back eager calls,
               host launch gaps included); the roofline bound from this
               call's bytes and unmasked FLOPs.
4. ``serve``   ``ServingEngine`` on ``gpt2_config("1.5b",
               attention_impl="flash")``, 8 slots, 16 requests over every
               prefill bucket (half greedy, half temperature 0.8 / top-k 8):
               every request returns exactly its ``max_new_tokens`` with
               finite logprobs, and the flash kernel launched 48 times (one
               per layer) per prefill.  Prefill ms per bucket, decode-step
               p50/p95, generated tokens/s, peak device memory.
5. ``profile`` device time by kernel for one 512-token prefill and one
               decode step (``torch.profiler``).
6. ``parity``  prefill logits through the kernel vs the same model with
               ``mha_reference`` in its place, and one decode step's logits
               vs a no-cache forward of the same prefix, both bf16, within
               atol 0.1 (the logits' std is about 0.8) and the same argmax.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no result.  Without a GPU, or without the
package beside it, it exits non-zero before any phase.
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
SLOTS = 8
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
    dict(case="gqa_32_8_d128", b=1, s=512, hq=32, hkv=8, d=128,
         causal=True),
    dict(case="segments", b=2, s=512, hq=25, hkv=25, d=64, causal=True,
         seg="packed"),
    dict(case="noncausal", b=1, s=512, hq=25, hkv=25, d=64, causal=False,
         fused=True),
    dict(case="masked_rows", b=1, s=256, hq=8, hkv=8, d=64, causal=True,
         seg="masked"),
]
HEADLINE_CASE = "serve_s512"  # the largest serving bucket


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


def _profile(fn):
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
                for ms, n, name in rows[:8]],
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

    cfg = gpt2_config("1.5b", attention_impl="flash")
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
    fa.mha.launches = 0
    t0 = time.perf_counter()
    results = engine.run(requests)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fa.mha.launches
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
    return launches


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

    launches = serve_and_check()

    head = next(c for c in cases if c["case"] == HEADLINE_CASE)
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "dlrover_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:58",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("b", "s", "hq", "hkv", "d",
                                       "causal")},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

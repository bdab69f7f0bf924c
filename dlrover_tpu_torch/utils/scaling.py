"""Measured 1→n scaling curve for the sharded training step (port of
``dlrover_tpu/utils/scaling.py``).

This module times the full sharded train step (ZeRO-1 update by default)
in data-parallel worlds of n ∈ {1, 2, 4, 8} processes and reports
tokens/s, parallel efficiency vs n=1, and the comm fraction of the step:
measured from one captured step (``utils/device_profile``: the wire's
collective legs over the window's total) where the window parses, else
the modeled ``reduce_scatter`` + ``allgather`` rows of
``train_lib.microbatch_phase_plan``.

Weak scaling: the per-rank batch is constant, so ideal tokens/s is
linear in n and ``efficiency = tokens_per_s(n) / (n · tokens_per_s(1))``.

Each point is one world of n spawned processes joined in a gloo group
(:func:`spawn_world`; the wire stages a card's tensors through the host).  The
reference quietly falls back to a CPU child with virtual devices when
too few are visible; here ``device`` says where the step runs —
``cuda`` (the default: rank r on card r) refuses an n above the visible
cards, and the CPU is used only when asked for (``device="cpu"``).  One
card therefore gives no 1→n curve.

``python -m dlrover_tpu_torch.utils.scaling --ns 1,2 --device cpu``
prints the measurement as JSON.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

DEFAULT_NS = (1, 2, 4, 8)
#: A world's budget: one build and a few tiny steps per rank.
WORLD_TIMEOUT_S = 600.0


def _measure_point(
    n: int,
    *,
    device: str = "cuda",
    per_device_batch: int = 4,
    seq_len: int = 32,
    steps: int = 3,
    zero1: bool = True,
    grad_accum: int = 1,
    reduce_quant: str = "none",
    profile: bool = True,
) -> Dict[str, Any]:
    """Time ``steps`` sharded train steps on this rank of a data-parallel
    world of ``n`` processes (the default group, joined by the caller;
    none for n=1).

    ``profile=True`` (default) additionally captures ONE extra step in a
    :class:`~dlrover_tpu_torch.utils.device_profile.DeviceProfiler`
    window and reports ``comm_fraction`` from its *measured* collective
    seconds (``comm_source: "measured"``); when the capture fails the
    modeled phase-plan rows price it instead (``comm_source:
    "modeled"``) — each point says which it got.
    """
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.gpt2 import gpt2_config
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_lib

    dev = torch.device(device)
    if dev.type == "cuda":
        rank = (torch.distributed.get_rank()
                if torch.distributed.is_initialized() else 0)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    mesh = build_mesh(ParallelConfig(data=n), device_type=dev.type)
    config = gpt2_config(
        "124m", num_layers=2, d_model=64, num_heads=4,
        vocab_size=256, max_seq_len=seq_len,
    )
    opt = train_lib.make_optimizer("sgd", learning_rate=1e-3)
    batch_size = per_device_batch * n
    train = train_lib.build_train(
        config, opt, global_batch_size=batch_size, seq_len=seq_len,
        grad_accum=grad_accum, reduce_quant=reduce_quant, zero1=zero1,
        mesh=mesh, device=dev,
    )
    state = train.init(seed=0)
    rng = np.random.default_rng(0)
    toks = rng.integers(
        0, config.vocab_size, size=(batch_size, seq_len + 1), dtype=np.int64
    )
    batch = train_lib.shard_batch(
        {"inputs": toks[:, :-1], "targets": toks[:, 1:]}, train
    )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Warmup step pays the first calls; the timed loop is steady state.
    state, metrics = train.step(state, batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = train.step(state, batch)
    loss = float(metrics["loss"])
    sync()
    step_s = (time.perf_counter() - t0) / max(1, steps)
    rows = train_lib.microbatch_phase_plan(
        train.grad_accum, reduce_quant, step_s, zero1=train.zero1
    )
    # n=1 has no data axis, hence no wire: the modeled "reduce" row is an
    # artifact of the shared phase plan there, not a comm cost.
    comm_s = 0.0 if n <= 1 else sum(
        r["dur"] for r in rows
        if r["phase"] in ("reduce_scatter", "allgather", "reduce")
    )
    comm_fraction = comm_s / step_s if step_s else 0.0
    comm_source = "modeled"
    if profile and n > 1:
        from dlrover_tpu_torch.utils import device_profile

        prof = device_profile.DeviceProfiler(profile_every=1, device=dev)
        if prof.arm(0):
            state, metrics = train.step(state, batch)
            sync()
            window = prof.finish()
            if window is not None and window.device_total_s > 0.0:
                comm_fraction = (
                    window.seconds("collective") / window.device_total_s
                )
                comm_source = "measured"
    return {
        "n": n,
        "step_s": step_s,
        "tokens_per_s": batch_size * seq_len / step_s if step_s else 0.0,
        "comm_fraction": comm_fraction,
        "comm_source": comm_source,
        "zero1": bool(train.zero1),
        "device": str(dev.type),
        "loss": loss,
        "ok": bool(np.isfinite(loss)),
    }


def _scaling_rank(rank: int, n: int, payload: Dict[str, Any]):
    """One rank of a point's world: every rank measures (each takes part
    in every collective); rank 0's point is the world's."""
    return _measure_point(n, **payload)


def _child(rank, n, store, fn, payload, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        result = {"ok": fn(rank, n, payload)}
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = {"error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def spawn_world(n: int, fn: Callable, payload: Any,
                timeout: float = WORLD_TIMEOUT_S,
                directory: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, n, payload)`` on ``n`` spawned processes (never
    forked), each with one intra-op thread, joined in a gloo group
    through a ``file://`` store (so no port is taken); every rank's
    result, or RuntimeError when a rank fails or outlives ``timeout``.

    The store and the ranks' results live in ``directory`` (named by
    ``fn`` and ``n``, so many worlds may share it), else in a temporary
    directory removed afterwards.
    """
    import multiprocessing

    tmp = directory or tempfile.mkdtemp(prefix="dlrover_world_")
    os.makedirs(tmp, exist_ok=True)
    tag = f"{fn.__name__}_{n}"
    store = os.path.join(tmp, f"store_{tag}")
    outs = [os.path.join(tmp, f"{tag}_rank{r}.pkl") for r in range(n)]
    try:
        for path in [store, *outs]:
            if os.path.exists(path):
                os.remove(path)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_child,
                             args=(r, n, store, fn, payload, outs[r]))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        results = []
        for path in outs:
            if not os.path.exists(path):
                results.append({"error": "no result"})
                continue
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    finally:
        if directory is None:
            shutil.rmtree(tmp, ignore_errors=True)
    errors = [r["error"] for r in results if "error" in r]
    if alive or errors:
        raise RuntimeError(
            f"world of {n}: {len(alive)} rank(s) timed out; errors: "
            + "\n".join(errors))
    return [r["ok"] for r in results]


def _finish(points: list, source: str) -> Dict[str, Any]:
    """Attach efficiency-vs-n=1 and the human-readable table."""
    base = next((p for p in points if p["n"] == 1), None)
    base_tps = base["tokens_per_s"] if base else 0.0
    for p in points:
        ideal = base_tps * p["n"]
        p["efficiency"] = p["tokens_per_s"] / ideal if ideal else 0.0
    table = [f"{'n':>3} {'tokens/s':>12} {'speedup':>8} "
             f"{'efficiency':>10} {'comm%':>6} {'src':>9}"]
    for p in points:
        speedup = p["tokens_per_s"] / base_tps if base_tps else 0.0
        table.append(
            f"{p['n']:>3} {p['tokens_per_s']:>12.0f} {speedup:>8.2f} "
            f"{p['efficiency'] * 100:>9.1f}% "
            f"{p['comm_fraction'] * 100:>5.1f}% "
            f"{p.get('comm_source', 'modeled'):>9}"
        )
    return {
        "ok": all(p.get("ok") for p in points) and bool(points),
        "source": source,
        "ns": [p["n"] for p in points],
        "points": points,
        "table": table,
    }


def measure_scaling(
    ns: Sequence[int] = DEFAULT_NS,
    *,
    device: str = "cuda",
    timeout_s: Optional[float] = None,
    **point_kw: Any,
) -> Dict[str, Any]:
    """The scaling block: tokens/s at each n, efficiency vs n=1, comm%.

    Each n is one world of n processes on ``device`` (``cuda``: one card
    a rank, so every n must be at most the visible cards, else
    ValueError; ``cpu`` only when asked for), run by
    :func:`spawn_world`.
    """
    import torch

    ns = sorted(set(int(n) for n in ns if n >= 1))
    if not ns:
        return {"ok": False, "cause": "empty ns", "points": []}
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if max(ns) > cards:
            raise ValueError(
                f"measure_scaling on cuda: n={max(ns)} needs {max(ns)} "
                f"cards, {cards} visible (pass device='cpu' for a CPU "
                "curve)")
    elif kind != "cpu":
        raise ValueError(f"device {device!r} is neither cuda nor cpu")
    timeout = timeout_s if timeout_s is not None else WORLD_TIMEOUT_S
    payload = dict(point_kw, device=kind)
    points = [spawn_world(n, _scaling_rank, payload, timeout)[0]
              for n in ns]
    return _finish(points, source=f"{kind} worlds of {ns} processes")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ns", default="1,2,4,8",
                   help="comma-separated world sizes")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    p.add_argument("--per-device-batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--zero1", default="True",
                   help="True | False (sharded vs replicated update)")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--reduce-quant", default="none")
    p.add_argument("--profile", default="True",
                   help="True | False (capture one profiled step per "
                        "point for a measured comm_fraction)")
    args = p.parse_args(argv)
    ns = [int(x) for x in args.ns.split(",") if x.strip()]
    out = measure_scaling(
        ns,
        device=args.device,
        per_device_batch=args.per_device_batch,
        seq_len=args.seq_len,
        steps=args.steps,
        zero1=args.zero1 not in ("False", "false", "0"),
        grad_accum=args.grad_accum,
        reduce_quant=args.reduce_quant,
        profile=args.profile not in ("False", "false", "0"),
    )
    print(json.dumps(out), flush=True)
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())

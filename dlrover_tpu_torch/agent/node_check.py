"""Pre-flight node health probes: bf16 matmul TFLOP/s + collective
bandwidth (port of ``dlrover_tpu/agent/node_check.py``).

Capability ref: ``dlrover/trainer/torch/node_check/nvidia_gpu.py:24`` +
``utils.py:58-196`` (``matmul`` stress + ``bm_allgather`` timed) and the
agent driver ``training.py:828-977`` (``NodeCheckElasticAgent``).

The probes run *in the agent's own process* on the local cards (no
fork-per-device), measuring (a) bf16 matmul sustained TFLOP/s on every
local card — catches degraded or power-limited cards, and (b) an
all-reduce's bandwidth across the local cards — catches bad links.
Elapsed time is reported to the master's NetworkCheckRendezvousManager,
which runs the pairwise bisection.

The probes run on ``cuda`` unless the caller passes ``device="cpu"``; a
probe that fails (a host without a card included) reports the node
unhealthy and is never rerun on the CPU.  ``torch`` is imported inside
the probes, so an agent that runs no check pays nothing for it.
"""

from __future__ import annotations

import time
from typing import Tuple

from dlrover_tpu_torch.common.log import default_logger as logger

#: The golden digest's chain (``probe_result_digest``).
DIGEST_DIM, DIGEST_ITERS = 512, 4
#: The timed chain's side by device: a stress test on a card, a
#: functional check on the CPU (4096 there would take minutes).
PROBE_DIM = {"cuda": 4096, "cpu": 128}


def probe_input(matrix_dim: int):
    """The probes' input: a seeded normal matrix made by a CPU generator
    and rounded to bf16, so a card and the CPU (and the reference's chain
    in a test) start from the same bits."""
    import torch

    gen = torch.Generator().manual_seed(0)
    return torch.randn(matrix_dim, matrix_dim, generator=gen,
                       dtype=torch.float32).to(torch.bfloat16)


def _chain(x, iters: int):
    """``iters`` times ``x @ x`` renormalized by rsqrt(dim) in x's dtype
    (the reference's jitted chain)."""
    import torch

    scale = torch.tensor(float(x.shape[0]), dtype=torch.float32,
                         device=x.device).rsqrt().to(x.dtype)
    for _ in range(iters):
        x = torch.matmul(x, x)
        x = x * scale
    return x


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _PinnedMatmul:
    """Pins the process-wide flag a bf16 product depends on for the
    probe's duration, so a caller's setting cannot move its bits."""

    def __enter__(self):
        import torch

        self._saved = (
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
        return self

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            self._saved)
        return False


def matmul_probe(
    matrix_dim: int = 4096, iters: int = 8, device="cuda"
) -> float:
    """Sustained bf16 matmul TFLOP/s on one device."""
    x = probe_input(matrix_dim).to(device)
    with _PinnedMatmul():
        _chain(x, iters)  # warm-up: library handles, workspaces
        _sync(device)
        t0 = time.monotonic()
        _chain(x, iters)
        _sync(device)  # the clock stops when the card is done
        dt = time.monotonic() - t0
    flops = 2 * matrix_dim**3 * iters
    return flops / dt / 1e12


def allreduce_probe(size_mb: int = 64, device="cuda") -> Tuple[float, float]:
    """(elapsed_s, algo_bw_GBps) of an all-reduce across the local cards
    in this process; ``(0.0, 0.0)`` below two local devices."""
    import torch

    nelem = size_mb * (1 << 20) // 4
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    if n < 2:
        return 0.0, 0.0
    bufs = [torch.ones(nelem, dtype=torch.float32, device=f"cuda:{i}")
            for i in range(n)]

    def reduce():
        torch.cuda.nccl.all_reduce(bufs)
        for i in range(n):
            torch.cuda.synchronize(i)

    reduce()
    t0 = time.monotonic()
    reduce()
    dt = time.monotonic() - t0
    gb = nelem * 4 / 1e9
    return dt, gb / dt if dt > 0 else 0.0


def probe_result_digest(matrix_dim: int = DIGEST_DIM,
                        iters: int = DIGEST_ITERS, device="cuda") -> str:
    """Deterministic digest of a seeded matmul chain's exact result bits.

    The input is seeded (``probe_input``) and the chain runs on one
    device, so on healthy hardware the result is bit-identical run to
    run — the node's *golden value*.  A re-join whose digest differs means
    this card now computes differently than it did at job start: the
    suspicion-driven silent-data-corruption confirm probe (the agent-side
    counterpart of the trainer's cross-replica state digest vote).
    """
    import zlib

    import torch

    x = probe_input(matrix_dim).to(device)
    with _PinnedMatmul():
        out = _chain(x, iters).view(torch.int16).cpu().numpy()
    return f"{zlib.crc32(out.tobytes()) & 0xFFFFFFFF:08x}"


def golden_replay_check(client, node_rank: int, device="cuda") -> bool:
    """Record the golden probe digest at first join; compare on re-join.

    The golden value lives in the master's kv store (it survives master
    restarts through the state store), keyed by node rank.  A mismatch is
    reported like a failed bisection round — the master's verdict then
    excludes this host the same way a bad link would be.
    """
    digest = probe_result_digest(device=device)
    key = f"node_check_golden/{node_rank}"
    golden = client.kv_get(key)
    if not golden:
        client.kv_put(key, digest.encode())
        logger.info(
            "node check: golden digest %s recorded for rank %d",
            digest, node_rank,
        )
        return True
    golden = golden.decode() if isinstance(golden, bytes) else str(golden)
    if golden != digest:
        logger.error(
            "node check: golden digest mismatch on rank %d (recorded %s, "
            "replayed %s) — hardware computes differently than at job "
            "start (SDC suspect)", node_rank, golden, digest,
        )
        return False
    return True


def _local_devices(device):
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    if dev.index is not None:
        return [dev]
    # No card: an empty list would pass silently; cuda:0 raises instead.
    return [torch.device("cuda", i)
            for i in range(max(1, torch.cuda.device_count()))]


def run_probe_payload(matrix_dim: int = 0, device="cuda") -> Tuple[bool, float]:
    """The full per-host probe: returns (healthy, elapsed_seconds).
    ``matrix_dim`` 0 takes ``PROBE_DIM`` of the device's type."""
    import torch

    t0 = time.monotonic()
    try:
        dim = matrix_dim or PROBE_DIM[torch.device(device).type]
        tflops = []
        for dev in _local_devices(device):
            tflops.append(matmul_probe(dim, device=dev))
        dt, bw = allreduce_probe(device=device)
        elapsed = time.monotonic() - t0
        logger.info(
            "node check: matmul %s TFLOPs, allreduce %.1f GB/s, %.4fs",
            [f"{t:.4g}" for t in tflops], bw, elapsed,
        )
        return True, elapsed
    except Exception as e:
        logger.error("node check probe failed: %s", e)
        return False, time.monotonic() - t0
    finally:
        if torch.device(device).type == "cuda" and torch.cuda.is_available():
            # The agent lives beside the trainer: hand the probe's cached
            # blocks back to the card.
            torch.cuda.empty_cache()


def run_network_check(
    client, node_rank: int, rounds: int = 2, timeout: float = 300.0,
    device="cuda",
) -> bool:
    """Drive the check rounds against the master; returns node health.

    ref ``training.py:1054-1118``: each round joins the network-check
    rendezvous, runs the probe, reports status+elapsed; after the final
    round the *master's* pairwise-bisection verdict decides health.  A node
    whose own probe failed still joins every round — dropping out would
    stall the remaining nodes' rendezvous and starve the bisection of the
    suspect it needs to re-pair.
    """
    from dlrover_tpu_torch.master.rdzv_manager import RendezvousName

    local_healthy = True
    for check_round in range(rounds):
        client.join_rendezvous(node_rank, 1, RendezvousName.NETWORK_CHECK)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            state = client.get_comm_world(
                node_rank, RendezvousName.NETWORK_CHECK
            )
            if state.world:
                break
            time.sleep(0.5)
        healthy, elapsed = run_probe_payload(device=device)
        if check_round == 0:
            # Golden-batch replay rides the first round only: one seeded
            # matmul digest compared against the value recorded at the
            # job's first join.  A mismatch fails this round exactly like
            # a failed probe, feeding the master's bisection the suspect.
            try:
                healthy = golden_replay_check(
                    client, node_rank, device=device) and healthy
            except Exception as e:  # noqa: BLE001 - probe is best-effort
                logger.warning("golden replay check skipped: %s", e)
        local_healthy = local_healthy and healthy
        client.report_network_status(node_rank, healthy, elapsed)

    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        result = client.get_network_check_result()
        if result.reason == "done":
            if result.stragglers:
                logger.warning("straggler nodes: %s", result.stragglers)
            return node_rank not in result.fault_nodes
        time.sleep(1.0)
    logger.warning("network-check verdict timed out; using local result")
    return local_healthy

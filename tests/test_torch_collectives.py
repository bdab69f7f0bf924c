"""Port parity: the int8 collectives (``dlrover_tpu_torch.parallel.
quantized_collectives`` over ``parallel.wire.Wire``) against the JAX
package's under ``shard_map``, member for member.

The port runs in spawned gloo worlds of 2 and 4 processes
(``tests/torch_worlds.py``), the JAX side on the first 2 or 4 devices of
the 8-device CPU mesh, from the same per-member inputs: fp32 and bf16,
chunks that end in a partial block and chunks of whole blocks, both
algorithms, both dims.

What is bit-equal: the quantization itself (absmax over a block, one
division by 127, round half to even, a clip: the same IEEE operations on
the same values give the same codes and scales) and so the all-gather,
which quantizes each shard once at its source and only dequantizes after.
What is held to a tolerance: a reduction.  XLA fuses each member's
dequantizing product into the fp32 sum (one rounding where the port, and
K5b on the card, round the product first), so a reduced value may differ
by an ulp for each member; where the reduced value is quantized again
(the all-reduce's second phase, each ring hop), an ulp at a rounding
boundary moves a code by one step.  So every element is within one
quantization step of its block (the block's largest input over 127, over
``n`` members), and nearly all within ``n`` fp32 roundings of the
largest input (``REDUCE_ULPS``, ``REDUCE_SHARE``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec

import torch_worlds
from dlrover_tpu.parallel import quantized_collectives as jqc
from dlrover_tpu.runtime.mesh import shard_map_compat

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every case's output on every rank, one spawned world per size."""
    out = {}
    for n in WORLDS:
        out[n] = torch_worlds.run_world(
            n, torch_worlds.run_collectives, torch_worlds.collective_cases(n),
            tmp_path_factory.mktemp(f"collectives{n}"))
    return out


def _jax_case(case, n):
    cid, fn, algo, shape, dtype, dim, mean = case
    x = torch_worlds.member_inputs(case, n)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def body(v):
        v = v[0]
        if fn == "ar":
            y = jqc.quantized_all_reduce(v, "data", mean=mean, algo=algo)
        elif fn == "rs":
            y = jqc.quantized_reduce_scatter(v, "data", dim=dim, mean=mean,
                                             algo=algo)
        else:
            y = jqc.quantized_all_gather(v, "data", dim=dim, algo=algo)
        return y[None]

    f = shard_map_compat(body, mesh=mesh, in_specs=PartitionSpec("data"),
                         out_specs=PartitionSpec("data"))
    y = jax.jit(f)(jnp.asarray(x, jdt))
    return str(y.dtype), np.asarray(y.astype(jnp.float32))


# A reduction's share of elements allowed past ``n`` fp32 roundings of the
# largest input (they sit on a re-quantization's rounding boundary).
REDUCE_SHARE = 0.02


@pytest.mark.parametrize("n,case", [
    (n, case) for n in WORLDS for case in torch_worlds.collective_cases(n)],
    ids=lambda v: str(v) if isinstance(v, int) else v[0])
def test_quantized_collective_matches_jax(port_results, n, case):
    jdtype, want = _jax_case(case, n)
    big = float(np.abs(torch_worlds.member_inputs(case, n)).max())
    for rank in range(n):
        dtype, got = port_results[n][rank][case[0]]
        assert dtype == f"torch.{jdtype}"  # the input dtype, preserved
        assert got.shape == want[rank].shape
        if case[1] == "ag" or case[5] is None:
            np.testing.assert_array_equal(got, want[rank],
                                          err_msg=f"rank {rank}")
            continue
        diff = np.abs(got - want[rank])
        step = n * big / 127
        assert diff.max() <= step, (rank, diff.max(), step)
        ulps = n * 2.0 ** -23 * big
        if case[4] == "bfloat16":
            ulps = n * 2.0 ** -8 * big  # the output is rounded to bf16
        assert (diff > ulps).mean() <= REDUCE_SHARE, (
            rank, (diff > ulps).mean())


def test_all_reduce_is_identical_on_every_member(port_results):
    for n in WORLDS:
        for case in torch_worlds.collective_cases(n):
            if case[1] != "ag" and case[1] != "ar":
                continue
            outs = [port_results[n][r][case[0]][1] for r in range(n)]
            for got in outs[1:]:
                np.testing.assert_array_equal(got, outs[0])


def test_ring_and_oneshot_all_gather_give_the_same_bits(port_results):
    for n in WORLDS:
        by_id = dict(port_results[n][0])
        for case in torch_worlds.collective_cases(n):
            if case[1] == "ag" and case[2] == "ring":
                twin = case[0].replace("-ring-", "-oneshot-")
                np.testing.assert_array_equal(by_id[case[0]][1],
                                              by_id[twin][1])

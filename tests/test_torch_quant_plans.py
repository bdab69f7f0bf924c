"""K7's maps (``dlrover_tpu_torch.ops.quantization.q4_maps``): the tables
and thresholds the q4 Adam kernel computes its codes from in place of the
plain version's roots, checked on the CPU against the plain chain, against
the C struct they fill, and against the JAX package's ``q4_adam``.

Every comparison here is exact: the tables are the plain decode at scale
1, and the thresholds are found through the plain chain itself, so a
code counted by thresholds must equal the plain code bit for bit.
``codes_by_thresholds`` counts the thresholds at or below a quotient;
``codes_by_bins`` mirrors how the kernel counts them (``code_of`` in
``ops/csrc/quantization.cu``: the quotient's bin, then one compare).
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import quantization as jq
from dlrover_tpu_torch.models.from_jax import low_bit_state_from_jax
from dlrover_tpu_torch.ops import quantization as tq

CU = os.path.join(os.path.dirname(os.path.abspath(tq.__file__)), "csrc",
                  "quantization.cu")
# which -> (plain level of a quotient, levels, thresholds of q4_maps)
MAPS = {"m": (tq._sqrt_level, 7, "m_thresholds"),
        "v": (tq._root4_level, 15, "v_thresholds")}


def codes_by_thresholds(q: torch.Tensor, thresholds) -> torch.Tensor:
    """The kernel's code of each quotient: thresholds ``<= q``."""
    t = torch.tensor(thresholds, dtype=torch.float32)
    return torch.searchsorted(t, q.contiguous(), right=True).float()


def codes_by_bins(q: torch.Tensor, thresholds) -> torch.Tensor:
    """The kernel's ``code_of``: the bin of q's float32 bits, then
    ``base + (q >= t)``."""
    t, base = (torch.tensor(c) for c in zip(*tq.q4_bins(thresholds)))
    bits = q.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    key = bits >> tq.BIN_SHIFT
    at = torch.clamp(key - tq.BIN_LOW + 1, 0, tq.BINS - 1)
    return (base[at] + (q >= t[at].float()).long()).float()


def _bits(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).view(torch.int32)


def _floats(bits) -> torch.Tensor:
    return torch.as_tensor(bits, dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def _plain_decode(which, codes, scales):
    """The plain version's decode of int codes ``[R, 256]`` (m signed,
    v unsigned) at ``scales [R]``."""
    mom = tq.QMoment(tq.pack_nibbles(codes), scales)
    return tq._q4_m_decode(mom) if which == "m" else tq._q4_v_decode(mom)


@pytest.mark.parametrize("which", ["m", "v"])
def test_tables_decode_as_the_plain_version_bit_for_bit(which):
    """``RN(table[nibble] * scale)`` equals the plain decode for all 16
    nibbles (m's 8 is the code -8, which K7 never writes but a carried
    state may hold) at scale 1, at seeded scales over many decades, and
    at subnormal ones."""
    rng = np.random.default_rng(101)
    scales = np.concatenate([
        [1.0, 2.0 ** -126, 2.0 ** -140, 3e38],
        10.0 ** rng.uniform(-38, 38, 250)]).astype(np.float32)
    scales = torch.from_numpy(scales)
    nibbles = torch.arange(tq.BLOCK, dtype=torch.int32) % 16
    codes = (torch.where(nibbles >= 8, nibbles - 16, nibbles) if which == "m"
             else nibbles).expand(len(scales), -1)
    want = _plain_decode(which, codes, scales)
    table = torch.tensor(getattr(tq.q4_maps(), f"{which}_table"),
                         dtype=torch.float32)
    got = table[nibbles.long()][None] * scales[:, None]
    assert torch.equal(_bits(got), _bits(want))
    if which == "m":
        # -8 decodes beyond -1, the code -7's value.
        assert table[8] < table[9] == -1.0 and table[7] == 1.0
        assert (table[1:8] > 0).all() and (table[8:] < 0).all()
    else:
        assert table[0] == 0 and table[15] == 1 and (table.diff() > 0).all()


@pytest.mark.parametrize("which", ["m", "v"])
def test_each_threshold_is_where_the_plain_chain_steps(which):
    """The plain chain maps threshold k to k and the float just below it
    to k - 1: 7 thresholds for m's level, 15 for v's code."""
    level, levels, name = MAPS[which]
    t = torch.tensor(getattr(tq.q4_maps(), name), dtype=torch.float32)
    assert len(t) == levels and (t.diff() > 0).all()
    assert (t > 0).all() and (t <= 1).all()
    below = _floats(_bits(t).long() - 1)
    k = torch.arange(1, levels + 1, dtype=torch.float32)
    assert torch.equal(level(t, float(levels)), k)
    assert torch.equal(level(below, float(levels)), k - 1)


@pytest.mark.parametrize("which", ["m", "v"])
def test_codes_by_thresholds_equal_the_plain_chain(which):
    """On seeded quotients, uniform and log-uniform in [0, 1], on every
    float within 256 ulps of every threshold, and on 0, 1 and the
    smallest subnormal, the count of thresholds <= q is the plain code."""
    level, levels, name = MAPS[which]
    thresholds = getattr(tq.q4_maps(), name)
    rng = np.random.default_rng(202)
    uniform = rng.random(1 << 20, dtype=np.float32)
    logu = np.ldexp(rng.random(1 << 20, dtype=np.float32) + 0.5,
                    rng.integers(-149, 1, 1 << 20)).astype(np.float32)
    logu = np.minimum(logu, np.float32(1.0))
    near = (_bits(torch.tensor(thresholds)).long()[:, None]
            + torch.arange(-256, 257)[None]).reshape(-1)
    edges = torch.tensor([0.0, 1.0, float(np.float32(2.0 ** -149))])
    q = torch.cat([torch.from_numpy(uniform), torch.from_numpy(logu),
                   _floats(near), edges])
    assert (q >= 0).all() and (q <= 1).all()
    want = level(q, float(levels))
    assert torch.equal(codes_by_thresholds(q, thresholds), want)
    assert torch.equal(codes_by_bins(q, thresholds), want)
    # NaN and -0.0 land in the last bin: code 0, as the search gave.
    odd = torch.tensor([float("nan"), -0.0])
    assert torch.equal(codes_by_bins(odd, thresholds), torch.zeros(2))


def test_bins_hold_one_threshold_each():
    """Every bin (a factor 1.25 at most) holds at most one threshold of
    either map, and its base counts the thresholds below it; two
    thresholds in one bin, or one below 2^-24, are refused."""
    maps = tq.q4_maps()
    for thresholds in (maps.m_thresholds, maps.v_thresholds):
        bins = tq.q4_bins(thresholds)
        assert len(bins) == tq.BINS
        inside = [t for t, _ in bins if t != float("inf")]
        # The thresholds on a bin's edge (0.25, 0.0625) are in a base.
        assert set(inside) <= set(thresholds)
        assert [b for _, b in bins[1:-1]] == sorted(b for _, b in bins[1:-1])
        assert bins[0] == bins[-1] == (float("inf"), 0)
        assert bins[-2][1] == len(thresholds)    # the bin of 1.0
    with pytest.raises(ValueError, match="holds"):
        tq.q4_bins((0.3, 0.31))
    with pytest.raises(ValueError, match="2\\^-24"):
        tq.q4_bins((2.0 ** -25, 0.5))


def test_maps_fill_the_c_struct_in_its_order():
    """``q4_maps_words`` follows ``struct Q4Maps`` of the kernel's source:
    its fields and their order, the bin constants, and the words."""
    src = open(CU).read()
    body = re.search(r"struct Q4Maps \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(float|Q4Bin) (\w+)\[(\w+)\];", body)
    assert fields == [("float", "m_table", "16"), ("float", "v_table", "16"),
                      ("Q4Bin", "m_bins", "BINS"), ("Q4Bin", "v_bins", "BINS")]
    bin_body = re.search(r"struct __align__\(8\) Q4Bin \{(.*?)\};", src,
                         re.S).group(1)
    assert re.findall(r"(float|int) (\w+);", bin_body) == [("float", "t"),
                                                          ("int", "base")]
    consts = dict(re.findall(r"constexpr int (BIN_\w+) = (0x[0-9A-F]+|\d+)",
                             src))
    assert int(consts["BIN_SHIFT"]) == tq.BIN_SHIFT
    assert int(consts["BIN_LOW"], 16) >> tq.BIN_SHIFT == tq.BIN_LOW
    assert int(consts["BIN_HIGH"], 16) >> tq.BIN_SHIFT == tq.BIN_HIGH
    maps = tq.q4_maps()
    words = tq.q4_maps_words(maps)
    assert words.dtype == np.uint32 and len(words) == 32 + 4 * tq.BINS
    assert tuple(words[:32].view(np.float32).tolist()) == (maps.m_table
                                                           + maps.v_table)
    for at, thresholds in ((32, maps.m_thresholds),
                           (32 + 2 * tq.BINS, maps.v_thresholds)):
        pairs = words[at:at + 2 * tq.BINS].reshape(-1, 2)
        assert tuple(zip(pairs[:, 0].view(np.float32).tolist(),
                         pairs[:, 1].tolist())) == tq.q4_bins(thresholds)
    # The array the wrapper passes is built once and holds these words.
    assert list(tq._q4_maps_arg()) == words.tolist()


def test_planted_threshold_faults_disagree_with_the_plain_chain():
    """``chip_smoke.py``'s planted faults (one threshold an ulp up) give
    another code than the plain chain at the moved threshold, which the
    on-card check reaches at scale 1 (x = the threshold)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    maps = tq.q4_maps()
    scales = cs._code_check_scales()
    assert 1.0 in scales and 2.0 ** -126 in scales
    assert len(scales) == 127 + 2 + cs.QUANT_CHECK_RANDOM_SCALES
    random = scales[-cs.QUANT_CHECK_RANDOM_SCALES:]
    assert ((random >= 1e-30) & (random <= 1e3)).all()
    assert not np.isin(np.array([0x007FFFFF, 0x00800001], np.uint32),
                       scales.view(np.uint32), invert=True).any()
    faults = cs.planted_threshold_faults(maps)
    assert len(faults) == 2
    for fault in faults.values():
        for which, (level, levels, name) in MAPS.items():
            moved = [a for a, b in zip(getattr(fault, name),
                                       getattr(maps, name)) if a != b]
            if not moved:
                continue
            q = torch.tensor(getattr(maps, name))
            assert len(moved) == 1
            assert not torch.equal(codes_by_bins(q, getattr(fault, name)),
                                   level(q, float(levels)))


def test_q4_code_check_takes_only_card_scales():
    with pytest.raises(ValueError, match="CUDA"):
        tq.q4_code_check(torch.ones(3))


def test_jax_q4_step_gives_the_codes_the_thresholds_give():
    """From a JAX q4 state carried across after 3 JAX steps, one
    ``dlrover_tpu.ops.quantization.q4_adam`` step (Pallas in interpret
    mode) writes the m and v codes that the thresholds give from the
    port's plain fp32 moments of the same step, and the same scales.

    XLA may contract a product and a sum of the moment update into one
    fused multiply-add, which rounds once where the plain version rounds
    twice, and then a moment and a scale differ in the last bit.  So b1
    = b2 = 0.5 and gradients of at most 8 significant bits: every product
    of the update is exact, the sums round alike fused or not, and the
    two packages' moments are equal bit for bit before they are coded."""
    rng = np.random.default_rng(303)
    shapes = {"w": (40, 130), "k": (3, 50, 40)}   # 5200 and 6000 values
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (np.round(25.6 * rng.normal(size=s)) / 256).astype(
        np.float32) for k, s in shapes.items()} for _ in range(4)]
    kw = dict(b1=0.5, b2=0.5, weight_decay=0.01)
    jtx = jq.q4_adam(1e-2, **kw)
    jparams = jax.tree.map(jax.numpy.asarray, params)
    jstate = jtx.init(jparams)
    for g in grads[:3]:
        _, jstate = jtx.update(jax.tree.map(jax.numpy.asarray, g), jstate,
                               jparams)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    carried = low_bit_state_from_jax(jax.tree.map(np.asarray, jstate),
                                     tparams)
    _, jnext = jtx.update(jax.tree.map(jax.numpy.asarray, grads[3]), jstate,
                          jparams)
    want = low_bit_state_from_jax(jax.tree.map(np.asarray, jnext), tparams)

    maps = tq.q4_maps()
    h = tq.adam_hyper(4, 1e-2, kw["b1"], kw["b2"], 1e-8, kw["weight_decay"])
    for k in shapes:
        m32 = tq._q4_m_decode(carried.m[k])
        v32 = tq._q4_v_decode(carried.v[k])
        _, m32, v32 = tq._adam(h, tq._to_blocks(torch.from_numpy(grads[3][k])),
                               tq._to_blocks(tparams[k]), m32, v32)
        for which, x, mom in (("m", m32.abs(), want.m[k]),
                              ("v", v32, want.v[k])):
            top = x.amax(dim=1, keepdim=True)
            scale = torch.where(top == 0, torch.ones_like(top), top)
            assert torch.equal(scale[:, 0], mom.scales), (which, k)
            level, levels, name = MAPS[which]
            codes = codes_by_bins(x / scale, getattr(maps, name))
            if which == "m":
                codes = torch.sign(m32) * codes
                jax_codes = tq.unpack_nibbles_signed(mom.q)
            else:
                jax_codes = tq.unpack_nibbles_unsigned(mom.q)
            assert codes.abs().max() > 0
            assert torch.equal(codes, jax_codes), (which, k)

"""The host side of the Hopper grouped-GEMM kernels (K8, K9) on the CPU:
their launch plan, a pure function of the shapes whose tile counts and
grid the kernels read, on every product of every shape that
``chip_smoke.py`` runs the kernels at (``GMM_CASES``, whose first case is
the MoE training step's shape) and at another SM count.  The order in
which the persistent blocks walk the work units is the kernels' own
(``unit_index``, ``unit_of`` and ``g_order`` in
``ops/csrc/grouped_matmul.cu``); the helpers below mirror it, so that the
plan's counts can be checked against the walk they drive.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them
against the plain versions.
"""

import importlib.util
import itertools
import math
import os
import re

import pytest

from dlrover_tpu_torch.ops import grouped_matmul as tgm
from dlrover_tpu_torch.ops import kernel_lib

SMEM_LIMIT = 232448  # shared memory a block may use on an H100
KERNEL_SOURCE = os.path.join(os.path.dirname(tgm.__file__), "csrc",
                             "grouped_matmul.cu")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
EXPERTS = CS.MOE_EXPERTS


# -- the kernels' walk, mirrored -----------------------------------------------


def dw_expert_order(sizes, n):
    """K9's order of the experts (the kernel's ``g_order``): by rows owned
    (the last expert's reach ``n``, the padding rows, unless it owns
    none), largest first, ties by index."""
    owned = [t - s if size > 0 else 0
             for (s, t), size in zip(tgm._ranges_of(sizes, n), sizes)]
    return sorted(range(len(sizes)), key=lambda e: (-owned[e], e))


def unit_of(plan, tile, order):
    """``(expert, row0, col0)`` of work unit ``tile`` (the kernel's
    ``unit_of``; expert None for K8, whose rows decide it)."""
    col_tiles = plan["col_tiles"]
    expert = None
    if plan["kind"] == "dw":
        per_expert = plan["row_tiles"] * col_tiles
        expert, tile = order[tile // per_expert], tile % per_expert
    return (expert, tile // col_tiles * plan["block_m"],
            tile % col_tiles * plan["block_n"])


def block_units(plan, block):
    """The units persistent block ``block`` takes, in order (the kernel's
    ``unit_index``): one a round, round r giving units r G .. r G + G - 1
    to the G blocks in block order, or in reverse on odd rounds."""
    grid, out = plan["grid"], []
    for r in itertools.count():
        tile = r * grid + (block if r % 2 == 0 else grid - 1 - block)
        if tile >= plan["tiles"]:
            return out
        out.append(tile)


# -- the shapes -----------------------------------------------------------------


def _rows(c):
    """The grouped rows of a case (``MoEMlp.route``'s static budget)."""
    choices = c["tokens"] * CS.MOE_TOP_K
    return (math.ceil(choices / CS.GMM_BLOCK) + EXPERTS) * CS.GMM_BLOCK


def _group_sizes(c, n):
    """Uneven groups in whole 128-row blocks, expert ``empty`` with none,
    the rest of the rows as the last expert's padding."""
    blocks = n // CS.GMM_BLOCK - EXPERTS
    weights = [0 if e == c["empty"] else e + 1 for e in range(EXPERTS)]
    sizes = [blocks * w // sum(weights) * CS.GMM_BLOCK for w in weights]
    assert sum(sizes) <= n
    return sizes


def _products(c):
    """``(name, kind, n, k, m)`` of one MoE layer's grouped products: K8
    takes ``[n, k]`` to ``[n, m]``, K9 gives ``[experts, k, m]``."""
    n, d, f = _rows(c), c["d"], c["f"]
    out = [("fwd_wi", "fwd", n, d, f), ("fwd_wo", "fwd", n, f, d),
           ("dx_wi", "dx", n, f, d), ("dx_wo", "dx", n, d, f),
           ("dw_wi", "dw", n, d, f), ("dw_wo", "dw", n, f, d)]
    if c["activation"] == "swiglu":
        out += [("fwd_wg", "fwd", n, d, f), ("dx_wg", "dx", n, f, d),
                ("dw_wg", "dw", n, d, f)]
    return out


PRODUCTS = [(c["case"], *p) for c in CS.GMM_CASES for p in _products(c)]
CASES = {c["case"]: c for c in CS.GMM_CASES}


@pytest.mark.parametrize("num_sms", [kernel_lib.H100_SMS, 100])
@pytest.mark.parametrize("case,name,kind,n,k,m", PRODUCTS)
def test_plan_tiles_cover_every_output_element_once(case, name, kind, n, k,
                                                    m, num_sms):
    plan = tgm.gmm_launch_plan(kind, n, k, m, EXPERTS, num_sms)
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert 1 <= plan["grid"] <= num_sms and plan["grid"] <= plan["tiles"]
    assert plan["block_m"] == tgm.KERNEL_ROWS == 128
    walks = [block_units(plan, b) for b in range(plan["grid"])]
    assert sorted(t for w in walks for t in w) == list(range(plan["tiles"]))
    # One unit a round per block, the rounds in order (the snake).
    for b, walk in enumerate(walks):
        assert [t // plan["grid"] for t in walk] == list(range(len(walk)))
    order = dw_expert_order(_group_sizes(CASES[case], n), n)
    units = [unit_of(plan, t, order) for t in range(plan["tiles"])]
    assert len(set(units)) == len(units)
    # Output rows (K8: tokens, K9: k) and columns in whole tiles: the
    # starts of the tiles step by the tile and the last one reaches the
    # edge, so every element lies in exactly one tile (per expert for K9).
    rows = k if kind == "dw" else n
    row_starts = range(0, rows, plan["block_m"])
    col_starts = range(0, m, plan["block_n"])
    experts = range(EXPERTS) if kind == "dw" else [None]
    assert sorted(units, key=str) == sorted(
        [(e, r, c) for e in experts for r in row_starts for c in col_starts],
        key=str)
    assert plan["row_tiles"] * plan["block_m"] >= rows
    assert plan["col_tiles"] * plan["block_n"] >= m
    assert (plan["row_tiles"] - 1) * plan["block_m"] < rows
    assert (plan["col_tiles"] - 1) * plan["block_n"] < m


@pytest.mark.parametrize("case,name,kind,n,k,m",
                         [p for p in PRODUCTS if p[2] != "dw"])
def test_k8_row_tiles_lie_inside_one_expert(case, name, kind, n, k, m):
    plan = tgm.gmm_launch_plan(kind, n, k, m, EXPERTS)
    assert tgm.KERNEL_ROWS % plan["block_m"] == 0
    ranges = tgm._ranges_of(_group_sizes(CASES[case], n), n)

    def expert(row):
        return next((e for e, (s, t) in enumerate(ranges) if s <= row < t),
                    EXPERTS - 1)

    for row0 in range(0, n, plan["block_m"]):
        last = min(row0 + plan["block_m"], n) - 1
        assert expert(row0) == expert(last)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k9_steps_stay_inside_an_expert_largest_first(case):
    c = CASES[case]
    n = _rows(c)
    sizes = _group_sizes(c, n)
    # K9 sums an expert's rows in whole K tiles from its first row: every
    # group boundary is a multiple of 128, which the K tile divides.
    assert CS.GMM_BLOCK % tgm.BLOCK_K == 0 and tgm.BLOCK_K == 64
    ranges = tgm._ranges_of(sizes, n)
    for (start, end), size in zip(ranges, sizes):
        assert start % tgm.BLOCK_K == 0 and (end % tgm.BLOCK_K == 0
                                             or size == 0)
    order = dw_expert_order(sizes, n)
    owned = [t - s if size else 0 for (s, t), size in zip(ranges, sizes)]
    assert sorted(order) == list(range(EXPERTS))
    assert [owned[e] for e in order] == sorted(owned, reverse=True)
    assert order[-1] == c["empty"] or owned[order[-1]] == 0
    # The last expert owns the padding rows: it reaches n.
    assert ranges[-1][1] == n


def test_plan_at_the_moe_step_shapes():
    """The 24-layer MoE step's products (33,792 rows, d 1600, f 3200):
    264 row tiles, two per SM; 256-wide tiles on every output, the last of
    them half wide (12.5 on the 3200-wide ones, 6.5 on the 1600-wide
    ones); an output at most 128 wide is one half tile."""
    n = 33792
    assert n == _rows(CASES[CS.GMM_SLICE_CASE])
    fwd_wi = tgm.gmm_launch_plan("fwd", n, 1600, 3200, EXPERTS)
    assert (fwd_wi["block_n"], fwd_wi["stages"]) == (256, 4)
    assert fwd_wi["smem_bytes"] == 198464
    assert fwd_wi["row_tiles"] == 264 == 2 * kernel_lib.H100_SMS
    assert fwd_wi["tiles"] == 264 * 13 and fwd_wi["grid"] == 132
    fwd_wo = tgm.gmm_launch_plan("fwd", n, 3200, 1600, EXPERTS)
    assert fwd_wo["tiles"] == 264 * 7
    # The last column tile of both widths is a half tile (at most 128
    # columns left: the kernels' test).
    for plan, m in ((fwd_wi, 3200), (fwd_wo, 1600)):
        assert m - (plan["col_tiles"] - 1) * plan["block_n"] <= 128
    dw_wi = tgm.gmm_launch_plan("dw", n, 1600, 3200, EXPERTS)
    assert dw_wi["tiles"] == EXPERTS * 13 * 13
    ragged = tgm.gmm_launch_plan("dx", 1536, 72, 40, EXPERTS)
    assert (ragged["block_n"], ragged["col_tiles"]) == (256, 1)
    assert ragged["tiles"] == 12 and ragged["grid"] == 12
    with pytest.raises(ValueError):
        tgm.gmm_launch_plan("dgrad", n, 1600, 3200, EXPERTS)


def test_plan_struct_and_constants_match_the_kernel_source():
    """The ctypes ``GmmPlan`` lists the C struct's fields in its order,
    and the tile, ring and expert table the plan states are the ones the
    kernels are built for (the entry points refuse any other at launch)."""
    src = open(KERNEL_SOURCE).read()
    body = re.search(r"struct GmmPlan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = re.findall(r"\w+", re.sub(r"\bint\b", " ", body))
    assert fields == [name for name, _ in tgm.GmmPlan._fields_]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BM"), const("BN"), const("BK"), const("STAGES"),
            const("MAX_EXPERTS")) == (tgm.KERNEL_ROWS, tgm.BLOCK_N,
                                      tgm.BLOCK_K, tgm.STAGES,
                                      tgm.MAX_EXPERTS)
    plan = tgm.gmm_launch_plan("dw", 1536, 72, 40, EXPERTS, 100)
    packed = tgm.GmmPlan.of(plan)
    assert [getattr(packed, name) for name, _ in packed._fields_] == [
        plan[name] for name, _ in packed._fields_]

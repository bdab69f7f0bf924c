"""Port parity: ``dlrover_tpu_torch.ops.quantization`` (block quantize and
dequantize, q8/q4 Adam) against ``dlrover_tpu.ops.quantization``.

The same numpy inputs go through both packages in fp32 on the CPU: the
JAX side through its Pallas kernels in interpret mode, the port through
the plain versions its CUDA kernels are held against on the card.

Tolerances.  ``quantize`` divides and rounds as JAX does, so its codes
are equal and its scales agree to 1e-6.  An Adam step chains some ten
fp32 operations, which XLA may fuse (a multiply-add rounds once where the
plain version rounds twice): updates agree to ``UPD_RTOL`` of the leaf's
largest update, the scales to 1e-6, and the codes are equal but for at
most ``CODE_SHARE`` of them, each by one level (a value an ulp from a .5
boundary).  Measured here: updates within 3e-7, no code off at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.ops import quantization as jq
from dlrover_tpu_torch.models.from_jax import low_bit_state_from_jax
from dlrover_tpu_torch.ops import quantization as tq
from dlrover_tpu_torch.optimizers import optax_ports as ox

UPD_RTOL = 2e-6
SCALE_RTOL = 1e-6
CODE_SHARE = 1e-3

ADAMS = {8: (jq.q8_adam, tq.q8_adam, tq.Q8AdamState),
         4: (jq.q4_adam, tq.q4_adam, tq.Q4AdamState)}
# Two quantized leaves (a ragged tail: 5200 = 20 x 256 + 80; a layer-
# stacked block leaf) and one below min_quant_size.
SHAPES = {"w": (40, 130), "blocks.k": (3, 50, 40), "b": (300,)}


def _tree(rng, scale):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _nested(flat):
    """The port's flat names -> the JAX tree's nested dicts."""
    return {"w": flat["w"], "blocks": {"k": flat["blocks.k"]},
            "b": flat["b"]}


def _jnp(flat):
    return jax.tree.map(jnp.asarray, _nested(flat))


def _flat(nested):
    return {"w": np.asarray(nested["w"]),
            "blocks.k": np.asarray(nested["blocks"]["k"]),
            "b": np.asarray(nested["b"])}


def _torch(flat):
    return {k: torch.as_tensor(np.array(v)) for k, v in flat.items()}


def _codes(bits, which, q):
    if bits == 8:
        return q.float()
    unpack = (tq.unpack_nibbles_signed if which == "m"
              else tq.unpack_nibbles_unsigned)
    return unpack(q)


def _assert_updates_close(got, want):
    for k in want:
        limit = UPD_RTOL * np.abs(want[k]).max()
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=limit, err_msg=k)


def _assert_states_close(bits, got, want):
    """``want`` is a JAX state carried across."""
    assert got.count == want.count
    for which in ("m", "v"):
        for k, w in getattr(want, which).items():
            g = getattr(got, which)[k]
            if not isinstance(w, tq.QMoment):
                torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-9,
                                           msg=k)
                continue
            torch.testing.assert_close(g.scales, w.scales, rtol=SCALE_RTOL,
                                       atol=0, msg=f"{which} {k}")
            diff = (_codes(bits, which, g.q)
                    - _codes(bits, which, w.q)).abs()
            assert diff.max() <= 1, (which, k)
            assert (diff > 0).float().mean() <= CODE_SHARE, (which, k)


@pytest.mark.parametrize("n", [1, 255, 256, 5000])
def test_quantize_and_dequantize_match_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n,)).astype(np.float32)
    if n == 5000:
        x = x.reshape(50, 100)
        x[10:20] = 0.0  # rows 1000..2000: blocks 4..6 are all zero
    want_q, want_s = jq.quantize(jnp.asarray(x))
    q, s = tq.quantize(torch.as_tensor(x))
    rows = tq.num_blocks(n)
    assert q.shape == (rows, tq.BLOCK) and q.dtype == torch.int8
    assert s.shape == (rows,) and s.dtype == torch.float32
    # The JAX arrays pad the rows to 8 and broadcast each scale to 128.
    assert np.array_equal(q.numpy(), np.asarray(want_q)[:rows])
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s)[:rows, 0],
                               rtol=SCALE_RTOL)
    if n == 5000:
        assert (s[4:7] == 1.0).all() and (q[4:7] == 0).all()
    back = tq.dequantize(q, s, x.shape)
    want_back = jq.dequantize(want_q, want_s, x.shape)
    assert back.shape == x.shape and back.dtype == torch.float32
    np.testing.assert_allclose(back.numpy(), np.asarray(want_back),
                               rtol=1e-6, atol=0)
    # Half a level of the block's scale at most.
    err = np.abs(back.numpy() - x).reshape(-1)
    bound = np.repeat(s.numpy(), tq.BLOCK)[:n] * 0.5 * (1 + 1e-6)
    assert (err <= bound).all()


def test_quantize_takes_bf16_as_its_fp32_cast():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(700,)).astype(np.float32)).to(
        torch.bfloat16)
    q, s = tq.quantize(x)
    q32, s32 = tq.quantize(x.float())
    assert torch.equal(q, q32) and torch.equal(s, s32)


def test_nibble_pack_round_trip_and_layout():
    rng = np.random.default_rng(3)
    signed = rng.integers(-7, 8, size=(5, tq.BLOCK)).astype(np.int32)
    unsigned = rng.integers(0, 16, size=(5, tq.BLOCK)).astype(np.int32)
    ps, pu = (tq.pack_nibbles(torch.as_tensor(x)) for x in (signed,
                                                            unsigned))
    assert ps.shape == (5, tq.BLOCK // 2) and ps.dtype == torch.int8
    assert np.array_equal(tq.unpack_nibbles_signed(ps).numpy(), signed)
    assert np.array_equal(tq.unpack_nibbles_unsigned(pu).numpy(), unsigned)
    # Byte j holds element 2j low, 2j + 1 high: JAX's packer and unpackers.
    assert np.array_equal(
        ps.numpy(), np.asarray(jq._pack_nibbles_signed(jnp.asarray(signed))))
    assert np.array_equal(
        pu.numpy(),
        np.asarray(jq._pack_nibbles_signed(jnp.asarray(unsigned))))
    assert np.array_equal(
        tq.unpack_nibbles_signed(ps).numpy(),
        np.asarray(jq._unpack_nibbles_signed(jnp.asarray(ps.numpy()))))
    assert np.array_equal(
        tq.unpack_nibbles_unsigned(pu).numpy(),
        np.asarray(jq._unpack_nibbles_unsigned(jnp.asarray(pu.numpy()))))


@pytest.mark.parametrize("bits", [8, 4])
def test_one_step_from_a_carried_jax_state(bits):
    """Both packages start step 4 from the JAX state after 3 JAX steps:
    one step's difference, free of drift."""
    jadam, tadam, state_cls = ADAMS[bits]
    rng = np.random.default_rng(bits)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, 0.1) for _ in range(4)]
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.01)
    jtx, ttx = jadam(1e-2, **kw), tadam(1e-2, **kw)
    jparams = _jnp(params)
    jstate = jtx.init(jparams)
    for g in grads[:3]:
        _, jstate = jtx.update(_jnp(g), jstate, jparams)

    tparams = _torch(params)
    tstate = low_bit_state_from_jax(jax.tree.map(np.asarray, jstate),
                                    tparams)
    assert isinstance(tstate, state_cls) and tstate.count == 3
    for k, shape in SHAPES.items():
        n = int(np.prod(shape))
        m = tstate.m[k]
        if n < 4096:
            assert m.shape == shape and m.dtype == torch.float32
        else:
            # The padding rows and the scale lanes are gone.
            assert m.q.shape == (tq.num_blocks(n), tq.BLOCK * bits // 8)
            assert m.scales.shape == (tq.num_blocks(n),)
            assert m.q.abs().max() > 0

    want_u, want_state = jtx.update(_jnp(grads[3]), jstate, jparams)
    got_u, got_state = ttx.update(_torch(grads[3]), tstate, tparams)
    _assert_updates_close(got_u, _flat(want_u))
    _assert_states_close(bits, got_state, low_bit_state_from_jax(
        jax.tree.map(np.asarray, want_state), tparams))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["constant", "schedule"])
def test_three_steps_from_zero_state_track_jax(bits, scheduled):
    """Each package runs on its own state; weight decay on, and the
    learning rate a constant or a warm-up schedule called with the step
    count."""
    jadam, tadam, _ = ADAMS[bits]
    rng = np.random.default_rng(10 + bits)
    params = _tree(rng, 1.0)
    jlr = optax.linear_schedule(0.0, 1e-2, 4) if scheduled else 1e-2
    tlr = ox.linear_schedule(0.0, 1e-2, 4) if scheduled else 1e-2
    jtx, ttx = jadam(jlr, weight_decay=0.1), tadam(tlr, weight_decay=0.1)
    jparams, tparams = _jnp(params), _torch(params)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    assert tstate.count == 0
    for step in range(3):
        g = _tree(rng, 0.1)
        want_u, jstate = jtx.update(_jnp(g), jstate, jparams)
        got_u, tstate = ttx.update(_torch(g), tstate, tparams)
        _assert_updates_close(got_u, _flat(want_u))
        jparams = optax.apply_updates(jparams, want_u)
        # Both sides go on from JAX's parameters: the states alone carry
        # the (rounding-sized) difference forward.
        tparams = _torch(_flat(jparams))
    _assert_states_close(bits, tstate, low_bit_state_from_jax(
        jax.tree.map(np.asarray, jstate), tparams))


@pytest.mark.parametrize("bits", [8, 4])
def test_small_leaves_take_the_exact_adam(bits):
    """A leaf below ``min_quant_size`` keeps fp32 moments whatever the
    parameter's dtype and moves as AdamW moves it.  eps sits outside the
    bias correction here and inside it in ``adamw``, which shifts an
    update of size lr = 1e-2 by up to 1e-5 where the gradient is small:
    atol 1e-5.  (Against JAX's small-leaf path, the same formula, the
    other tests hold this leaf to ``UPD_RTOL``.)"""
    _, tadam, _ = ADAMS[bits]
    rng = np.random.default_rng(20)
    p = {"b": torch.as_tensor(rng.normal(size=(300,)).astype(np.float32))}
    low, full = tadam(1e-2, weight_decay=0.1), ox.adamw(1e-2,
                                                        weight_decay=0.1)
    ls, fs = low.init(p), full.init(p)
    assert ls.m["b"].dtype == torch.float32 and ls.m["b"].shape == (300,)
    for _ in range(3):
        g = {"b": torch.as_tensor(
            rng.normal(size=(300,)).astype(np.float32))}
        lu, ls = low.update(g, ls, p)
        fu, fs = full.update(g, fs, p)
        torch.testing.assert_close(lu["b"], fu["b"], rtol=0, atol=1e-5)
    bf = {"b": p["b"].to(torch.bfloat16)}
    state = low.init(bf)
    upd, state = low.update({"b": bf["b"] * 0.1}, state, bf)
    assert upd["b"].dtype == torch.bfloat16
    assert state.m["b"].dtype == torch.float32


@pytest.mark.parametrize("bits,per_param", [(8, 2 + 8 / 256),
                                            (4, 1 + 8 / 256)])
def test_state_bytes_per_parameter(bits, per_param):
    """Codes plus one fp32 scale per block for each of m and v.  The JAX
    arrays hold more (q8 scales broadcast to 128 lanes, rows padded): that
    is TPU layout, which the port drops."""
    _, tadam, _ = ADAMS[bits]
    n = 64 * tq.BLOCK
    params = {"w": torch.zeros((64, tq.BLOCK))}
    state = tadam().init(params)
    nbytes = sum(t.numel() * t.element_size()
                 for mom in (state.m["w"], state.v["w"]) for t in mom)
    assert nbytes == per_param * n
    jstate = ADAMS[bits][0]().init({"w": jnp.zeros((64, tq.BLOCK))})
    jbytes = sum(a.nbytes for mom in (jstate.m["w"], jstate.v["w"])
                 for a in mom)
    assert jbytes > nbytes


@pytest.mark.parametrize("bits", [8, 4])
def test_update_without_params_raises(bits):
    tx = ADAMS[bits][1]()
    params = {"w": torch.zeros((8, 8))}
    with pytest.raises(ValueError, match="requires params"):
        tx.update(params, tx.init(params), None)


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((512,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tq.quantize(meta)
    with pytest.raises(ValueError, match="no kernel"):
        tq.dequantize(torch.empty((2, 256), dtype=torch.int8, device="meta"),
                      torch.empty((2,), device="meta"), (512,))
    mom = tq.QMoment(torch.empty((2, 256), dtype=torch.int8, device="meta"),
                     torch.empty((2,), device="meta"))
    h = tq.adam_hyper(1, 1e-3, 0.9, 0.999, 1e-8, 0.0)
    with pytest.raises(ValueError, match="no kernel"):
        tq.q8_adam_update(meta, meta, mom, mom, h)


def test_adam_hyper_is_fp32_and_calls_the_schedule_with_the_count():
    seen = []
    h = tq.adam_hyper(3, lambda c: seen.append(c) or 0.1, 0.9, 0.95, 1e-8,
                      0.1)
    assert seen == [3]
    assert h.lr == float(np.float32(0.1)) and h.b2 == float(np.float32(0.95))
    want = jnp.sqrt(1.0 - 0.95 ** jnp.float32(3)) / (
        1.0 - 0.9 ** jnp.float32(3))
    np.testing.assert_allclose(h.bias_scale, float(want), rtol=2e-7)


def test_low_bit_state_from_jax_refuses_a_foreign_tree():
    jstate = jq.q8_adam().init({"w": jnp.zeros((40, 130))})
    state = jax.tree.map(np.asarray, jstate)
    with pytest.raises(KeyError, match="no counterpart"):
        low_bit_state_from_jax(state, {"other": torch.zeros((40, 130))})
    with pytest.raises(KeyError, match="lacks leaves"):
        low_bit_state_from_jax(state, {"w": torch.zeros((40, 130)),
                                       "b": torch.zeros((3,))})
    with pytest.raises(ValueError, match="quantized rows"):
        low_bit_state_from_jax(state, {"w": torch.zeros((400, 130))})


# -- chip_smoke.py's checks of K6/K7, at a small size on the CPU ----------------


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("bits", [8, 4])
def test_chip_adam_check_catches_planted_faults(bits):
    """The check ``chip_smoke.py`` holds K6/K7 to accepts the plain
    update itself and one with a single code a level off, and rejects the
    planted faults (q8: v decoded linearly; q4: the high nibbles dropped)
    and a result whose codes are two levels off."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(bits)
    n_rows = 64
    g = (torch.randn((n_rows, tq.BLOCK), generator=gen) * 1e-3).bfloat16()
    p = (torch.randn((n_rows, tq.BLOCK), generator=gen) * 0.02).bfloat16()
    if bits == 8:
        m = tq.QMoment(*tq.quantize(
            torch.randn((n_rows, tq.BLOCK), generator=gen) * 1e-3))
        v = tq.QMoment(
            torch.randint(0, 128, (n_rows, tq.BLOCK), generator=gen,
                          dtype=torch.int8),
            torch.rand((n_rows,), generator=gen) * 1e-6 + 1e-9)
        plain = tq.q8_adam_update_reference
    else:
        m = tq.QMoment(tq.pack_nibbles(torch.randint(
            -7, 8, (n_rows, tq.BLOCK), generator=gen)),
            torch.rand((n_rows,), generator=gen) * 1e-3 + 1e-6)
        v = tq.QMoment(tq.pack_nibbles(torch.randint(
            0, 16, (n_rows, tq.BLOCK), generator=gen)),
            torch.rand((n_rows,), generator=gen) * 1e-6 + 1e-9)
        plain = tq.q4_adam_update_reference
    h = tq.adam_hyper(3, 1e-4, 0.9, 0.95, 1e-8, 0.1)
    ref = plain(g, p, m, v, h)
    assert cs.adam_ok(cs._adam_errors(bits, ref, ref))
    fault = cs._quant_planted_fault(bits, g, p, m, v, h, ref)
    assert fault["caught"], fault

    def nudged(levels):
        # One code of m moved: 1 of 16,384 is inside QUANT_CODE_SHARE.
        q = ref[1].q.clone()
        low = q[0, 0] & 0xF if bits == 4 else q[0, 0]
        step = levels if int(low) < 4 else -levels
        q[0, 0] += step
        return ref[0], tq.QMoment(q, ref[1].scales), ref[2]

    assert cs.adam_ok(cs._adam_errors(bits, nudged(1), ref))
    assert not cs.adam_ok(cs._adam_errors(bits, nudged(2), ref))


def test_chip_lowbit_launch_counts_follow_the_config_and_state():
    cs = _chip_smoke()
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib as ttl

    cfg = gpt2_config("124m", num_layers=3, d_model=64, num_heads=4,
                      vocab_size=128, max_seq_len=64,
                      attention_impl="flash", remat="flash_only",
                      fused_ln=True, pin_attn_layouts=True)
    train = ttl.build_train(cfg, ttl.make_optimizer("q4_adam"),
                            global_batch_size=2, seq_len=16, device="cpu")
    state = train.init(seed=0)
    want, quantized = cs._lowbit_per_step(cfg, state.opt_state, 4)
    # Of the 16 leaves, the block biases and norm scales [3, 64] and
    # [3, 192] and ln_final's are below 4,096 values.
    names = [k for k, m in state.opt_state[-1].m.items()
             if isinstance(m, tq.QMoment)]
    assert quantized == len(names) == 6
    assert want["q4_adam"] == 6 and want["q8_adam"] == 0
    assert want["norm_bwd"] == 6 and want["pin_copy"] == 18
    assert want["flash_fwd"] == want["flash_bwd_fused"] == 3
    assert cs._state_bytes(state.opt_state) == sum(
        t.numel() * t.element_size()
        for tree in (state.opt_state[-1].m, state.opt_state[-1].v)
        for leaf in tree.values()
        for t in (leaf if isinstance(leaf, tq.QMoment) else (leaf,)))
    with pytest.raises(KeyError, match="no such launch counter"):
        cs._per_step(nonesuch=1)

"""Port parity: ``dlrover_tpu_torch.ops.fused_norm`` and ``ops.layout_pin``
against ``dlrover_tpu.ops.fused_norm`` / ``ops.layout_pin``, and the
``fused_ln`` / ``pin_attn_layouts`` model flags against the JAX model's.

The same numpy inputs go through both packages on the CPU: the JAX side
through its Pallas kernel in interpret mode, the port through the plain
version its CUDA kernel is held against on the card.  In fp32 the forward
and dx, dscale, dbias agree to ``ATOL`` = 1e-5 (sums of up to 384 terms
taken in another order; dscale and dbias are sums over up to 100 rows of
values of order 1, held to 1e-5 of their largest value).  The 2-layer
models agree to 1e-4, as the logits of the other model tests do.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models.transformer import TransformerConfig as JConfig
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.ops import fused_norm as jfn
from dlrover_tpu.ops import layout_pin as jpin
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models import layers
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import TransformerConfig as TConfig
from dlrover_tpu_torch.models.transformer import TransformerLM as TModel
from dlrover_tpu_torch.ops import fused_norm as tfn
from dlrover_tpu_torch.ops import layout_pin as tpin
from dlrover_tpu_torch.trainer import train_lib as ttl

EPS = 1e-5
ATOL = 1e-5

# (shape, bias, JAX block_rows): the shapes of tests/test_fused_norm.py
# (rows that are and are not a multiple of the block, a 3-D input without
# bias), and a small odd width.
LN_CASES = {
    "rows64_d256": ((64, 256), True, 32),
    "ragged_rows100_d384": ((100, 384), True, 32),
    "batched_no_bias": ((4, 16, 128), False, 16),
    "odd_d33": ((7, 33), True, 256),
}


def _inputs(seed, shape, bias):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.normal(size=(d,)) * 0.3 + 1.0).astype(np.float32)
    b = (rng.normal(size=(d,)) * 0.1).astype(np.float32) if bias else None
    dy = rng.normal(size=shape).astype(np.float32)
    return x, scale, b, dy


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=0,
        atol=ATOL * max(1.0, np.abs(want).max()), err_msg=name)


def _port_vjp(fn, x, params, dy):
    """``(y, dx, dparams...)`` of ``fn(x, *params)`` by autograd."""
    xt = torch.as_tensor(x).requires_grad_()
    pt = [None if p is None else torch.as_tensor(p).requires_grad_()
          for p in params]
    y = fn(xt, *pt)
    grads = torch.autograd.grad(
        y, [xt] + [p for p in pt if p is not None], torch.as_tensor(dy))
    return (y,) + grads


@pytest.mark.parametrize("case", sorted(LN_CASES))
def test_fused_layernorm_matches_jax_vjp(case):
    shape, bias, block_rows = LN_CASES[case]
    x, scale, b, dy = _inputs(1, shape, bias)
    want_y, vjp = jax.vjp(
        lambda x_, s_, b_: jfn.fused_layernorm(x_, s_, b_, EPS, block_rows),
        jnp.asarray(x), jnp.asarray(scale),
        None if b is None else jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    got = _port_vjp(lambda x_, s_, b_: tfn.fused_layernorm(x_, s_, b_, EPS),
                    x, (scale, b), dy)
    _close(got[0], want_y, "y")
    _close(got[1], want[0], "dx")
    _close(got[2], want[1], "dscale")
    if bias:
        _close(got[3], want[2], "dbias")
    assert got[1].shape == shape and got[2].shape == (shape[-1],)

    # The unfused module under plain autograd gives the same.
    norm = layers.LayerNorm(shape[-1], use_bias=bias)
    plain = _port_vjp(
        lambda x_, s_, b_: torch.func.functional_call(
            norm, {"scale": s_} if b_ is None else {"scale": s_,
                                                    "bias": b_}, (x_,)),
        x, (scale, b), dy)
    for g, p, name in zip(got, plain, ("y", "dx", "dscale", "dbias")):
        _close(g, p.detach().numpy(), f"unfused {name}")


@pytest.mark.parametrize("shape", [(50, 256), (3, 5, 40)],
                         ids=["rows50_d256", "batched_d40"])
def test_fused_rmsnorm_matches_jax_vjp(shape):
    x, scale, _, dy = _inputs(2, shape, False)
    want_y, vjp = jax.vjp(
        lambda x_, s_: jfn.fused_rmsnorm(x_, s_, EPS, 16),
        jnp.asarray(x), jnp.asarray(scale))
    want = vjp(jnp.asarray(dy))
    got = _port_vjp(lambda x_, s_: tfn.fused_rmsnorm(x_, s_, EPS), x,
                    (scale,), dy)
    for g, w, name in zip(got, (want_y,) + tuple(want),
                          ("y", "dx", "dscale")):
        _close(g, w, name)
    norm = layers.RMSNorm(shape[-1])
    plain = _port_vjp(
        lambda x_, s_: torch.func.functional_call(norm, {"scale": s_},
                                                  (x_,)),
        x, (scale,), dy)
    for g, p, name in zip(got, plain, ("y", "dx", "dscale")):
        _close(g, p.detach().numpy(), f"unfused {name}")


def test_backward_reference_ignores_mean_without_center():
    x, scale, _, dy = _inputs(3, (9, 24), False)
    xt, dyt, st = (torch.as_tensor(a) for a in (x, dy, scale))
    _, mean, rstd = tfn.norm_forward(xt, st, None, EPS, False)
    assert mean.numel() == 0 and rstd.shape == (9,)
    a = tfn.layernorm_backward(xt, dyt, st, mean, rstd, center=False)
    b = tfn.layernorm_backward_reference(
        xt, dyt, st, torch.full((9,), 7.0), rstd, center=False)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_bf16_round_trip_and_gradient_dtypes():
    """bf16 in, bf16 out and dx; dscale and dbias in the scale's dtype.
    Against the unfused module: the forward rounds to bf16 once in both
    (one bf16 ulp, 2^-8 of values up to 4: atol 2e-2, as the JAX test has
    it)."""
    x, scale, b, dy = _inputs(4, (32, 256), True)
    xt = torch.as_tensor(x).to(torch.bfloat16).requires_grad_()
    st = torch.as_tensor(scale).requires_grad_()
    bt = torch.as_tensor(b).requires_grad_()
    y = tfn.fused_layernorm(xt, st, bt, EPS)
    assert y.dtype == torch.bfloat16
    dx, ds, db = torch.autograd.grad(
        y, (xt, st, bt), torch.as_tensor(dy).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16
    assert ds.dtype == torch.float32 and db.dtype == torch.float32
    norm = layers.LayerNorm(256)
    want = torch.func.functional_call(
        norm, {"scale": st, "bias": bt}, (xt,))
    torch.testing.assert_close(y.float(), want.float(), rtol=0, atol=2e-2)
    want_j = jfn.fused_layernorm(jnp.asarray(x).astype(jnp.bfloat16),
                                 jnp.asarray(scale), jnp.asarray(b), EPS)
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want_j, np.float32), rtol=0,
                               atol=2e-2)
    st16 = st.detach().to(torch.bfloat16).requires_grad_()
    y16 = tfn.fused_layernorm(xt, st16, None, EPS)
    (ds16,) = torch.autograd.grad(y16, (st16,), torch.ones_like(y16))
    assert ds16.dtype == torch.bfloat16


def test_fused_norm_refuses_devices_without_a_kernel():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfn.fused_layernorm(x, torch.empty(8, device="meta"), None)
    with pytest.raises(ValueError, match="no kernel"):
        tfn.layernorm_backward(x, x, torch.empty(8, device="meta"),
                               torch.empty(4, device="meta"),
                               torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tpin.pin_layout(x)


def test_make_norm_passes_the_flag():
    for kind, cls in (("layernorm", layers.LayerNorm),
                      ("rmsnorm", layers.RMSNorm)):
        assert not layers.make_norm(kind, 8).fused_backward
        norm = layers.make_norm(kind, 8, fused_backward=True)
        assert isinstance(norm, cls) and norm.fused_backward


# -- pin_layout -----------------------------------------------------------------


def test_pin_layout_is_an_identity_with_an_identity_gradient():
    rng = np.random.default_rng(5)
    base = torch.as_tensor(rng.normal(size=(3, 8, 10)).astype(np.float32))
    view = base.transpose(1, 2)[:, 1:9:2]     # strided, not contiguous
    assert not view.is_contiguous()
    x = view.clone().requires_grad_()
    strided = x.transpose(0, 2)
    y = tpin.pin_layout(strided)
    assert y.is_contiguous() and y.shape == strided.shape
    assert torch.equal(y, strided)
    assert y.data_ptr() != x.data_ptr()
    g = torch.as_tensor(rng.normal(size=tuple(y.shape)).astype(np.float32))
    # A transposed cotangent comes back pinned and unchanged in value.
    (dx,) = torch.autograd.grad(y, (x,), g.transpose(0, 1).contiguous()
                                .transpose(0, 1))
    assert torch.equal(dx, g.transpose(0, 2))
    # JAX's is the identity too (off the TPU it skips the kernel).
    want, vjp = jax.vjp(jpin.pin_layout, jnp.asarray(strided.detach().numpy()))
    assert np.array_equal(y.detach().numpy(), np.asarray(want))
    assert np.array_equal(np.asarray(vjp(jnp.asarray(g.numpy()))[0]),
                          g.numpy())
    assert torch.equal(tpin.pin_layout_reference(view), view)
    assert tpin.pin_layout_reference(view).is_contiguous()


@pytest.mark.parametrize("shape,transform,want", [
    ((4, 6, 8), lambda t: t, ([192], [1])),
    ((4, 6, 8), lambda t: t.transpose(1, 2), ([4, 8, 6], [48, 1, 8])),
    ((4, 6, 8), lambda t: t[:, :, ::2], ([96], [2])),
    ((4, 6, 8), lambda t: t[:, :, :5], ([24, 5], [8, 1])),
    ((4, 1, 8), lambda t: t.expand(4, 3, 8), ([4, 3, 8], [8, 0, 1])),
], ids=["contiguous", "transposed", "every_other", "sliced", "expanded"])
def test_merged_dims(shape, transform, want):
    """What the kernel indexes: size-1 dims dropped, neighbours that one
    stride walks merged."""
    assert tpin.merged_dims(transform(torch.zeros(shape))) == want


# -- the model flags --------------------------------------------------------------

GPT2 = dict(vocab_size=96, num_layers=2, d_model=64, num_heads=4,
            max_seq_len=48)
LLAMA = dict(vocab_size=96, num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, d_ff=96, max_seq_len=48, position="rope",
             norm="rmsnorm", activation="swiglu", use_bias=False,
             tie_embeddings=False)
_INITS = {}


def _jax_init(name, kw):
    if name not in _INITS:
        params = nn.meta.unbox(JModel(JConfig(**kw)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
        _INITS[name] = params
    return _INITS[name]


def _model_logits_and_grads(name, kw, tokens, targets, **flags):
    """``(port logits, port grads, JAX logits, JAX grads)`` in fp32 from
    one JAX init, both models built with ``flags``."""
    params = _jax_init(name, kw)
    jcfg = JConfig(**kw, dtype=jnp.float32, **flags)
    tcfg = TConfig(**kw, dtype=torch.float32, **flags)

    def jloss(p):
        logits, _ = JModel(jcfg).apply({"params": p}, jnp.asarray(tokens))
        return jtl.cross_entropy_loss(logits, jnp.asarray(targets))[0], logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = TModel(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    logits = model(torch.as_tensor(tokens))
    loss, _ = ttl.cross_entropy_loss(logits, torch.as_tensor(targets))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    return logits.detach(), grads, np.asarray(jlogits), want


@pytest.mark.parametrize("name,kw,impl,remat", [
    ("gpt2", GPT2, "xla", "none"),
    ("gpt2", GPT2, "flash", "flash_only"),
    ("llama", LLAMA, "xla", "none"),
])
@pytest.mark.parametrize("flags", [
    dict(fused_ln=True), dict(pin_attn_layouts=True),
    dict(fused_ln=True, pin_attn_layouts=True),
], ids=["fused_ln", "pin", "both"])
def test_model_flags_match_flags_off_and_jax(name, kw, impl, remat, flags):
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 96, size=(2, 40))
    targets = rng.integers(0, 96, size=(2, 40))
    extra = dict(attention_impl=impl, remat=remat)
    off = _model_logits_and_grads(name, kw, tokens, targets, **extra)
    on = _model_logits_and_grads(name, kw, tokens, targets, **extra,
                                 **flags)
    np.testing.assert_allclose(on[0].numpy(), off[0].numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(on[0].numpy(), on[2], rtol=0, atol=1e-4)
    for k, g in on[1].items():
        scale = max(1.0, float(off[1][k].abs().max()))
        torch.testing.assert_close(g, off[1][k], rtol=0, atol=1e-4 * scale,
                                   msg=f"flags off: {k}")
        torch.testing.assert_close(g, on[3][k], rtol=0, atol=1e-4 * scale,
                                   msg=f"jax: {k}")


def test_fused_ln_leaves_the_final_norm_unfused():
    """As in JAX (``ln_final`` is built without the flag), and the
    backward of every block norm goes through ``layernorm_backward``."""
    cfg = TConfig(**GPT2, dtype=torch.float32, fused_ln=True,
                  pin_attn_layouts=True)
    model = TModel(cfg, device="cpu")
    assert not model.ln_final.fused_backward
    assert all(b.ln_attn.fused_backward and b.ln_mlp.fused_backward
               and b.pin_attn_layouts for b in model.blocks)
    assert not TConfig(**GPT2).fused_ln
    assert not TConfig(**GPT2).pin_attn_layouts


@pytest.mark.parametrize("remat,pins_per_layer", [("none", 4),
                                                  ("flash_only", 6)])
def test_kernel_call_counts_per_step(monkeypatch, remat, pins_per_layer):
    """What a step calls where the card launches kernels: the norm
    backward twice per layer; the pin twice per layer forward, twice on
    the cotangent and, under remat, twice more in the recompute."""
    calls = {"norm": 0, "pin": 0}
    plain_bwd, plain_pin = tfn.layernorm_backward, tpin.pin_copy

    def bwd(*a, **k):
        calls["norm"] += 1
        return plain_bwd(*a, **k)

    def pin(x):
        calls["pin"] += 1
        return plain_pin(x)

    monkeypatch.setattr(tfn, "layernorm_backward", bwd)
    monkeypatch.setattr(tpin, "pin_copy", pin)
    cfg = TConfig(**GPT2, dtype=torch.float32, attention_impl="flash",
                  remat=remat, fused_ln=True, pin_attn_layouts=True)
    from dlrover_tpu_torch.models.transformer import init_params

    model = TModel(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, seed=0, device="cpu"))
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, 96, size=(2, 32)))
    model(tokens).float().square().mean().backward()
    assert calls == {"norm": 2 * cfg.num_layers,
                     "pin": pins_per_layer * cfg.num_layers}


def test_chip_norm_check_catches_planted_faults():
    """The check ``chip_smoke.py`` holds K4 to, at a small bf16 shape on
    the CPU: it accepts the plain backward rounded to bf16 (what a sound
    kernel can at best give) and rejects dx without its mean(g) term and a
    dscale that lost one block's partial row."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    gen = torch.Generator().manual_seed(0)
    n, d = 512, 264
    x = (torch.randn((n, d), generator=gen) * 2.0 + 0.5).bfloat16()
    dy = (torch.randn((n, d), generator=gen) + 0.25).bfloat16()
    scale = torch.randn((d,), generator=gen) * 0.3 + 1.0
    _, mean, rstd = tfn.norm_forward(x, scale, None, EPS, True)
    ref = tfn.layernorm_backward_reference(x.float(), dy.float(), scale,
                                           mean, rstd)

    def errors(dx, dscale, dbias):
        return {"dx": cs.row_errors(dx, ref[0], cs.NORM_ROW_FLOOR),
                "dscale": cs._norm_rel(dscale, ref[1]),
                "dbias": cs._norm_rel(dbias, ref[2])}

    sound = (ref[0].bfloat16(), ref[1], ref[2])
    assert cs.norm_ok(errors(*sound))
    g = dy.float() * scale
    no_mean = (ref[0] + rstd[:, None] * g.mean(-1, keepdim=True)).bfloat16()
    assert not cs.norm_ok(errors(no_mean, ref[1], ref[2]))
    xhat = (x[:32].float() - mean[:32, None]) * rstd[:32, None]
    lost = ref[1] - (dy[:32].float() * xhat).sum(0)
    assert not cs.norm_ok(errors(sound[0], lost, ref[2]))

"""Port parity: the flash-attention backward on the CPU.

``mha_backward_reference`` (what a CPU tensor takes instead of the CUDA
backward kernels, and what ``chip_smoke.py`` holds those kernels against
on the card) against ``jax.vjp`` of the JAX ``mha``, whose Pallas
backward kernels run in interpret mode off a TPU: the fused one-pass
kernel (one kv block) and the split dq / dkv pair, causal and not, GQA,
and segment ids with fully masked rows.  fp32, atol 2e-5 as the forward
tests.  Also: autograd through the port's ``mha`` reaches the same
gradients, and its choice of backward kernel follows JAX's rule.
"""

import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import kernel_lib

TOL = dict(atol=2e-5, rtol=2e-5)
S, D = 64, 64


def _inputs(rng, b, hq, hkv, s=S):
    return tuple(
        rng.normal(size=shape).astype(np.float32)
        for shape in ((b, s, hq, D), (b, s, hkv, D), (b, s, hkv, D),
                      (b, s, hq, D))
    )


def _port_grads(q, k, v, do, causal, seg_q=None, seg_kv=None):
    t = [torch.as_tensor(x) for x in (q, k, v, do)]
    sq = None if seg_q is None else torch.as_tensor(seg_q)
    skv = None if seg_kv is None else torch.as_tensor(seg_kv)
    o, lse = tfa.mha_reference(*t[:3], causal=causal, seg_q=sq, seg_kv=skv)
    grads = tfa.mha_backward_reference(*t[:3], o, lse, t[3], causal=causal,
                                       seg_q=sq, seg_kv=skv)
    return [g.numpy() for g in grads]


@pytest.mark.parametrize(
    "b,hq,hkv,causal,block",
    [
        (1, 2, 2, True, 64),     # one kv block: the fused kernel
        (1, 2, 2, False, 64),
        (1, 2, 2, True, 16),     # four kv blocks: split dq / dkv
        (2, 4, 2, True, 16),     # GQA 4/2, split
        (1, 4, 2, False, 64),    # GQA 4/2, fused
    ],
)
def test_backward_reference_matches_jax_vjp(rng, b, hq, hkv, causal, block):
    q, k, v, do = _inputs(rng, b, hq, hkv)

    def f(q, k, v):
        return jfa.mha(q, k, v, causal=causal, block_q=block,
                       block_kv=block)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for got, w in zip(_port_grads(q, k, v, do, causal), want):
        np.testing.assert_allclose(got, np.asarray(w), **TOL)


def test_backward_reference_fully_masked_rows_match_jax_kernel(rng):
    """Separate q/kv segment ids leave the first 24 q rows with no kv of
    their segment: their dq is exactly 0 and they add nothing to dk/dv.
    Through the JAX custom_vjp core, which takes both id arrays."""
    b, hq, hkv = 1, 4, 2
    q, k, v, do = _inputs(rng, b, hq, hkv)
    seg_q = (np.arange(S) // 24).astype(np.int32)[None]
    seg_kv = seg_q.copy()
    seg_kv[:, :24] = 7
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731

    def f(q, k, v):
        return jfa._flash_core(q, k, v, jnp.asarray(seg_q)[:, None],
                               jnp.asarray(seg_kv)[:, None], True,
                               D ** -0.5, 16, 16)

    _, vjp = jax.vjp(f, t(q), t(k), t(v))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(t(do))]
    got = _port_grads(q, k, v, do, True, seg_q, seg_kv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert np.all(got[0][:, :24] == 0.0)
    assert np.all(np.isfinite(got[0])) and np.abs(got[0][:, 24:]).max() > 0


@pytest.mark.parametrize("seg", [False, True])
def test_autograd_through_mha_equals_backward_reference(rng, seg):
    """The custom op's registered backward on CPU tensors, with q/k/v as
    strided views of one fused projection (the model's layout)."""
    b, h = 2, 2
    qkv = torch.as_tensor(
        rng.normal(size=(b, S, h, 3 * D)).astype(np.float32)
    ).requires_grad_()
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    do = torch.as_tensor(rng.normal(size=(b, S, h, D)).astype(np.float32))
    ids = (torch.arange(S) // 20).repeat(b, 1).int() if seg else None
    o = tfa.mha(q, k, v, causal=True, segment_ids=ids)
    o.backward(do)
    ref_o, lse = tfa.mha_reference(q.detach(), k.detach(), v.detach(),
                                   seg_q=ids, seg_kv=ids)
    dq, dk, dv = tfa.mha_backward_reference(
        q.detach(), k.detach(), v.detach(), ref_o, lse, do, seg_q=ids,
        seg_kv=ids)
    torch.testing.assert_close(o.detach(), ref_o, atol=0, rtol=0)
    torch.testing.assert_close(qkv.grad, torch.cat([dq, dk, dv], -1),
                               atol=0, rtol=0)


def test_autograd_matches_plain_autograd_of_the_forward(rng):
    """mha_backward_reference is the gradient of mha_reference: torch's
    own autograd through the plain forward agrees."""
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(rng, 1, 4, 2))
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    o, _ = tfa.mha_reference(qs, ks, vs, causal=True)
    o.backward(do)
    o2, lse = tfa.mha_reference(q, k, v, causal=True)
    got = tfa.mha_backward_reference(q, k, v, o2, lse, do, causal=True)
    for g, w in zip(got, (qs.grad, ks.grad, vs.grad)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize(
    "skv,block_kv",
    [(64, 64), (64, 16), (100, 512), (600, 512), (600, 700), (1024, 1024),
     (1024, 512), (10, 16)],
)
def test_fused_or_split_follows_the_jax_rule(monkeypatch, skv, block_kv):
    """JAX picks its backward inside ``_flash_core_bwd``; tracing
    ``jax.grad`` of its ``mha`` with spies in place of the two backward
    implementations shows which it took (nothing is compiled)."""
    took = []

    def spy(kind):
        def impl(q, k, v, seg_q, seg_kv, o, lse, do, **kw):
            took.append(kind)
            return jnp.zeros_like(q), jnp.zeros_like(k), jnp.zeros_like(v)
        return impl

    monkeypatch.setattr(jfa, "_flash_bwd_fused", spy("fused"))
    monkeypatch.setattr(jfa, "_flash_bwd", spy("split"))
    x = jnp.zeros((1, skv, 1, D), jnp.float32)
    jax.make_jaxpr(jax.grad(lambda q: jfa.mha(
        q, x, x, block_q=block_kv, block_kv=block_kv).sum()))(x)
    assert took == ["fused" if tfa.uses_fused_backward(skv, block_kv)
                    else "split"]


def test_no_grad_calls_save_nothing(rng, monkeypatch):
    """Without a gradient to compute (serving), mha calls the forward
    alone: no op dispatch, nothing saved."""
    q = torch.as_tensor(rng.normal(size=(1, 32, 2, D)).astype(np.float32))
    q.requires_grad_()
    with_op = tfa.mha(q, q, q)
    assert with_op.grad_fn is not None

    def no_op(*args):
        raise AssertionError("the op ran without a gradient to compute")

    monkeypatch.setattr(tfa, "flash_fwd_op", no_op)
    with torch.no_grad():
        o = tfa.mha(q, q, q)
    assert o.grad_fn is None and not o.requires_grad
    torch.testing.assert_close(o, with_op.detach(), atol=0, rtol=0)
    assert tfa.mha(q.detach(), q.detach(), q.detach()).grad_fn is None


def test_cuda_backward_wrappers_refuse_cpu_tensors(rng):
    """The kernel wrappers never fall back to the plain version."""
    q = torch.zeros((1, 16, 2, D), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 16))
    for fn in (tfa.flash_bwd_fused, tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="no kernel"):
            fn(q, q, q, q, lse, q)


def test_kernel_library_name_hashes_the_shared_header(monkeypatch,
                                                      tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_lib.CSRC, csrc)
    monkeypatch.setattr(kernel_lib, "CSRC", str(csrc))
    assert "flash_attention_bwd" in kernel_lib.sources()
    before = {n: kernel_lib._target(n)[1] for n in kernel_lib.sources()}
    with open(os.path.join(csrc, "flash_common.cuh"), "a") as f:
        f.write("\n// changed\n")
    after = {n: kernel_lib._target(n)[1] for n in kernel_lib.sources()}
    for name in ("flash_attention", "flash_attention_bwd"):
        assert before[name] != after[name]


@pytest.mark.parametrize("hq,hkv,seg", [(2, 2, False), (4, 2, True)])
def test_split_backward_references_equal_the_whole(hq, hkv, seg):
    """The plain versions of the dq and dkv kernels are the pieces of
    ``mha_backward_reference``."""
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(rng, 2, hq, hkv))
    ids = (torch.arange(S) // 20).repeat(2, 1).int() if seg else None
    kw = dict(causal=True, seg_q=ids, seg_kv=ids)
    o, lse = tfa.mha_reference(q, k, v, **kw)
    dq, dk, dv = tfa.mha_backward_reference(q, k, v, o, lse, do, **kw)
    torch.testing.assert_close(
        tfa.mha_backward_dq_reference(q, k, v, o, lse, do, **kw), dq,
        atol=0, rtol=0)
    for got, want in zip(
            tfa.mha_backward_dkv_reference(q, k, v, o, lse, do, **kw),
            (dk, dv)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_chip_backward_check_catches_planted_faults(hq, hkv):
    """``chip_smoke.py``'s backward check, at a small causal bf16 shape:
    it accepts the plain backward rounded to bf16 (what a sound kernel
    can at best give) and rejects the planted faults, the diagonal tiles
    of the second half of the sequence, or of the last tile alone, dropped
    or halved in dq, dk or dv."""
    cs = _chip_smoke()
    s = 256
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((1, s, h, D), generator=gen).bfloat16()
                   for h in (hq, hkv, hkv, hq))
    o, lse = tfa.mha_reference(q, k, v)
    ref = tfa.mha_backward_reference(q.float(), k.float(), v.float(),
                                     o.float(), lse, do.float())
    sound = [r.bfloat16() for r in ref]
    dead = [torch.zeros((1, s), dtype=torch.bool)] * 3
    for g, r, dd in zip(sound, ref, dead):
        assert cs.bwd_ok(cs.bwd_errors(g, r, dd))
    tiles = s // tfa.MASK_TILE
    lost = {region: cs.diagonal_tiles(q, k, v, o, lse, do, causal=True,
                                      first_tile=first)
            for region, first in (("late_half", tiles // 2),
                                  ("last_tile", tiles - 1))}
    faults = cs.planted_faults(sound, ref, dead, lost)
    assert len(faults) == 12
    assert all(f["caught"] for f in faults.values()), faults

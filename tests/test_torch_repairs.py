"""Port parity: the two faults found in the port against the reference
(``ROADMAP.md`` Queue 3, items 1 and 2), pinned on the CPU.

1. ``chunked_cross_entropy_loss`` with a bf16 head: the logits are bf16
   products accumulated and returned in fp32, as the JAX einsum's
   ``preferred_element_type=float32`` (they were rounded to bf16, 3.8e-3
   off on this input).
2. ``Attention``'s own flash block defaults are the reference's 512, so an
   ``Attention`` built directly at S 1024 takes the split backward, as the
   JAX module does (it took the fused one).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import attention as jattn
from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.models import attention as tattn
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.trainer import train_lib as ttl


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chunked_cross_entropy_matches_jax_with_a_bf16_head(dtype):
    """The Queue 3 input: hidden [2, 64, 128] and a head [4096, 128] drawn
    N(0, 0.25), in ``dtype``, 4 chunks, numpy seed 0; within 1e-5."""
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(2, 64, 128)).astype(np.float32)
    head = rng.normal(scale=0.25, size=(4096, 128)).astype(np.float32)
    targets = rng.integers(0, 4096, size=(2, 64)).astype(np.int32)
    jh = jnp.asarray(hidden).astype(getattr(jnp, dtype))
    jw = jnp.asarray(head).astype(getattr(jnp, dtype))
    want, _ = jtl.chunked_cross_entropy_loss(jh, jw, jnp.asarray(targets),
                                             num_chunks=4)
    # The same rounded values on both sides.
    th, tw = (torch.tensor(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in (jh, jw))
    got, _ = ttl.chunked_cross_entropy_loss(th, tw, torch.as_tensor(targets),
                                            num_chunks=4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)


def test_attention_flash_blocks_default_to_the_references():
    fields = {f.name: f.default for f in dataclasses.fields(jattn.Attention)}
    params = inspect.signature(tattn.Attention.__init__).parameters
    for name in ("flash_block_q", "flash_block_kv"):
        assert params[name].default == fields[name] == 512


def test_attention_built_directly_at_s1024_takes_the_split_backward(
        monkeypatch):
    """Both modules at their own defaults, S 1024, one head of 64: JAX's
    backward (traced with spies in place of its two implementations) and
    the port's (a spy on ``flash_bwd``'s ``fused``) are the split one."""
    s, heads, hd = 1024, 1, 64
    took = []

    def spy(kind):
        def impl(q, k, v, seg_q, seg_kv, o, lse, do, **kw):
            took.append(kind)
            return jnp.zeros_like(q), jnp.zeros_like(k), jnp.zeros_like(v)
        return impl

    monkeypatch.setattr(jfa, "_flash_bwd_fused", spy("fused"))
    monkeypatch.setattr(jfa, "_flash_bwd", spy("split"))
    module = jattn.Attention(num_heads=heads, num_kv_heads=heads,
                             head_dim=hd, attention_impl="flash",
                             dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((1, s, heads * hd), jnp.float32)
    params = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    jax.make_jaxpr(jax.grad(
        lambda p, x: module.apply(p, x).sum()))(params, x)
    assert took == ["split"]

    chose = []
    real = tfa.flash_bwd

    def bwd_spy(*args, fused=True, **kw):
        chose.append(fused)
        return real(*args, fused=fused, **kw)

    monkeypatch.setattr(tfa, "flash_bwd", bwd_spy)
    attn = tattn.Attention(heads * hd, heads, heads, hd,
                           attention_impl="flash", dtype=torch.float32,
                           device="cpu")
    x = torch.zeros((1, s, heads * hd), requires_grad=True)
    attn(x, torch.arange(s)[None]).sum().backward()
    assert chose == [False]

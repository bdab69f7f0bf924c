"""Port parity: ``dlrover_tpu_torch.models.layers`` against the JAX modules.

Same numpy inputs and the same (JAX-initialised) parameters through both
packages, in fp32; atol 1e-6 (one fp32 rounding order apart).  Each test
draws from its own seeded generator, so its inputs do not depend on which
tests ran before it in the same process.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import layers as jl
from dlrover_tpu_torch.models import layers as tl

ATOL = 1e-6


def _init(module, *args):
    variables = module.init(jax.random.PRNGKey(0), *args)
    return jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))


def _load(module, params):
    module.load_state_dict(
        {k: torch.as_tensor(np.array(v)) for k, v in params.items()}
    )
    return module


@pytest.mark.parametrize(
    "in_shape,features,axis,kernel_axes",
    [
        ((16,), (24,), -1, ("embed", "mlp")),
        ((16,), (4, 12), -1, ("embed", "heads", "kv")),
        ((4, 8), (16,), (-2, -1), ("heads", "kv", "embed")),
    ],
)
def test_dense_general_matches_jax(in_shape, features, axis, kernel_axes):
    rng = np.random.default_rng(101)
    x = rng.normal(size=(2, 5) + in_shape).astype(np.float32)
    jmod = jl.DenseGeneral(
        features, axis=axis, kernel_axes=kernel_axes, use_bias=True,
        dtype=jnp.float32,
    )
    params = _init(jmod, jnp.asarray(x))
    params["bias"] = rng.normal(size=params["bias"].shape).astype(
        np.float32
    )
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = _load(tl.DenseGeneral(in_shape, features, use_bias=True,
                                 dtype=torch.float32, device="cpu"), params)
    got = tmod(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_embed_lookup_and_attend_match_jax():
    rng = np.random.default_rng(102)
    ids = rng.integers(0, 50, size=(3, 7))
    h = rng.normal(size=(3, 7, 16)).astype(np.float32)
    jmod = jl.Embed(num_embeddings=50, features=16, dtype=jnp.float32)
    params = _init(jmod, jnp.asarray(ids))
    tmod = _load(tl.Embed(50, 16, dtype=torch.float32, device="cpu"), params)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
    np.testing.assert_allclose(
        tmod(torch.as_tensor(ids)).detach().numpy(), want, atol=ATOL, rtol=0
    )
    want_logits = np.asarray(jmod.apply(
        {"params": params}, jnp.asarray(h), method=jl.Embed.attend
    ))
    np.testing.assert_allclose(
        tmod.attend(torch.as_tensor(h)).detach().numpy(), want_logits,
        atol=ATOL, rtol=0,
    )


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(103)
    x = (3.0 + 2.0 * rng.normal(size=(4, 6, 32))).astype(np.float32)
    jmod = jl.make_norm(kind, jnp.float32, jnp.float32, "norm")
    params = _init(jmod, jnp.asarray(x))
    params = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = _load(tl.make_norm(kind, 32, "cpu"), params)
    got = tmod(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_norm_keeps_input_dtype_with_fp32_stats():
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    for kind in ("layernorm", "rmsnorm"):
        norm = tl.make_norm(kind, 8, "cpu")
        assert norm.scale.dtype == torch.float32
        assert norm(x.to(torch.bfloat16)).dtype == torch.bfloat16


def test_rotary_embedding_matches_jax():
    rng = np.random.default_rng(104)
    q = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 9))
    jq, jk = jl.rotary_embedding(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 10000.0
    )
    tq, tk = tl.rotary_embedding(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(pos),
        10000.0,
    )
    # Angles up to ~500 rad: the two libraries' fp32 sin/cos differ by a
    # few ulps of the angle, so the tolerance is relative to |x| ~ 4.
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5, rtol=0)


def test_rotary_embedding_small_positions_tight():
    rng = np.random.default_rng(105)
    q = rng.normal(size=(1, 6, 2, 8)).astype(np.float32)
    pos = np.arange(6)[None]
    jq, _ = jl.rotary_embedding(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(pos)
    )
    tq, _ = tl.rotary_embedding(
        torch.as_tensor(q), torch.as_tensor(q), torch.as_tensor(pos)
    )
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL, rtol=0)

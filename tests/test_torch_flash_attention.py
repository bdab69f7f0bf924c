"""Port parity: ``dlrover_tpu_torch.ops.flash_attention`` on the CPU.

On CPU tensors the port's ``mha``/``flash_fwd`` take ``mha_reference``; it
is held against the JAX ``mha``, which off a TPU runs the Pallas kernel in
interpret mode (``dlrover_tpu/ops/flash_attention.py:40-41``).  fp32,
atol 2e-5 as in ``tests/test_flash_attention.py``.  The CUDA kernel itself
is held against ``mha_reference`` on the card by ``chip_smoke.py``.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import kernel_lib

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(rng, b, s, hq, hkv, d):
    return (
        rng.normal(size=(b, s, hq, d)).astype(np.float32),
        rng.normal(size=(b, s, hkv, d)).astype(np.float32),
        rng.normal(size=(b, s, hkv, d)).astype(np.float32),
    )


def _both(q, k, v, **kw):
    want = np.asarray(jfa.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=128, block_kv=128,
        **{key: (jnp.asarray(val) if key == "segment_ids" else val)
           for key, val in kw.items()},
    ))
    got = tfa.mha(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        **{key: (torch.as_tensor(val) if key == "segment_ids" else val)
           for key, val in kw.items()},
    ).numpy()
    return got, want


@pytest.mark.parametrize(
    "b,s,hq,hkv,causal",
    [
        (2, 256, 4, 4, True),
        (2, 256, 4, 4, False),
        (1, 256, 8, 2, True),     # GQA 8/2
        (1, 100, 4, 4, True),     # not a block multiple: JAX pads
        (1, 100, 8, 2, False),
    ],
)
def test_mha_reference_matches_jax_mha(rng, b, s, hq, hkv, causal):
    q, k, v = _qkv(rng, b, s, hq, hkv, 64)
    got, want = _both(q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_segment_ids(rng, causal):
    b, s = 2, 256
    q, k, v = _qkv(rng, b, s, 2, 2, 64)
    seg = (rng.integers(0, 3, size=(b, s)).cumsum(axis=1) // 40).astype(
        np.int32
    )
    got, want = _both(q, k, v, causal=causal, segment_ids=seg)
    np.testing.assert_allclose(got, want, **TOL)


def test_lse_and_fully_masked_rows_match_jax_kernel(rng):
    """Separate q/kv segment ids leave the first 40 q rows with no kv of
    their segment: o = 0 and lse = -1e30 there, in both packages."""
    b, s, hq, hkv, d = 1, 128, 4, 2, 64
    q, k, v = _qkv(rng, b, s, hq, hkv, d)
    seg_q = (np.arange(s) // 40).astype(np.int32)[None]
    seg_kv = seg_q.copy()
    seg_kv[:, :40] = 7
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    jo, jlse = jfa._flash_fwd(
        t(q), t(k), t(v), jnp.asarray(seg_q)[:, None],
        jnp.asarray(seg_kv)[:, None],
        causal=True, scale=d ** -0.5, block_q=64, block_kv=64,
    )
    jo = np.asarray(jo).transpose(0, 2, 1, 3)
    o, lse = tfa.flash_fwd(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        causal=True, seg_q=torch.as_tensor(seg_q),
        seg_kv=torch.as_tensor(seg_kv),
    )
    np.testing.assert_allclose(o.numpy(), jo, **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    assert np.all(o.numpy()[:, :40] == 0.0)
    assert np.all(lse.numpy()[:, :, :40] == -1e30)
    assert np.all(np.isfinite(lse.numpy()[:, :, 40:]))


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    q, k, v = (torch.as_tensor(x) for x in _qkv(rng, 1, 20, 2, 2, 64))
    before = dict(tfa.LAUNCHES)
    o = tfa.mha(q, k, v, causal=True, block_q=16, block_kv=16)
    ref, _ = tfa.mha_reference(q, k, v, causal=True)
    torch.testing.assert_close(o, ref, atol=0, rtol=0)
    assert tfa.LAUNCHES == before


def test_bf16_cpu_output_keeps_dtype(rng):
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16)
               for x in _qkv(rng, 1, 20, 2, 2, 64))
    o, lse = tfa.flash_fwd(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (1, 2, 20)


def test_device_without_kernel_raises(rng):
    q = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.mha(q, q, q)
    with pytest.raises(ValueError, match="together"):
        tfa.flash_fwd(q, q, q, seg_q=torch.zeros((1, 16)))


def _isolated_build(monkeypatch, tmp_path, nvcc_body=None):
    """Point the loader at an empty build dir and a PATH holding only a
    fake ``nvcc`` (or none)."""
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(kernel_lib, "_LIBS", {})
    bindir = tmp_path / "bin"
    bindir.mkdir()
    if nvcc_body is not None:
        nvcc = bindir / "nvcc"
        nvcc.write_text(nvcc_body)
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    _isolated_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_lib.load("flash_attention")


def test_failed_compile_raises_with_compiler_output(monkeypatch, tmp_path):
    _isolated_build(
        monkeypatch, tmp_path,
        "#!/bin/sh\necho 'error: fake compiler refused' >&2\nexit 2\n",
    )
    with pytest.raises(RuntimeError, match="fake compiler refused"):
        kernel_lib.build_all()
    built = [f for f in os.listdir(tmp_path / "kernels") if f.endswith(".so")]
    assert built == []


def test_kernel_sources_ship_with_the_package():
    assert "flash_attention" in kernel_lib.sources()
    src, out = kernel_lib._target("flash_attention")
    assert os.path.exists(src)
    assert out.startswith(kernel_lib.BUILD_DIR) and out.endswith(".so")


# -- head dims the kernels have no build for (zero-padded) ------------------


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("causal,hq,hkv", [(True, 4, 4), (False, 4, 2)])
def test_padded_head_dim_equals_unpadded_and_jax(d, causal, hq, hkv):
    """``mha_padded`` (what ``mha`` runs on the card for D 80 and 96: q, k
    and v zero-padded to 128, the true scale, the output sliced back)
    through the plain versions equals the unpadded plain result and the
    JAX ``mha`` in interpret mode, which takes any head dim as a full
    block."""
    rng = np.random.default_rng(1000 + d + hkv)
    q, k, v = _qkv(rng, 1, 96, hq, hkv, d)
    assert tfa.padded_head_dim(d) == 128
    before = tfa.PAD_COPIES["flash_pad"]
    t = [torch.as_tensor(x) for x in (q, k, v)]
    got = tfa.mha_padded(*t, causal=causal)
    assert tfa.PAD_COPIES["flash_pad"] == before + 3
    assert tuple(got.shape) == q.shape
    plain, _ = tfa.mha_reference(*t, causal=causal)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                               rtol=1e-6)
    _, want = _both(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_padded_head_dim_table_and_refusals():
    assert [tfa.padded_head_dim(d) for d in (8, 64, 65, 80, 96, 128)] == [
        64, 64, 128, 128, 128, 128]
    with pytest.raises(ValueError, match="Queue 3 item 7"):
        tfa.padded_head_dim(160)


@pytest.mark.parametrize("overrides,match", [
    (dict(d_model=320, num_heads=2), "head dims up to 128"),
    (dict(dtype=torch.float32), "bf16 only"),
])
def test_config_refuses_flash_without_a_kernel_on_cuda(overrides, match):
    """A flash config with a head dim above 128, or a compute dtype other
    than bf16, is refused for ``cuda`` when the model is built (naming
    ROADMAP Queue 3 item 7) and nothing is cast; the CPU takes it, and a
    head dim of 80 is taken on either."""
    from dlrover_tpu_torch.models.transformer import TransformerConfig

    base = dict(vocab_size=64, num_layers=1, d_model=128, num_heads=2,
                max_seq_len=32, attention_impl="flash")
    cfg = TransformerConfig(**{**base, **overrides})
    with pytest.raises(NotImplementedError, match=match) as err:
        cfg.check_device(torch.device("cuda"))
    assert "Queue 3 item 7" in str(err.value)
    cfg.check_device(torch.device("cpu"))
    TransformerConfig(**{**base, "attention_impl": "xla", **overrides}
                      ).check_device(torch.device("cuda"))
    TransformerConfig(**{**base, "d_model": 160}).check_device(
        torch.device("cuda"))

"""Port parity: ``dlrover_tpu_torch.serving`` against the JAX serving plane.

The JAX ``ServingEngine`` and the port's (``device="cpu"``) serve the same
greedy requests on the same 2-layer flash-attention config in fp32, with
the JAX parameters loaded into the port: the token streams must be equal
and the logprobs within 1e-5.  On the CPU the port's prefill takes the
flash kernel's plain version; the JAX prefill runs the Pallas kernel in
interpret mode.  Buckets (16, 32) put every prefill on the flash path, and
more requests than slots recycle slots.  A GPT-2-style and a Llama-style
(RoPE, GQA cache) config are both held to the JAX engine.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models.transformer import TransformerConfig as JConfig
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.rl.generation import SamplingParams as JSampling
from dlrover_tpu.serving import Request as JRequest
from dlrover_tpu.serving import ServingEngine as JEngine
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import TransformerConfig
from dlrover_tpu_torch.models.transformer import TransformerLM
from dlrover_tpu_torch.rl.generation import SamplingParams
from dlrover_tpu_torch.serving import (
    Request,
    ServePrograms,
    ServingEngine,
    make_buckets,
    pad_to_bucket,
    pick_bucket,
    sample_tokens,
)

VOCAB, SEQ = 64, 64
MODEL = dict(vocab_size=VOCAB, d_model=64, num_heads=4, num_layers=2,
             d_ff=128, max_seq_len=SEQ, attention_impl="flash")
BUCKETS = (16, 32)
GREEDY = [(5, 6), (20, 4), (12, 8), (30, 3), (17, 5)]  # (prompt, new)


# Llama-style: RoPE at each slot's own decode position, RMSNorm, SwiGLU,
# a GQA 4/2 cache and separate q/k/v projections.
LLAMA = dict(MODEL, num_kv_heads=2, position="rope", norm="rmsnorm",
             activation="swiglu", use_bias=False, tie_embeddings=False)


def _configs(kw):
    jcfg = JConfig(**kw, dtype=jnp.float32)
    tcfg = TransformerConfig(**kw, dtype=torch.float32)
    params = nn.meta.unbox(JModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)
    )["params"])
    state = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, state


@pytest.fixture(scope="module")
def setup():
    return _configs(MODEL)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, VOCAB, size=n)


def _engine(tcfg, state, **kw):
    kw.setdefault("buckets", BUCKETS)
    return ServingEngine(tcfg, state, device="cpu", **kw)


def _full_logits(tcfg, state, tokens):
    """Next-token logits of a no-cache forward over ``tokens``."""
    model = TransformerLM(dataclasses.replace(tcfg, decode=False), "cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        return model(torch.as_tensor(np.asarray(tokens)[None]))[0, -1]


@pytest.mark.parametrize("family,requests", [
    ("gpt2", GREEDY),
    ("llama", GREEDY[:3]),
])
def test_greedy_streams_equal_the_jax_engine(setup, family, requests):
    jcfg, params, tcfg, state = setup if family == "gpt2" else _configs(
        LLAMA)
    jax_engine = JEngine(jcfg, params, slots=2, buckets=BUCKETS, seed=0)
    want = jax_engine.run([
        JRequest(f"r{i}", _prompt(i, n),
                 JSampling(temperature=0.0, max_new_tokens=m))
        for i, (n, m) in enumerate(requests)
    ])
    got = _engine(tcfg, state, slots=2).run([
        Request(f"r{i}", _prompt(i, n),
                SamplingParams(temperature=0.0, max_new_tokens=m))
        for i, (n, m) in enumerate(requests)
    ])
    for i, (_, m) in enumerate(requests):
        r, w = got[f"r{i}"], want[f"r{i}"]
        assert len(r.tokens) == m
        np.testing.assert_array_equal(r.tokens, w.tokens)
        np.testing.assert_allclose(r.logprobs, w.logprobs, atol=1e-5,
                                   rtol=0)


def test_sampled_rows_stay_in_top_k_with_raw_logprobs(setup):
    _, _, tcfg, state = setup
    k = 5
    requests = [
        Request("s0", _prompt(50, 9),
                SamplingParams(temperature=0.8, top_k=k, max_new_tokens=6)),
        Request("s1", _prompt(51, 21),
                SamplingParams(temperature=1.3, top_k=k, max_new_tokens=6)),
        Request("g", _prompt(52, 14),
                SamplingParams(temperature=0.0, max_new_tokens=6)),
    ]
    results = _engine(tcfg, state, slots=2, seed=3).run(requests)
    for req in requests:
        res = results[req.uid]
        prefix = list(req.prompt)
        for tok, logp in zip(res.tokens, res.logprobs):
            logits = _full_logits(tcfg, state, prefix)
            if req.sampling.temperature > 0:
                assert tok in torch.topk(logits, k).indices.tolist()
            else:
                assert tok == int(logits.argmax())
            want = torch.log_softmax(logits, dim=-1)[tok].item()
            assert abs(logp - want) < 1e-4
            prefix.append(tok)


def test_recycled_slot_does_not_leak_stale_kv(setup):
    _, _, tcfg, state = setup
    greedy = SamplingParams(temperature=0.0, max_new_tokens=8)
    recycled = _engine(tcfg, state, slots=1)
    recycled.run([Request("a", _prompt(21, 30), greedy)])
    got = recycled.run([Request("b", _prompt(22, 5), greedy)])["b"]
    want = _engine(tcfg, state, slots=1).run(
        [Request("b", _prompt(22, 5), greedy)]
    )["b"]
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.logprobs, want.logprobs)


def test_prefill_and_decode_step_match_a_full_forward(setup):
    _, _, tcfg, state = setup
    programs = ServePrograms(tcfg, slots=2, buckets=BUCKETS, device="cpu")
    model = programs.place_params(state)
    pool = programs.init_cache()
    prompt = _prompt(60, 11)
    padded, n = pad_to_bucket(prompt, BUCKETS)
    gen = torch.Generator().manual_seed(0)
    zero_t = torch.zeros(1)
    zero_k = torch.zeros(1, dtype=torch.long)
    row, first, _ = programs.prefill(
        model, torch.as_tensor(padded[None]), n, gen, zero_t, zero_k
    )
    assert int(first) == int(_full_logits(tcfg, state, prompt).argmax())
    programs.insert(pool, row, 1)
    assert torch.equal(pool[0][:, 1], row[0][:, 0])
    assert not pool[0][:, 0].any()
    tokens = torch.tensor([0, int(first)])
    positions = torch.tensor([0, n])
    logits = programs.decode_logits(model, pool, tokens, positions)[1]
    want = _full_logits(tcfg, state, list(prompt) + [int(first)])
    torch.testing.assert_close(logits, want, atol=1e-5, rtol=0)


def test_continuous_admission_beats_static_barrier(setup):
    _, _, tcfg, state = setup
    lengths = (3, 12, 5, 10)

    def run(static):
        engine = _engine(tcfg, state, slots=2, buckets=(16,),
                         static_batching=static)
        results = engine.run([
            Request(f"r{i}", _prompt(30 + i, 4 + i % 3),
                    SamplingParams(temperature=0.0, max_new_tokens=m))
            for i, m in enumerate(lengths)
        ])
        for i, m in enumerate(lengths):
            assert len(results[f"r{i}"].tokens) == m
        return results, engine.stats()

    cont_results, cont = run(static=False)
    static_results, static = run(static=True)
    assert cont["steps"] < static["steps"]
    assert cont["occupancy"] > static["occupancy"]
    for i in range(len(lengths)):
        np.testing.assert_array_equal(
            cont_results[f"r{i}"].tokens, static_results[f"r{i}"].tokens
        )


def test_eos_terminates_early(setup):
    _, _, tcfg, state = setup
    full = _engine(tcfg, state, slots=1).run([
        Request("f", _prompt(70, 6),
                SamplingParams(temperature=0.0, max_new_tokens=6))
    ])["f"]
    eos = int(full.tokens[2])
    stop = int(np.argmax(full.tokens == eos))
    cut = _engine(tcfg, state, slots=1).run([
        Request("c", _prompt(70, 6),
                SamplingParams(temperature=0.0, max_new_tokens=6),
                eos_id=eos)
    ])["c"]
    np.testing.assert_array_equal(cut.tokens, full.tokens[: stop + 1])


def test_submit_rejects_never_admissible_requests(setup):
    _, _, tcfg, state = setup
    engine = _engine(tcfg, state, slots=1, max_top_k=8)
    bad = [
        Request("empty", np.zeros((0,), np.int64)),
        Request("long", _prompt(1, 40)),
        Request("zero", _prompt(1, 4), SamplingParams(max_new_tokens=0)),
        Request("room", _prompt(1, 20), SamplingParams(max_new_tokens=40)),
        Request("topk", _prompt(1, 4), SamplingParams(top_k=9)),
        Request("vocab", np.array([1, VOCAB])),
    ]
    for req in bad:
        with pytest.raises(ValueError):
            engine.submit(req)
    with pytest.raises(ValueError, match="decode room"):
        _engine(tcfg, state, buckets=(16, SEQ))


def test_stats_report_the_run(setup):
    _, _, tcfg, state = setup
    engine = _engine(tcfg, state, slots=2)
    engine.run([
        Request(f"r{i}", _prompt(80 + i, 6),
                SamplingParams(temperature=0.0, max_new_tokens=4))
        for i in range(3)
    ])
    stats = engine.stats()
    assert stats["requests"] == 3.0 and stats["tokens"] == 12.0
    assert stats["prefills"] == 3.0 and stats["slots"] == 2.0
    assert 0.0 < stats["occupancy"] <= 1.0
    assert stats["decode_step_n"] >= 3.0
    assert 0.0 < stats["decode_step_p50_s"] <= stats["decode_step_p95_s"]
    assert engine.warmup() == 0.0  # no kernel to build on the CPU


def test_engine_without_device_needs_a_card(setup, monkeypatch):
    _, _, tcfg, state = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tcfg, state, buckets=BUCKETS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServePrograms(tcfg, slots=1, buckets=BUCKETS)


def test_sample_tokens_greedy_top_k_and_raw_logprobs():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(4, VOCAB, generator=gen)
    temps = torch.tensor([0.0, 0.0, 1.0, 0.5])
    topks = torch.tensor([0, 0, 0, 4])
    tokens, logps = sample_tokens(logits, gen, temps, topks, max_top_k=8)
    assert tokens[:2].tolist() == logits[:2].argmax(-1).tolist()
    assert int(tokens[3]) in torch.topk(logits[3], 4).indices.tolist()
    want = torch.log_softmax(logits, -1)[torch.arange(4), tokens]
    torch.testing.assert_close(logps, want, atol=0, rtol=0)


def test_sample_tokens_top_k_draws_only_from_the_top_k():
    gen = torch.Generator().manual_seed(1)
    logits = torch.randn(1, VOCAB, generator=gen).expand(4000, VOCAB)
    tokens, _ = sample_tokens(
        logits, gen, torch.full((4000,), 2.0),
        torch.full((4000,), 6), max_top_k=16,
    )
    allowed = set(torch.topk(logits[0], 6).indices.tolist())
    drawn = set(tokens.tolist())
    assert drawn <= allowed and len(drawn) == 6


# -- bucketing (mirrors tests/test_serving.py) --------------------------------


def test_make_buckets_geometric_and_clamped():
    assert make_buckets(100, start=16) == (16, 32, 64, 100)
    assert make_buckets(16, start=16) == (16,)
    assert make_buckets(8, start=16) == (8,)
    with pytest.raises(ValueError):
        make_buckets(0)
    with pytest.raises(ValueError):
        make_buckets(10, factor=1)


def test_pick_bucket_smallest_admitting():
    assert pick_bucket(5, (8, 16)) == 8
    assert pick_bucket(8, (8, 16)) == 8
    assert pick_bucket(9, (16, 8)) == 16
    with pytest.raises(ValueError, match="exceeds"):
        pick_bucket(17, (8, 16))
    with pytest.raises(ValueError):
        pick_bucket(0, (8,))


def test_pad_to_bucket_right_pads_and_reports_true_len():
    padded, true_len = pad_to_bucket(np.arange(1, 6), (8, 16), pad_id=0)
    assert true_len == 5
    np.testing.assert_array_equal(padded, [1, 2, 3, 4, 5, 0, 0, 0])
    exact, n = pad_to_bucket(np.arange(8), (8,))
    assert n == 8 and exact.shape == (8,)
    two_d, n = pad_to_bucket(np.ones((3, 5), np.int32), (8,))
    assert n == 5 and two_d.shape == (3, 8)

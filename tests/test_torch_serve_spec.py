"""Port parity: speculative decoding (``serving/decode.SpecPrograms``, the
engine's draft plane and ``serving/draft.make_draft``) against the JAX
serving plane.

The model is ``tests/test_torch_serving.py``'s 2-layer flash config in
fp32, with the JAX parameters carried into the port.  Both packages damp
the target with their own ``make_draft(draft_layers=1, damp=0.05)``: the
port's draft and damped target must equal the carried JAX ones leaf for
leaf, bit for bit.  The JAX speculating engine and the port's (``device=
"cpu"``, γ = 4) then serve the same greedy requests: the token streams
and the accepted and proposed counts must be equal and the logprobs
within 1e-5 (fp32 rounding of two implementations).  On the CPU in fp32
the verify chunk's argmax is the plain step's, so the port's speculating
stream must also equal its plain stream, for a random draft too.  Every
test seeds its own generators.
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
from dlrover_tpu_torch.models import init_params
from dlrover_tpu_torch.models.attention import FLASH_PREFILL_MIN
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import TransformerConfig
from dlrover_tpu_torch.rl.generation import SamplingParams
from dlrover_tpu_torch.serving import (
    MAX_SPEC_TOKENS,
    ReplicaFleet,
    Request,
    ServingEngine,
    SpecPrograms,
    clear_programs,
    get_programs,
    get_spec_programs,
    make_draft,
)
from dlrover_tpu_torch.serving import decode

VOCAB, SEQ = 64, 64
MODEL = dict(vocab_size=VOCAB, d_model=64, num_heads=4, num_layers=2,
             d_ff=128, max_seq_len=SEQ, attention_impl="flash")
BUCKETS = (16, 32)
GAMMA = 4
LOGP_ATOL = 1e-5
# (prompt length, max_new_tokens); more requests than slots.
GREEDY = [(5, 12), (20, 10), (12, 14), (30, 8), (17, 9)]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, VOCAB, size=n)


def _jax_tree(state, layers):
    """A port state dict as the JAX package's nested, layer-stacked
    parameter tree (numpy leaves)."""
    tree = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            if parts[1] != "0":
                continue
            parts = ["blocks"] + parts[2:]
            rest = ".".join(parts[1:])
            value = np.stack([state[f"blocks.{i}.{rest}"].numpy()
                              for i in range(layers)])
        else:
            value = t.numpy()
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = value
    return tree


def _jax_tools_make_draft():
    from tools.serve_bench import make_draft as jax_make_draft

    return jax_make_draft


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(**MODEL, dtype=jnp.float32)
    tcfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = nn.meta.unbox(JModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    jdraft_cfg, jdraft, jdamped = _jax_tools_make_draft()(
        jcfg, params, draft_layers=1, damp=0.05)
    state = state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg)
    draft_cfg, draft, damped = make_draft(tcfg, state, draft_layers=1,
                                          damp=0.05)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, state=state,
                jdraft_cfg=jdraft_cfg, jdraft=jdraft, jdamped=jdamped,
                draft_cfg=draft_cfg, draft=draft, damped=damped)


def _greedy(requests, cls=Request, sampling=SamplingParams):
    return [cls(f"r{i}", _prompt(i, n),
                sampling(temperature=0.0, max_new_tokens=m))
            for i, (n, m) in enumerate(requests)]


def _engine(cfg, state, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("slots", 2)
    return ServingEngine(cfg, state, device="cpu", **kw)


def _tokens(results):
    return {u: r.tokens.tolist() for u, r in results.items()}


@pytest.mark.parametrize("family", ["gpt2", "moe"])
def test_make_draft_equals_the_carried_jax_draft(setup, family):
    """The port's ``make_draft`` on carried weights equals the carried
    weights of the JAX ``make_draft``, leaf for leaf and bit for bit; an
    MoE target damps its experts' ``wo`` too."""
    if family == "gpt2":
        jcfg, tcfg, params = setup["jcfg"], setup["tcfg"], setup["params"]
        state = setup["state"]
    else:
        # Random MoE weights from the port's init, stacked into the JAX
        # tree by hand (no JAX init to compile).
        kw = dict(MODEL, num_layers=3, num_experts=4, top_k=2)
        jcfg = JConfig(**kw, dtype=jnp.float32)
        tcfg = TransformerConfig(**kw, dtype=torch.float32)
        state = init_params(tcfg, seed=1, device="cpu")
        params = _jax_tree(state, tcfg.num_layers)
    layers = 2 if family == "moe" else 1
    jdraft_cfg, jdraft, jdamped = _jax_tools_make_draft()(
        jcfg, params, draft_layers=layers, damp=0.05)
    draft_cfg, draft, damped = make_draft(tcfg, state, draft_layers=layers,
                                          damp=0.05)
    assert draft_cfg.num_layers == jdraft_cfg.num_layers == layers
    want_damped = state_dict_from_jax(jax.tree.map(np.asarray, jdamped), tcfg)
    want_draft = state_dict_from_jax(jax.tree.map(np.asarray, jdraft),
                                     draft_cfg)
    assert sorted(damped) == sorted(want_damped)
    assert sorted(draft) == sorted(want_draft)
    for name in want_damped:
        assert torch.equal(damped[name], want_damped[name]), name
    for name in want_draft:
        assert torch.equal(draft[name], want_draft[name]), name
    scaled = [n for n in state if not torch.equal(state[n], damped[n])]
    suffixes = {"attn.out.kernel", "mlp.wo.kernel", "moe.wo"}
    assert scaled and all(n.split(".", 2)[2] in suffixes for n in scaled)
    assert all(int(n.split(".")[1]) >= layers for n in scaled)


@pytest.fixture(scope="module")
def jax_spec_results(setup):
    engine = JEngine(setup["jcfg"], setup["jdamped"], slots=2,
                     buckets=BUCKETS, seed=0,
                     draft_config=setup["jdraft_cfg"],
                     draft_params=setup["jdraft"], spec_tokens=GAMMA)
    results = engine.run(_greedy(GREEDY, JRequest, JSampling))
    return results, engine.stats()


@pytest.mark.parametrize("draft_kind", ["damped", "random"])
def test_spec_streams_equal_the_jax_engine_and_the_plain_stream(
        setup, jax_spec_results, draft_kind):
    """Greedy streams of the speculating engine equal the plain engine's
    on the same (damped) target whatever the draft, and with the damped
    target's own draft they equal the JAX speculating engine's, with the
    same accepted and proposed counts."""
    tcfg, damped = setup["tcfg"], setup["damped"]
    plain = _tokens(_engine(tcfg, damped).run(_greedy(GREEDY)))
    if draft_kind == "damped":
        draft_cfg, draft = setup["draft_cfg"], setup["draft"]
    else:
        draft_cfg = dataclasses.replace(tcfg, num_layers=1)
        draft = init_params(draft_cfg, seed=7, device="cpu")
    spec = _engine(tcfg, damped, draft_config=draft_cfg,
                   draft_params=draft, spec_tokens=GAMMA)
    got = spec.run(_greedy(GREEDY))
    stats = spec.stats()
    assert _tokens(got) == plain
    assert 0 <= stats["spec_accepted"] <= stats["spec_proposed"]
    assert stats["spec_proposed"] > 0 and stats["spec_rounds"] > 0
    if draft_kind == "random":
        return
    want, want_stats = jax_spec_results
    assert _tokens(got) == _tokens(want)
    for uid in want:
        np.testing.assert_allclose(got[uid].logprobs, want[uid].logprobs,
                                   atol=LOGP_ATOL, rtol=0)
    for key in ("spec_accepted", "spec_proposed", "requests", "tokens"):
        assert stats[key] == want_stats[key], key
    # The damped target's draft predicts it well.
    assert stats["spec_accept_rate"] > 0.5


def test_spec_sampled_rows_complete_inside_their_top_k(setup):
    tcfg, damped = setup["tcfg"], setup["damped"]
    k = 5
    spec = _engine(tcfg, damped, draft_config=setup["draft_cfg"],
                   draft_params=setup["draft"], spec_tokens=GAMMA, seed=11)
    requests = [Request(f"s{i}", _prompt(40 + i, 6 + 5 * i),
                        SamplingParams(temperature=0.8, top_k=k,
                                       max_new_tokens=7))
                for i in range(3)]
    results = spec.run(requests)
    stats = spec.stats()
    # Sampled rows accept nothing and are not counted as proposals.
    assert stats["spec_proposed"] == 0 and stats["spec_accepted"] == 0
    for req in requests:
        res = results[req.uid]
        assert len(res.tokens) == 7
        assert np.isfinite(res.logprobs).all()
        assert ((res.tokens >= 0) & (res.tokens < VOCAB)).all()


def test_spec_headroom_enforced_at_submit_and_the_edge_streams(setup):
    """A speculating engine reserves γ positions: bucket + max_new_tokens
    + γ may equal max_seq_len (a prompt of the bucket's width writes the
    last verify chunk up to the row's last position) but not exceed it.
    At the edge the spec stream equals the plain one: no verify write is
    clamped onto earlier rows."""
    tcfg, damped = setup["tcfg"], setup["damped"]
    spec = _engine(tcfg, damped, draft_config=setup["draft_cfg"],
                   draft_params=setup["draft"], spec_tokens=GAMMA)
    edge_new = SEQ - BUCKETS[-1] - GAMMA
    over = Request("over", _prompt(9, BUCKETS[-1]),
                   SamplingParams(temperature=0.0,
                                  max_new_tokens=edge_new + 1))
    with pytest.raises(ValueError, match="spec headroom"):
        spec.submit(over)
    _engine(tcfg, damped).submit(over)  # fits without speculation
    edge = dataclasses.replace(over, uid="edge", sampling=SamplingParams(
        temperature=0.0, max_new_tokens=edge_new))
    got = spec.run([edge])["edge"]
    want = _engine(tcfg, damped).run([edge])["edge"]
    assert len(got.tokens) == edge_new
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_spec_headroom_holds_pages_from_a_replica_without_a_draft(setup):
    """A prefill replica without a draft reserves no γ positions, so a
    speculating decode replica holds each page to its own headroom: a
    page whose bucket + max_new_tokens + γ exceeds max_seq_len is refused
    (a fleet keeps it in the prefill outbox and its tick raises); one at
    the edge streams as the plain engine does.  Without the check the
    last verify round's write is clamped onto committed rows: the JAX
    engine accepts such a page, and at bucket + max_new_tokens =
    max_seq_len its last token departs from the plain stream's (ROADMAP
    Queue 3 item 13)."""
    tcfg, damped = setup["tcfg"], setup["damped"]
    spec_kw = dict(draft_config=setup["draft_cfg"],
                   draft_params=setup["draft"], spec_tokens=GAMMA)
    edge_new = SEQ - BUCKETS[-1] - GAMMA
    prompt = _prompt(9, BUCKETS[-1])

    def request(uid, new):
        return Request(uid, prompt, SamplingParams(temperature=0.0,
                                                   max_new_tokens=new))

    # The reference accepts the page at bucket + max_new_tokens =
    # max_seq_len, and its last token departs from the plain stream.
    jfull = JRequest("full", prompt, JSampling(temperature=0.0,
                                               max_new_tokens=edge_new
                                               + GAMMA))
    jpre = JEngine(setup["jcfg"], setup["jdamped"], slots=2,
                   buckets=BUCKETS, role="prefill")
    jdec = JEngine(setup["jcfg"], setup["jdamped"], slots=2,
                   buckets=BUCKETS, role="decode",
                   draft_config=setup["jdraft_cfg"],
                   draft_params=setup["jdraft"], spec_tokens=GAMMA)
    jpre.submit(jfull)
    jpre.step()
    jdec.insert_page(jpre.outbox.popleft())
    while jdec._page_queue or jdec._live_slots():
        jdec.step()
    jplain = JEngine(setup["jcfg"], setup["jdamped"], slots=2,
                     buckets=BUCKETS).run([jfull])["full"].tokens
    jgot = jdec.results["full"].tokens
    assert len(jgot) == len(jplain) == edge_new + GAMMA
    np.testing.assert_array_equal(jgot[:-1], jplain[:-1])
    assert jgot[-1] != jplain[-1]

    pre = _engine(tcfg, damped, role="prefill")
    dec = _engine(tcfg, damped, role="decode", **spec_kw)
    for extra in range(1, GAMMA + 1):
        over = request(f"over{extra}", edge_new + extra)
        pre.submit(over)  # fits the prefill replica: it has no draft
        pre.step()
        page = pre.outbox.popleft()
        with pytest.raises(ValueError, match="spec headroom"):
            dec.insert_page(page)
    assert dec.stats()["pages_in"] == 0 and not dec._page_queue

    fleet = ReplicaFleet()
    fleet.add_replica(pre)
    fleet.add_replica(dec)
    fleet.submit(request("over", edge_new + 1))
    with pytest.raises(ValueError, match="spec headroom"):
        fleet.step()
    assert [p.request.uid for p in pre.outbox] == ["over"]
    assert fleet.pages_streamed == 0
    pre.outbox.clear()

    edge = request("edge", edge_new)
    fleet.submit(edge)
    for _ in range(4 * edge_new):
        if "edge" in fleet.results:
            break
        fleet.step()
    got = fleet.results["edge"].tokens
    want = _engine(tcfg, damped).run([edge])["edge"].tokens
    assert len(got) == edge_new and fleet.pages_streamed == 1
    np.testing.assert_array_equal(got, want)
    assert dec.stats()["spec_rounds"] > 0


def test_spec_tokens_bounds(setup):
    """γ in [1, 14]: the γ+1 verify chunk stays below the flash prefill
    threshold, so verify always takes the cached attention."""
    assert MAX_SPEC_TOKENS + 1 < FLASH_PREFILL_MIN
    tcfg = setup["tcfg"]
    for bad in (0, MAX_SPEC_TOKENS + 1):
        with pytest.raises(ValueError, match="spec_tokens"):
            _engine(tcfg, setup["damped"], draft_config=setup["draft_cfg"],
                    draft_params=setup["draft"], spec_tokens=bad)
    target = get_programs(tcfg, 2, BUCKETS, device="cpu")
    draft = get_programs(setup["draft_cfg"], 2, BUCKETS, device="cpu")
    for ok in (1, MAX_SPEC_TOKENS):
        assert SpecPrograms(target, draft, ok).spec_tokens == ok
    other_vocab = get_programs(dataclasses.replace(
        setup["draft_cfg"], vocab_size=VOCAB * 2), 2, BUCKETS, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        SpecPrograms(target, other_vocab, 2)
    with pytest.raises(ValueError, match="slots"):
        SpecPrograms(target, get_programs(setup["draft_cfg"], 3, BUCKETS,
                                          device="cpu"), 2)


def test_accept_chunk_takes_the_longest_matching_prefix():
    """The verify rule on hand-made logits: greedy rows accept up to the
    first mismatch and take the target's argmax there as the bonus; a
    sampled row accepts nothing."""
    vocab, width = 8, 4
    target = torch.tensor([[1, 2, 3, 4], [1, 2, 3, 4], [5, 6, 7, 0]])
    logits = torch.full((3, width, vocab), -5.0)
    logits.scatter_(2, target[..., None], 5.0)
    chunk = torch.tensor([[0, 1, 2, 3],      # all 3 proposals match
                          [0, 1, 7, 3],      # mismatch at proposal 2
                          [0, 5, 6, 7]])     # matches, but sampled
    temps = torch.tensor([0.0, 0.0, 1.0])
    gen = torch.Generator().manual_seed(0)
    emitted, emit_len, logps, accepted = decode.accept_chunk(
        logits, chunk, gen, temps, torch.zeros(3, dtype=torch.long), 0)
    assert accepted.tolist() == [3, 1, 0]
    assert emit_len.tolist() == [4, 2, 1]
    assert emitted[0].tolist() == [1, 2, 3, 4]
    assert emitted[1, :2].tolist() == [1, 2]
    want = torch.log_softmax(logits, -1).gather(-1, emitted[..., None])[
        ..., 0]
    torch.testing.assert_close(logps, want, atol=0, rtol=0)


def test_program_memo_shares_equal_keys(setup):
    tcfg = setup["tcfg"]
    clear_programs()
    a = get_programs(tcfg, 2, (32, 16), device="cpu")
    assert get_programs(tcfg, 2, BUCKETS, device="cpu") is a
    assert get_programs(tcfg, 3, BUCKETS, device="cpu") is not a
    draft = get_programs(setup["draft_cfg"], 2, BUCKETS, device="cpu")
    spec = get_spec_programs(a, draft, GAMMA)
    assert get_spec_programs(a, draft, GAMMA) is spec
    assert get_spec_programs(a, draft, GAMMA - 1) is not spec
    first = _engine(tcfg, setup["state"])
    assert _engine(tcfg, setup["state"]).programs is first.programs is a
    clear_programs()
    assert get_programs(tcfg, 2, BUCKETS, device="cpu") is not a
    assert first.aot_compile() == 0.0  # no kernel to build on the CPU

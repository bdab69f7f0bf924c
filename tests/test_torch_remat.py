"""Port parity: every remat policy (``dlrover_tpu_torch/ops/remat_policy.py``)
against the reference registry and model (``dlrover_tpu/ops/
remat_policy.py``, ``dlrover_tpu/models/transformer.py``).

* The registry: names, canonical ``offload:<names>`` spelling, errors and
  accounting fields equal the reference's.
* Every registered policy and one ``offload:`` list, on a tiny GPT-2
  (fused qkv, biases) and a tiny Llama (GQA, SwiGLU, RoPE), under the
  ``xla`` and ``flash`` attention (the flash names under flash only),
  and on a tiny MoE (einsum dispatch): the loss ``mean(logits^2) + aux``
  and its gradients from one JAX init carried across.
  - Against the reference under the same policy: the loss within
    ``LOSS_RTOL`` (``tests/test_torch_train.py``'s metric tolerance) and
    each gradient within ``GRAD_RTOL`` of its leaf's largest value (fp32
    reassociation: the reference sums in another order; measured at most
    6e-7), the key slice of the fused qkv bias left out (its gradient is
    zero in exact arithmetic and rounding noise in both).
  - Against the port's own ``none`` run: bit for bit.  A kept site's
    replay saves what the product saves and its backward runs the
    product's own formulas in their order, so nothing may move.
  - The names the port keeps are the reference's named saveables the
    policy lists and the traced model emits; under ``dots`` and
    ``dots_no_batch`` the products kept a layer are the reference's
    ``dot_general``s a layer (with batch dimensions or without), kernels
    excepted.
  - Host offload on the CPU keeps a CPU copy: the bytes copied out and
    back are the registry's ``offload_bytes_per_token_layer`` x tokens x
    layers x ``d_model`` x the item size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from dlrover_tpu.models.gpt2 import gpt2_config as jgpt2_config
from dlrover_tpu.models.llama import llama_config as jllama_config
from dlrover_tpu.models.transformer import TransformerLM as JModel
from dlrover_tpu.ops import remat_policy as jrp
from dlrover_tpu_torch.models import gpt2_config, llama_config
from dlrover_tpu_torch.models.from_jax import state_dict_from_jax
from dlrover_tpu_torch.models.transformer import TransformerLM
from dlrover_tpu_torch.ops import remat_policy as rp
from dlrover_tpu_torch.optimizers import optax_ports as ox
from dlrover_tpu_torch.trainer import train_lib as ttl

LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5
B, S = 2, 32
GPT2 = dict(num_layers=2, d_model=64, num_heads=2, vocab_size=128,
            max_seq_len=64)
LLAMA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=128, max_seq_len=64)
MOE = dict(GPT2, num_experts=4, top_k=2)
FLASH = dict(flash_block_q=32, flash_block_kv=32)
POLICIES = sorted(rp.available()) + ["offload:attn_out,mlp_wo"]


def _configs(model, impl, remat):
    kw = dict(attention_impl=impl, remat=remat, **FLASH)
    if model == "llama":
        return (jllama_config("tiny", **LLAMA, dtype=jnp.float32, **kw),
                llama_config("tiny", **LLAMA, dtype=torch.float32, **kw))
    shape = MOE if model == "moe" else GPT2
    return (jgpt2_config("124m", **shape, dtype=jnp.float32, **kw),
            gpt2_config("124m", **shape, dtype=torch.float32, **kw))


def _tokens():
    rng = np.random.default_rng(7)
    return rng.integers(0, GPT2["vocab_size"], size=(B, S), dtype=np.int32)


_JAX = {}


def _jax_model(model, impl, remat):
    key = (model, impl, remat)
    if key not in _JAX:
        jcfg, _ = _configs(model, impl, remat)
        jm = JModel(jcfg)
        tokens = jnp.asarray(_tokens())
        # One init a model: the parameters do not depend on the policy.
        init_key = (model, impl, "none")
        params = (_JAX[init_key][0] if init_key in _JAX else
                  jm.init(jax.random.PRNGKey(0), tokens))

        def loss(p):
            logits, aux = jm.apply(p, tokens)
            return jnp.mean(logits.astype(jnp.float32) ** 2) + aux

        value, grads = jax.jit(jax.value_and_grad(loss))(params)
        # The forward's products, and the names the differentiated
        # program emits (the flash names live in the kernel's vjp).
        jaxprs = (jax.make_jaxpr(lambda p: jm.apply(p, tokens))(params),
                  jax.make_jaxpr(jax.grad(loss))(params))
        _JAX[key] = (params, float(value), grads, jaxprs)
    return _JAX[key]


def _np(tree):
    return jax.tree.map(np.asarray, meta.unbox(tree)["params"])


def _port(model, impl, remat):
    params, *_ = _jax_model(model, impl, "none")
    cfg = dataclasses.replace(_configs(model, impl, "none")[1], remat=remat)
    m = TransformerLM(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(_np(params), cfg))
    rp.reset_counts()
    logits, aux = m.forward_aux(torch.from_numpy(_tokens()).long())
    loss = logits.float().square().mean() + aux
    loss.backward()
    counts = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in rp.COUNTS.items()}
    return cfg, loss.item(), {k: p.grad.clone() for k, p in
                              m.named_parameters()}, counts


_NONE = {}


def _port_none(model, impl):
    if (model, impl) not in _NONE:
        _NONE[model, impl] = _port(model, impl, "none")
    return _NONE[model, impl]


def _sub_jaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (list, tuple)) else (v,)):
            if hasattr(item, "eqns"):  # a Jaxpr
                yield item
            elif hasattr(getattr(item, "jaxpr", None), "eqns"):  # closed
                yield item.jaxpr


def _walk(jaxpr, in_scan=False):
    """``(primitive name, params, inside the layers' scan)`` of every
    equation, kernels (``pallas_call``) not entered."""
    for eqn in jaxpr.eqns:
        yield eqn.primitive.name, eqn.params, in_scan
        if eqn.primitive.name == "pallas_call":
            continue
        for sub in _sub_jaxprs(eqn.params):
            yield from _walk(sub, in_scan or eqn.primitive.name == "scan")


def _reference_sites(jaxprs):
    """The names the traced reference emits, and its forward's
    dot_generals a layer (with batch dimensions, without)."""
    forward, differentiated = jaxprs
    names = {params["name"] for prim, params, _ in _walk(
        differentiated.jaxpr) if prim == "name"}
    batch = plain = 0
    for prim, params, in_scan in _walk(forward.jaxpr):
        if prim == "dot_general" and in_scan:
            (_, _), (lb, _) = params["dimension_numbers"]
            if lb:
                batch += 1
            else:
                plain += 1
    return names, batch, plain


CASES = ([(m, impl, p) for m in ("gpt2", "llama") for impl in ("xla", "flash")
          for p in POLICIES
          if impl == "flash" or not rp.resolve(p).requires_flash]
         + [("moe", "xla", "branch_out"), ("moe", "xla", "dots"),
            ("moe", "xla", "dots_no_batch")])


@pytest.mark.parametrize("model,impl,remat", CASES,
                         ids=[f"{m}-{i}-{p}" for m, i, p in CASES])
def test_policy_matches_reference_and_none(model, impl, remat):
    _, jloss, jgrads, jaxpr = _jax_model(model, impl, remat)
    cfg, loss, grads, counts = _port(model, impl, remat)
    _, loss0, grads0, _ = _port_none(model, impl)
    # Bit for bit against the port's none.
    assert loss == loss0
    for k, g in grads.items():
        assert torch.equal(g, grads0[k]), k
    # Against the reference under the same policy.
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    want = state_dict_from_jax(_np(jgrads), cfg)
    hd = cfg.resolved_head_dim
    for k, w in want.items():
        g = grads[k]
        if k.endswith("attn.qkv.bias"):
            keep = torch.ones(w.shape, dtype=torch.bool)
            keep[..., hd:2 * hd] = False
            g, w = g[keep], w[keep]
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= GRAD_RTOL * scale + 1e-12, k
    # The kept sites.
    policy = rp.resolve(remat)
    names, batch, plain = _reference_sites(jaxpr)
    replays = counts["replays"]
    named = {n for n in replays if n not in ("dot", "batch_dot")}
    if not policy.dots:
        assert named == set(policy.saved_names + policy.offload_names) & \
            names
    layers = cfg.num_layers
    if policy.dots:
        # Each product once, whichever name it counts under.
        kept = sum(replays.values()) - sum(
            replays.get(n, 0) for n in ("flash_out", "flash_lse"))
        want_dots = plain + (batch if policy.dots == "all" else 0)
        assert kept == want_dots * layers, (replays, batch, plain)
    if policy.offload_names:
        assert counts["kept"] == {} and counts["host"] > 0
        assert counts["d2h"] == counts["h2d"] > 0
    else:
        assert counts["d2h"] == counts["h2d"] == 0


@pytest.mark.parametrize("remat", ["offload", "offload:attn_out,mlp_wo"])
def test_offload_moves_the_registry_bytes(remat):
    """GPT-2 (fused qkv): the bytes copied out and back are the
    registry's count from the shapes, exactly."""
    cfg, _, _, counts = _port("gpt2", "xla", remat)
    per = rp.resolve(remat).offload_bytes_per_token_layer
    want = int(per * B * S * cfg.num_layers * cfg.d_model * 4)
    assert counts["d2h"] == counts["h2d"] == want
    assert counts["pinned"] == 0  # the CPU keeps a copy on the CPU


def test_registry_resolves_and_canonicalizes():
    # The parent tree kept the raw string as the name.
    assert rp.resolve("offload:mlp_wo,qkv_proj").name == \
        "offload:qkv_proj,mlp_wo"
    assert rp.resolve("offload:mlp_wo,attn_out,qkv_proj").name == "offload"
    assert rp.resolve("offload:attn_out,mlp_wo") == rp.resolve(
        "offload:mlp_wo, attn_out")
    offload = rp.resolve("offload")
    assert offload.offload_names == ("qkv_proj", "attn_out", "mlp_wo")
    assert offload.recompute_fraction == 0.0
    assert offload.offload_bytes_per_token_layer == 5.0
    with pytest.raises(ValueError, match="unknown offload target"):
        rp.resolve("offload:nonsense")
    with pytest.raises(ValueError, match="at least one name"):
        rp.resolve("offload:")
    with pytest.raises(ValueError, match="remat must be one of"):
        rp.resolve("bogus_policy")
    with pytest.raises(ValueError, match="attention_impl='flash'"):
        rp.validate("offload:flash_out", attention_impl="xla")


@pytest.mark.parametrize("name", sorted(jrp.available()) + [
    "offload:mlp_wo,qkv_proj", "offload:flash_lse,attn_out",
    "offload:mlp_out"])
def test_policy_fields_equal_the_reference(name):
    mine, ref = rp.resolve(name), jrp.resolve(name)
    for field in ("name", "saved_names", "offload_names", "builtin",
                  "hbm_act_per_token_layer", "recompute_fraction",
                  "offload_bytes_per_token_layer", "requires_flash"):
        assert getattr(mine, field) == getattr(ref, field), field
    assert rp.offload_policy_name(mine.offload_names or ("attn_out",)) == \
        jrp.offload_policy_name(ref.offload_names or ("attn_out",))


def test_accounting_tables_equal_the_reference():
    assert rp.available() == jrp.available()
    assert rp.SAVEABLE_BYTES == jrp.SAVEABLE_BYTES
    assert rp.RECOMPUTE_AVOIDED == jrp.RECOMPUTE_AVOIDED
    assert rp.OFFLOADABLE_NAMES == jrp.OFFLOADABLE_NAMES
    assert rp.DEFAULT_OFFLOAD_NAMES == jrp.DEFAULT_OFFLOAD_NAMES


def test_save_only_twin_keeps_the_same_sites_on_the_device():
    twin = rp.register(rp.RematPolicy(name="save:attn_out,mlp_wo",
                                      saved_names=("attn_out", "mlp_wo")))
    try:
        cfg, loss, grads, counts = _port("gpt2", "xla", twin.name)
    finally:
        del rp._REGISTRY[twin.name]
    _, loss0, grads0, _ = _port_none("gpt2", "xla")
    assert loss == loss0
    assert all(torch.equal(g, grads0[k]) for k, g in grads.items())
    per_site = B * S * cfg.num_layers * cfg.d_model * 4
    assert counts["kept"] == {"attn_out": per_site, "mlp_wo": per_site}
    assert counts["d2h"] == 0


def test_no_policy_or_optimizer_raises_the_item_7_refusal():
    """Every registered policy and offload list validates under the
    impls that allow it, and every optimizer name builds: nothing cites
    ROADMAP Queue 1 item 7 any more."""
    for name in POLICIES + ["offload:flash_out,flash_lse"]:
        for impl in ("xla", "flash"):
            try:
                rp.validate(name, impl)
            except ValueError as err:
                assert "attention_impl='flash'" in str(err)
                assert "item 7" not in str(err)
    for name in ("adamw", "adafactor", "sgd", "lion", "agd", "q8_adam",
                 "q4_adam"):
        ttl.make_optimizer(name)


def test_policies_run_without_grad_as_a_plain_forward():
    _, cfg = _configs("gpt2", "xla", "dots")
    m = TransformerLM(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(_np(_jax_model(
        "gpt2", "xla", "none")[0]), cfg))
    rp.reset_counts()
    with torch.no_grad():
        m(torch.from_numpy(_tokens()).long())
    assert sum(rp.COUNTS["replays"].values()) == 0
    assert rp.COUNTS["kept"] == {}


@pytest.mark.parametrize("remat", ["dots", "offload", "branch_out"])
def test_train_step_under_a_policy_equals_none(remat):
    """One ``build_train`` step under the policy: the same metrics and
    parameters as under ``none``, bit for bit."""
    out = {}
    for name in ("none", remat):
        cfg = gpt2_config("124m", **GPT2, dtype=torch.float32,
                          attention_impl="xla", remat=name)
        train = ttl.build_train(cfg, ttl.make_optimizer("adamw"),
                                global_batch_size=4, seq_len=S,
                                device="cpu")
        state = train.init(seed=3)
        tok = np.random.default_rng(1).integers(
            0, 128, size=(4, S + 1), dtype=np.int32)
        state, m = train.step(state, {"inputs": tok[:, :-1],
                                      "targets": tok[:, 1:]})
        out[name] = (m["loss"].item(), m["grad_norm"].item(),
                     ox.stack_layers(state.params()))
    (l0, n0, p0), (l1, n1, p1) = out["none"], out[remat]
    assert (l0, n0) == (l1, n1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


@pytest.mark.parametrize("remat", ["dots", "offload:attn_out,mlp_wo",
                                   "branch_out"])
def test_example_takes_the_policies_and_optimizers(remat, monkeypatch):
    from dlrover_tpu_torch.examples import train_lm

    monkeypatch.delenv("DLROVER_TPU_MASTER_ADDR", raising=False)
    for opt in ("lion", "agd"):
        assert train_lm.main([
            "--device", "cpu", "--steps", "1", "--layers", "1",
            "--d-model", "32", "--heads", "2", "--vocab", "64",
            "--seq-len", "16", "--batch-size", "4", "--remat", remat,
            "--optimizer", opt]) == 0


def test_config_fields_are_the_references():
    """Every field of the reference's config exists in the port's with
    the same default (the dtypes aside)."""
    from dlrover_tpu.models.transformer import TransformerConfig as JConfig
    from dlrover_tpu_torch.models.transformer import TransformerConfig

    theirs = {f.name: f.default for f in dataclasses.fields(JConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(TransformerConfig)}
    assert set(theirs) <= set(mine), set(theirs) - set(mine)
    for name, default in theirs.items():
        if name not in ("dtype", "param_dtype", "logits_dtype"):
            assert mine[name] == default, name


@pytest.mark.parametrize("remat", ["branch_out", "dots"])
def test_grouped_moe_policies_equal_none(remat):
    """The grouped dispatch (its grouped GEMM a kernel, not a dot; its
    combine the site ``mlp_out``): bit for bit against ``none``."""
    cfg = gpt2_config("124m", **MOE, dtype=torch.float32,
                      moe_dispatch="grouped")
    state = None
    out = {}
    for name in ("none", remat):
        m = TransformerLM(dataclasses.replace(cfg, remat=name), device="cpu")
        if state is None:
            from dlrover_tpu_torch.models.transformer import init_params

            state = init_params(cfg, seed=4, device="cpu")
        m.load_state_dict(state)
        rp.reset_counts()
        logits, aux = m.forward_aux(torch.from_numpy(_tokens()).long())
        (logits.float().square().mean() + aux).backward()
        out[name] = ({k: p.grad for k, p in m.named_parameters()},
                     dict(rp.COUNTS["replays"]))
    (g0, _), (g1, replays) = out["none"], out[remat]
    assert all(torch.equal(g1[k], g0[k]) for k in g0)
    if remat == "branch_out":
        assert replays == {"attn_out": 2, "mlp_out": 2}
    else:  # the xla attention's two products, qkv, out and the router
        assert replays == {"qkv_proj": 2, "attn_out": 2, "dot": 2,
                           "batch_dot": 4}

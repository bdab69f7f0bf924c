"""Spawned gloo worlds for the port's multi-process tests.

``run_world(n, fn, payload, tmp)`` starts ``n`` processes with ``spawn``
(never ``fork``), joins a gloo group through a ``file://`` store under
``tmp`` (no fixed port, so parallel test workers never collide), runs
``fn(rank, n, payload)`` on each rank with one intra-op thread, and
returns every rank's result; a rank that fails or outlives ``timeout``
fails the call.  The launcher is the package's own
(``dlrover_tpu_torch.utils.scaling.spawn_world``).  Each world runs many
cases, so each spawn pays for itself.  This module imports torch and the port only (no JAX): a spawned
rank starts in a second or two.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dlrover_tpu_torch.utils.scaling import spawn_world

TINY = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
            max_seq_len=64)
BATCH, SEQ = 8, 32


def run_world(n, fn, payload, tmp, timeout=300.0):
    return spawn_world(n, fn, payload, timeout, directory=str(tmp))


def lm_batch(seed=0, batch=BATCH, seq=SEQ, vocab=TINY["vocab_size"]):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


# -- the int8 collectives ------------------------------------------------------


def collective_cases(n):
    """``(id, fn, algo, shape, dtype, dim, mean)``: partial final blocks,
    whole blocks, both algorithms, both dims, fp32 and bf16."""
    cases = []
    for algo in ("oneshot", "ring"):
        for shape in ((3, 100), (2, 256), (1000,)):
            for mean in (True, False):
                cases.append(("ar", algo, shape, "float32", 0, mean))
        cases.append(("ar", algo, (5, 77), "bfloat16", 0, True))
        for shape, dim in (((n * 3, 100), 0), ((5, n * 40), 1)):
            for mean in (True, False):
                cases.append(("rs", algo, shape, "float32", dim, mean))
        cases.append(("rs", algo, (n * 2, 130), "bfloat16", 0, False))
        for shape, dim in (((3, 100), 0), ((5, 7), 1)):
            cases.append(("ag", algo, shape, "float32", dim, None))
        cases.append(("ag", algo, (4, 90), "bfloat16", 1, None))
    return [(f"{fn}-{algo}-{'x'.join(map(str, shape))}-{dtype}-d{dim}-"
             f"m{mean}",) + (fn, algo, shape, dtype, dim, mean)
            for fn, algo, shape, dtype, dim, mean in cases]


def member_inputs(case, n):
    """Every member's input of a case, fp32 numpy ``[n, *shape]`` (bf16
    cases are rounded to bf16 first); block-scale variety: each row of
    values at its own magnitude, some exact zeros."""
    cid, _, _, shape, dtype, _, _ = case
    # One input for both algorithms of a case.
    seed = sum(map(ord, cid.replace("-ring-", "-oneshot-")))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + tuple(shape)).astype(np.float32)
    x *= np.exp(rng.uniform(-4, 2, size=(n,) + tuple(shape)[:1]
                            )).astype(np.float32).reshape(
        (n,) + (tuple(shape)[:1]) + (1,) * (len(shape) - 1))
    x.reshape(-1)[::17] = 0.0
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def run_collectives(rank, n, cases):
    from dlrover_tpu_torch.parallel import quantized_collectives as qc
    from dlrover_tpu_torch.parallel.wire import Wire

    wire = Wire()
    out = {}
    for case in cases:
        cid, fn, algo, shape, dtype, dim, mean = case
        x = torch.from_numpy(member_inputs(case, n)[rank]).to(
            getattr(torch, dtype))
        if fn == "ar":
            y = qc.quantized_all_reduce(x, wire, mean=mean, algo=algo)
        elif fn == "rs":
            y = qc.quantized_reduce_scatter(x, wire, dim=dim, mean=mean,
                                            algo=algo)
        else:
            y = qc.quantized_all_gather(x, wire, dim=dim, algo=algo)
        out[cid] = (str(y.dtype), y.float().numpy())
    return out


# -- the data-parallel step ---------------------------------------------------------


def _port_cfg():
    from dlrover_tpu_torch.models import gpt2_config

    return gpt2_config("124m", **TINY, dtype=torch.float32)


def run_train(opt, lr, kw, init=None, mesh=None, steps=3):
    """``steps`` steps of ``build_train`` on batches 0.. from ``init``
    (a state dict) or seed 0: per-step (loss, grad_norm, tokens) and the
    final parameters as numpy."""
    from dlrover_tpu_torch.trainer import train_lib as ttl

    cfg = _port_cfg()
    train = ttl.build_train(
        cfg, ttl.make_optimizer(opt, learning_rate=lr),
        global_batch_size=BATCH, seq_len=SEQ, device="cpu", mesh=mesh, **kw)
    state = train.init(seed=0, params=init)
    metrics = []
    for i in range(steps):
        state, m = train.step(state, ttl.shard_batch(lm_batch(i), train))
        metrics.append((m["loss"].item(), m["grad_norm"].item(),
                        m["tokens"].item()))
    flags = {"zero1": train.zero1, "overlap": train.overlap,
             "zero1_stats": train.zero1_stats,
             "overlap_plan": train.overlap_plan, "dp": train.dp,
             "split_dims": ({n: leaf.dim for n, leaf in
                             train.shards.leaves.items()}
                            if train.shards is not None else None)}
    params = {k: v.numpy().copy() for k, v in state.params().items()}
    return metrics, params, flags


def run_train_cases(rank, n, payload):
    """Every ``(key, opt, lr, kw[, steps])`` of ``payload["cases"]`` from
    ``payload["init"]`` (3 steps unless given): rank 0 returns metrics and
    parameters, every rank a digest of its parameters (replicas must
    agree)."""
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import state_digest

    mesh = build_mesh(ParallelConfig(), device_type="cpu")
    init = {k: torch.from_numpy(v) for k, v in payload["init"].items()}
    out = {}
    for key, opt, lr, kw, *steps in payload["cases"]:
        metrics, params, flags = run_train(opt, lr, kw, init=init,
                                           mesh=mesh, steps=(steps or [3])[0])
        digest = int(state_digest.digest_leaves(
            [torch.from_numpy(v) for v in params.values()]))
        out[key] = (metrics, params if rank == 0 else None, flags, digest)
    return out


# -- sharded checkpoints and the live re-layout ---------------------------------------


def trainer(ckpt_dir, job, parallel=None, model=None, **overrides):
    """An ``ElasticTrainer`` on the tiny model (fp32, Adafactor, ZeRO-1;
    ``model``, a key of :func:`mp_config`, for another), its shm arena
    named by ``job``; ``parallel`` (a dict) its ``ParallelConfig``."""
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        ElasticTrainer,
        TrainerConfig,
    )

    os.environ["DLROVER_TPU_JOB"] = job
    cfg = dict(global_batch_size=BATCH, seq_len=SEQ, optimizer="adafactor",
               learning_rate=1e-2, zero1=True, checkpoint_dir=ckpt_dir,
               ckpt_every=1000, report_every=1000, numeric_checks=False)
    cfg.update(overrides)
    return ElasticTrainer(
        mp_config(model) if model else _port_cfg(), TrainerConfig(**cfg),
        device="cpu",
        parallel=ParallelConfig(**parallel) if parallel else None)


def pieces(t):
    """This rank's pieces of a trainer's state, with their layout:
    ``{path: (global_shape, index, replica_id, value)}``."""
    from dlrover_tpu_torch.checkpoint import shm_handler as sh

    layout = t._layout()
    out = {}
    for path, leaf in sh.tree_flatten_with_path(t.state.checkpoint_tree()):
        spot = layout[path]
        value = leaf.detach().numpy().copy() if isinstance(
            leaf, torch.Tensor) else leaf
        out[path] = (tuple(spot.global_shape), tuple(spot.index),
                     spot.replica_id, value)
    return out


def assemble(ranks):
    """The whole state from every rank's ``pieces`` by plain indexing:
    each piece a rank holds as replica 0 lands at its index."""
    whole = {}
    for got in ranks:
        for path, (shape, index, replica, value) in got.items():
            if replica != 0:
                continue
            if not isinstance(value, np.ndarray):
                whole[path] = value
                continue
            arr = whole.setdefault(path, np.zeros(shape, value.dtype))
            arr[tuple(slice(b, e) for b, e in index)] = value
    return whole


def save_and_restore(rank, n, payload):
    """Train 2 steps at world ``n`` and save (sharded) into
    ``payload["save"]`` (then, with ``payload["relayout"]``, ask for a
    live re-layout to that world); then restore every directory of
    ``payload["restore"]`` on a new trainer.  Returns the saved state's
    pieces and each restore's step and pieces."""
    out = {}
    if payload.get("save"):
        t = trainer(payload["save"], f"{payload['job']}_save{n}",
                    parallel=payload.get("parallel"),
                    model=payload.get("model"))
        t.fit([lm_batch(i) for i in range(2)], max_steps=2)
        assert t._ckpt.wait(timeout=120)
        out["saved"] = pieces(t)
        if payload.get("digest"):
            from dlrover_tpu_torch.trainer import state_digest

            out["digest"] = int(state_digest.digest_state(
                t.state, t._layout(), t.train.state_wire))
        out["world"] = (t._world, t.train.dp, t.train.zero1)
        if payload.get("relayout"):
            # A live re-layout of this mesh: refused, or its detail.
            try:
                out["relayout"] = t.apply_world_change(payload["relayout"])
            except NotImplementedError as e:
                out["relayout"] = str(e)
        t.close()
    for name, directory in payload.get("restore", {}).items():
        r = trainer(directory, f"{payload['job']}_restore{n}{name}",
                    model=payload.get("model"))
        out[name] = (r.step, pieces(r))
        r.close()
    return out


def relayout_chain(rank, n, payload):
    """At world 4: train 4 steps and commit; a second trainer restores
    that step from storage (a fresh job tag: no shm); the first trainer
    then re-lays out live 4 -> 4 (no-op) -> 2 -> 1 -> 4.  Then a
    ``relayout.apply`` fault on every attempt: the retries exhaust and
    the trainer falls back to a restore."""
    from dlrover_tpu_torch.common import faults

    job, ckpt = payload["job"], payload["ckpt"]
    a = trainer(ckpt, f"{job}_a", ckpt_every=4, optimizer="sgd",
                grad_accum_ref_world=4)
    a.fit([lm_batch(i) for i in range(4)], max_steps=4)
    assert a._ckpt.wait(timeout=120)
    # The second trainer's saver gets sockets of its own: its close must
    # not take the first one's down.
    socks = os.environ["DLROVER_TPU_SOCKET_DIR"]
    os.environ["DLROVER_TPU_SOCKET_DIR"] = os.path.join(socks, "b")
    os.makedirs(os.environ["DLROVER_TPU_SOCKET_DIR"], exist_ok=True)
    b = trainer(ckpt, f"{job}_b", optimizer="sgd", world=2,
                grad_accum_ref_world=4)
    out = {"restored": (b.step, pieces(b)), "chain": []}
    b.close()
    os.environ["DLROVER_TPU_SOCKET_DIR"] = socks
    out["noop"] = a.apply_world_change(4)
    for m in (2, 1, 4):
        detail = a.apply_world_change(m)
        out["chain"].append((m, {k: detail[k] for k in (
            "ok", "fallback", "new_world", "grad_accum", "fold")},
            a.step, a.vmesh.physical_world, a.grad_accum, pieces(a)))
    # Two more steps at world 4 after the chain, then the fault.
    a.fit([lm_batch(i) for i in range(4, 6)], max_steps=6)
    faults.configure("relayout.apply:error", seed=0)
    try:
        detail = a.apply_world_change(2)
        fired = [f for f in faults.active().fired
                 if f[0] == "relayout.apply"]
    finally:
        faults.reset()
    out["fallback"] = ({k: detail.get(k) for k in (
        "ok", "fallback", "restored_step", "new_world")}, a.step,
        a.vmesh.physical_world, len(fired))
    a.close()
    return out


# -- the fsdp and tensor axes ------------------------------------------------------------

LLAMA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=128, max_seq_len=64)
#: A GPT-2 wide enough that every fsdp slice of a leaf a q8 state
#: quantizes is whole 256-value blocks (d_model / 2 = 256).
WIDE = dict(num_layers=1, d_model=512, num_heads=4, vocab_size=128,
            max_seq_len=64)


#: Config overrides of a model key's variant (``"gpt2/pp"``): ring
#: attention; the pipeline at 2 stages of 4 layers with 4 microbatches
#: (GPipe), and its circular schedule of 2 laps.
VARIANTS = {
    "ring": dict(attention_impl="ring"),
    "pp": dict(num_layers=4, pipeline_stages=2, num_microbatches=4),
    "pp_v2": dict(num_layers=4, pipeline_stages=2, num_microbatches=4,
                  pipeline_interleave=2),
}


def mp_config(model):
    """The port's config of a model key: ``gpt2`` (``TINY``), ``llama``
    (``LLAMA``, GQA and an untied head), ``llama_mha`` (``LLAMA`` with
    as many KV heads as heads), ``wide`` (``WIDE``),
    ``gpt2_wot`` (``TINY`` with the MLP's ``wo`` stored transposed) or
    ``moe_<dispatch>`` (``MOE``), fp32; a ``/<variant>`` suffix applies
    :data:`VARIANTS`."""
    import dataclasses

    model, _, variant = model.partition("/")
    cfg = _base_config(model)
    return dataclasses.replace(cfg, **VARIANTS[variant]) if variant else cfg


def _base_config(model):
    from dlrover_tpu_torch.models import gpt2_config, llama_config

    if model.startswith("moe_"):
        return moe_config(model[4:])
    if model == "llama":
        return llama_config("tiny", **LLAMA, dtype=torch.float32)
    if model == "llama_mha":
        return llama_config("tiny", **{**LLAMA, "num_kv_heads": 4},
                            dtype=torch.float32)
    return gpt2_config("124m", **(WIDE if model == "wide" else TINY),
                       dtype=torch.float32,
                       wo_transposed=model == "gpt2_wot")


def run_mp_cases(rank, n, payload):
    """Every ``(key, model, mesh, world, opt, lr, kw)`` of
    ``payload["cases"]`` whose world is ``n``: 3 steps of ``build_train`` from
    ``payload["init"][model]`` (whole state dicts, cut to this rank's
    boxes by ``train.init``).  Returns per case the metrics, this rank's
    parameter pieces ``{name: (whole shape, index, replica_id, value)}``,
    the wire bytes of the last step by axis and leg, the pipeline's
    counts of the last step, and the batch group (ring attention's model
    variants build under ``RING_RULES``); or, for
    a case the step refuses, the refusal's message.  Then, under
    ``"save"``, :func:`save_and_restore` of ``payload["saves"][n]``."""
    from dlrover_tpu_torch.parallel import pipeline
    from dlrover_tpu_torch.parallel import rules as lr_lib
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_lib as ttl

    out = {}
    for key, model, mesh_kw, world, opt, lr, kw in payload["cases"]:
        if world != n:
            continue
        mesh = build_mesh(ParallelConfig(**mesh_kw), device_type="cpu")
        cfg = mp_config(model)
        rules = lr_lib.RING_RULES if cfg.attention_impl == "ring" else None
        try:
            train = ttl.build_train(
                cfg, ttl.make_optimizer(opt, learning_rate=lr),
                global_batch_size=BATCH, seq_len=SEQ, device="cpu",
                mesh=mesh, rules=rules, **kw)
        except (NotImplementedError, ValueError) as e:
            out[key] = {"refused": str(e)}
            continue
        init = {k: torch.from_numpy(v)
                for k, v in payload["init"][model].items()}
        state = train.init(params=init)
        stats = None
        if train.config.num_experts:
            from dlrover_tpu_torch.trainer.train_lib import (
                build_moe_stats_fn,
            )

            stats = build_moe_stats_fn(train)(
                state, ttl.shard_batch(lm_batch(0), train)).numpy()
        metrics = []
        for i in range(3):
            wire_lib.reset_counts()
            pipeline.reset_counts()
            state, m = train.step(state, ttl.shard_batch(lm_batch(i), train))
            metrics.append((m["loss"].item(), m["grad_norm"].item(),
                            m["tokens"].item()))
        layout = train.param_layout()
        pieces = {}
        for name, v in state.params().items():
            spot = layout[name]
            pieces[name] = (spot.global_shape, spot.index, spot.replica_id,
                            v.numpy().copy())
        out[key] = {"metrics": metrics, "pieces": pieces,
                    "wire": dict(wire_lib.COUNTS["axes"]),
                    "pipeline": dict(pipeline.COUNTS),
                    "batch": (train.batch_rank, train.batch_ranks),
                    "zero1": train.zero1, "stats": stats}
    if n in payload.get("saves", {}):
        out["save"] = save_and_restore(rank, n, payload["saves"][n])
    return out


def assemble_params(ranks, key):
    """A case's whole parameters from every rank's pieces (replica 0)."""
    whole = {}
    for got in ranks:
        for name, (shape, index, replica, value) in got[key][
                "pieces"].items():
            if replica != 0:
                continue
            arr = whole.setdefault(name, np.zeros(shape, value.dtype))
            arr[tuple(slice(b, e) for b, e in index)] = value
    return whole


# -- the seq axis -----------------------------------------------------------------

#: ``ulysses_attention`` cases: (id, batch, sequence, heads, KV heads, head
#: dim, packed segments).
ULYSSES_CASES = [("mha", 2, 16, 4, 4, 8, False), ("gqa", 2, 16, 4, 2, 8,
                                                   False),
                 ("segments", 2, 16, 4, 4, 8, True)]


def ulysses_inputs(case, seed=0):
    """A case's whole ``q, k, v`` ``[B, S, H, D]``, the output cotangent
    and the segment ids (None when unpacked), fp32 numpy."""
    _, b, s, h, hkv, d, packed = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    dout = rng.normal(size=(b, s, h, d)).astype(np.float32)
    seg = (np.arange(s)[None, :] // 5).repeat(b, 0).astype(np.int32) \
        if packed else None
    return q, k, v, dout, seg


def run_ulysses(rank, n, cases):
    """Each case through ``ulysses_attention`` (the xla attention) over a
    seq group of the world: this rank's slices of the output and of the
    gradients of ``q``, ``k`` and ``v``."""
    from dlrover_tpu_torch.models.attention import (
        ulysses_attention,
        xla_attention,
    )
    from dlrover_tpu_torch.parallel.sharding import SeqGroup
    from dlrover_tpu_torch.parallel.wire import Wire

    group = SeqGroup(Wire(axis="seq"), n, rank)
    out = {}
    for case in cases:
        q, k, v, dout, seg = ulysses_inputs(case)
        s = q.shape[1] // n
        cut = slice(rank * s, (rank + 1) * s)
        q, k, v = (torch.from_numpy(x[:, cut]).requires_grad_()
                   for x in (q, k, v))
        ids = None if seg is None else torch.from_numpy(seg[:, cut])

        def attn(q, k, v, seg):
            return xla_attention(q, k, v, causal=True, segment_ids=seg)

        o = ulysses_attention(attn, q, k, v, ids, group)
        o.backward(torch.from_numpy(dout[:, cut]))
        out[case[0]] = tuple(t.detach().numpy().copy()
                             for t in (o, q.grad, k.grad, v.grad))
    return out


def run_sp_cases(rank, n, payload):
    """:func:`run_mp_cases` of ``payload``, then its ``"planted"`` cases
    with every rank's position offset 0 (a wrong offset), and at world 2
    the ``ulysses_attention`` cases (key ``"ulysses"``)."""
    from dlrover_tpu_torch.parallel import sharding

    out = run_mp_cases(rank, n, payload)
    planted = [c for c in payload.get("planted", []) if c[3] == n]
    if planted:
        offset = sharding.SeqGroup.offset
        sharding.SeqGroup.offset = lambda self, local_len: 0
        try:
            out.update(run_mp_cases(rank, n, {"init": payload["init"],
                                              "cases": planted}))
        finally:
            sharding.SeqGroup.offset = offset
    if n == 2:
        out["ulysses"] = run_ulysses(rank, n, ULYSSES_CASES)
    return out


# -- ring attention and the pipeline ---------------------------------------------

#: ``ring_attention`` cases: (id, batch, sequence, heads, KV heads, head
#: dim, packed segments, causal).
RING_CASES = [("causal", 2, 32, 4, 4, 8, False, True),
              ("full", 2, 32, 4, 4, 8, False, False),
              ("segments_gqa", 2, 32, 4, 2, 8, True, True)]


def run_ring(rank, n, cases):
    """Each case through ``ring_attention`` over a seq group of the world
    (inputs as :func:`ulysses_inputs` makes them): this rank's slices of
    the output and of the gradients of ``q``, ``k`` and ``v``."""
    from dlrover_tpu_torch.parallel.ring_attention import ring_attention
    from dlrover_tpu_torch.parallel.sharding import SeqGroup
    from dlrover_tpu_torch.parallel.wire import Wire

    group = SeqGroup(Wire(axis="seq"), n, rank)
    out = {}
    for case in cases:
        q, k, v, dout, seg = ulysses_inputs(case[:7])
        s = q.shape[1] // n
        cut = slice(rank * s, (rank + 1) * s)
        q, k, v = (torch.from_numpy(x[:, cut]).requires_grad_()
                   for x in (q, k, v))
        ids = None if seg is None else torch.from_numpy(seg[:, cut])
        o = ring_attention(q, k, v, causal=case[7], segment_ids=ids,
                           group=group)
        o.backward(torch.from_numpy(dout[:, cut]))
        out[case[0]] = tuple(t.detach().numpy().copy()
                             for t in (o, q.grad, k.grad, v.grad))
    return out


def run_ring_cases(rank, n, payload):
    """:func:`run_mp_cases` of ``payload``, then the ``ring_attention``
    cases (key ``"ring"``)."""
    out = run_mp_cases(rank, n, payload)
    out["ring"] = run_ring(rank, n, RING_CASES)
    return out


# -- serving TP ---------------------------------------------------------------------

#: A small Llama with GQA (4 heads, 2 KV heads) for the serve TP cases.
SERVE_LLAMA = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   d_ff=128, vocab_size=128, max_seq_len=64)
SERVE_BUCKETS = (16, 32)
SERVE_SLOTS = 2
#: (prompt length, new tokens) of the greedy requests.
SERVE_GREEDY = [(5, 6), (20, 4), (12, 8), (30, 3), (17, 5)]


def serve_config():
    from dlrover_tpu_torch.models import llama_config

    return llama_config("tiny", **SERVE_LLAMA, dtype=torch.float32)


def serve_requests(shapes=SERVE_GREEDY, prefix="r", temp=0.0):
    from dlrover_tpu_torch.rl.generation import SamplingParams
    from dlrover_tpu_torch.serving import Request

    return [Request(f"{prefix}{i}", np.random.default_rng(i).integers(
        1, SERVE_LLAMA["vocab_size"], size=p), sampling=SamplingParams(
            max_new_tokens=n, temperature=temp))
        for i, (p, n) in enumerate(shapes)]


def _streams(results):
    return {u: (r.tokens.tolist(), r.logprobs.tolist())
            for u, r in results.items()}


def run_serve_tp(rank, n, payload):
    """Serving at ``tp=n`` over the world: the greedy streams and the
    per-rank KV bytes of one engine; then, on a fresh engine, a fold
    ``n -> 1 -> n`` mid-serve (half the requests submitted and stepped
    once before each fold) and every rank's streams after it, with what
    each fold left the rank holding."""
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.serving import ServingEngine

    cfg = serve_config()
    state = {k: torch.from_numpy(v) for k, v in payload["state"].items()}

    def engine():
        return ServingEngine(cfg, state, tp=n, slots=SERVE_SLOTS,
                             buckets=SERVE_BUCKETS, seed=0, device="cpu")

    out = {}
    e = engine()
    wire_lib.reset_counts()
    out["streams"] = _streams(e.run(serve_requests()))
    out["wire"] = dict(wire_lib.COUNTS["axes"])
    out["kv_bytes"] = e.kv_device_bytes()
    out["own_kv_bytes"] = sum(t.numel() * t.element_size() for t in e.cache)
    out["local_kv_heads"] = int(e.cache[0].shape[-2])
    out["sampled"] = {u: v for u, v in _streams(e.run(serve_requests(
        prefix="s", temp=0.8))).items() if u.startswith("s")}

    e = engine()
    reqs = serve_requests()
    for r in reqs[:3]:
        e.submit(r)
    e.step()
    e.fold_tp(1)
    out["folded"] = {"parked": e.parked, "model": e.model is not None,
                     "physical": e.tp.physical_tp,
                     "kv_bytes": e.kv_device_bytes()}
    e.drain()
    for r in reqs[3:]:
        e.submit(r)
    e.step()
    e.fold_tp(n)
    out["unfolded"] = {"parked": e.parked, "physical": e.tp.physical_tp,
                       "local_kv_heads": int(e.cache[0].shape[-2])}
    out["fold_streams"] = _streams(e.drain())

    # Disaggregated at tp=n: pages of a prefill engine's rank carry its
    # KV heads into the same rank's decode engine.
    pre = ServingEngine(cfg, state, tp=n, slots=SERVE_SLOTS,
                        buckets=SERVE_BUCKETS, seed=0, device="cpu",
                        role="prefill")
    dec = ServingEngine(cfg, state, tp=n, slots=SERVE_SLOTS,
                        buckets=SERVE_BUCKETS, seed=0, device="cpu",
                        role="decode")
    reqs = serve_requests(prefix="d")
    for r in reqs:
        pre.submit(r)
    while pre._queue:
        pre.step()
    out["page_heads"] = sorted({int(p.row[0].shape[-2])
                                for p in pre.outbox})
    out["page_bytes"] = [p.nbytes for p in pre.outbox]
    while pre.outbox:
        dec.insert_page(pre.outbox.popleft())
    out["page_streams"] = _streams(dec.drain())
    if payload.get("swap_dir"):
        out.update(serve_tp_swap(rank, engine(), payload["swap_dir"]))
    return out


def serve_tp_swap(rank, e, swap_dir):
    """A live swap at tp=2 from the checkpoint in ``swap_dir``: the
    report, the streams after it; then a swap under a ``serve.swap`` plan
    on rank 1 alone (its landed slices flipped), which every rank rolls
    back."""
    from dlrover_tpu_torch.common import faults

    out = {}
    e.submit(serve_requests(prefix="v")[0])
    e.step()
    report = e.swap_weights(swap_dir)
    keys = ("ok", "rolled_back", "version", "step", "digest")
    out["swap"] = {k: report[k] for k in keys}
    out["swap_streams"] = {u: v for u, v in _streams(e.run(serve_requests(
        prefix="w"))).items() if u.startswith(("v", "w"))}
    if rank == 1:
        faults.configure("serve.swap:error@1", seed=0)
    try:
        report = e.swap_weights(swap_dir)
    finally:
        faults.reset()
    out["swap_fault"] = {k: report[k] for k in keys}
    out["params_after"] = {k: v.numpy().copy()
                           for k, v in e.model.state_dict().items()}
    return out


# -- the expert axis ---------------------------------------------------------------

#: A tiny GPT-2 MoE: 4 experts top-2 of d_ff 64 in each of its 2 layers.
MOE = dict(num_layers=2, d_model=64, num_heads=4, vocab_size=128,
           max_seq_len=64, num_experts=4, top_k=2, d_ff=64)
#: The MoE layer cases: d_model, experts, d_ff, batch, sequence.
LAYER = dict(d=16, e=4, f=32, b=8, s=16)


def moe_config(dispatch):
    from dlrover_tpu_torch.models import gpt2_config

    return gpt2_config("124m", **MOE, moe_dispatch=dispatch,
                       dtype=torch.float32)


def expert_group(n, data=1):
    """The ``ExpertGroup`` of this rank on a ``data x expert`` mesh of
    the world's ``n`` processes."""
    from dlrover_tpu_torch.parallel import rules as lr
    from dlrover_tpu_torch.parallel.sharding import ModelParallel
    from dlrover_tpu_torch.runtime.mesh import (
        ParallelConfig,
        axis_wires,
        build_mesh,
    )

    mesh = build_mesh(ParallelConfig(data=data, expert=n // data),
                      device_type="cpu")
    return ModelParallel(mesh, lr.DEFAULT_RULES,
                         axis_wires(mesh)).expert_group()


def a2a_case_inputs(case, n):
    """A collective case's member inputs ``[n, *shape]`` and cotangents
    (``[n, *output shape]``), fp32 numpy (bf16 cases rounded to bf16),
    each member's at its own scale."""
    cid, _, shape, dtype, split, concat = case
    out_shape = list(shape)
    out_shape[split] //= n
    out_shape[concat] *= n
    rng = np.random.default_rng(sum(map(ord, cid)) + n)
    x, g = (rng.normal(size=(n,) + tuple(s)).astype(np.float32)
            * np.exp(rng.uniform(-3, 2, size=(n,) + (1,) * len(s))
                     ).astype(np.float32) for s in (shape, out_shape))
    if dtype == "bfloat16":
        x, g = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                for a in (x, g))
    return x, g


def run_ep_a2a(rank, n, cases):
    """The all-to-all cases ``(id, quant, shape, dtype, split, concat)``:
    each rank's output and its input's gradient for the cotangent."""
    from dlrover_tpu_torch.parallel import quantized_collectives as qc
    from dlrover_tpu_torch.parallel.wire import Wire

    wire = Wire(axis="expert")
    out = {}
    for case in cases:
        cid, quant, _, dtype, split, concat = case
        xs, gs = a2a_case_inputs(case, n)
        x = torch.from_numpy(xs[rank]).to(getattr(torch, dtype))
        x.requires_grad_(True)
        fn = qc.quantized_all_to_all if quant else qc.all_to_all
        y = fn(x, wire, split_axis=split, concat_axis=concat)
        (y.float() * torch.from_numpy(gs[rank])).sum().backward()
        out[cid] = (str(y.dtype), y.detach().float().numpy(),
                    x.grad.float().numpy())
    return out


def run_ep_layers(rank, n, payload):
    """The MoE layer cases ``(key, dispatch, world)`` of this world: the
    layer on this rank's rows with its experts, ``loss = sum(out * cot) +
    aux``; returns its rows' output, the aux loss, the gradients of its
    rows, the router and its experts, and the router statistics."""
    from dlrover_tpu_torch.models import moe

    c = LAYER
    whole = {k: torch.from_numpy(v) for k, v in payload["params"].items()}
    x_all = torch.from_numpy(payload["x"])
    cot_all = torch.from_numpy(payload["cot"])
    out = {}
    for key, dispatch, world in payload["cases"]:
        if world != n:
            continue
        group = expert_group(n)
        layer = moe.MoEMlp(c["d"], c["e"], c["f"], top_k=2,
                           activation="gelu", dtype=torch.float32,
                           dispatch=dispatch, group=group, device="cpu")
        local = c["e"] // n
        experts = slice(rank * local, (rank + 1) * local)
        layer.load_state_dict({"router.kernel": whole["router.kernel"],
                               "wi": whole["wi"][experts].clone(),
                               "wo": whole["wo"][experts].clone()})
        rows = slice(rank * c["b"] // n, (rank + 1) * c["b"] // n)
        x = x_all[rows].clone().requires_grad_(True)
        y, aux = layer(x)
        ((y * cot_all[rows]).sum() + aux).backward()
        with torch.no_grad(), moe.collect_router_stats() as stats:
            layer(x)
        out[key] = {"out": y.detach().numpy(), "aux": aux.item(),
                    "dx": x.grad.numpy(),
                    "grads": {k: p.grad.numpy().copy()
                              for k, p in layer.named_parameters()},
                    "stats": stats[0].numpy()}
    return out


def run_ep_cases(rank, n, payload):
    """One world for the expert axis's cases: the all-to-alls, the MoE
    layers, then the train cases and saves of :func:`run_mp_cases`."""
    out = {"a2a": run_ep_a2a(rank, n, payload["a2a"]),
           "layers": run_ep_layers(rank, n, payload["layers"])}
    out.update(run_mp_cases(rank, n, payload))
    return out


# -- Local SGD ------------------------------------------------------------------------

LSGD_SHAPES = {"w": (8, 40), "b": (40,), "v": (3, 5, 7)}


def lsgd_params():
    """The replicas' common starting tree (fp32 numpy)."""
    rng = np.random.default_rng(11)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in LSGD_SHAPES.items()}


def lsgd_step(rank, step):
    """Replica ``rank``'s local move at ``step`` (fp32 numpy): a shared
    drift plus its own noise, so signs agree on some values and not
    others."""
    shared = np.random.default_rng(1000 + step)
    own = np.random.default_rng(2000 + 100 * rank + step)
    return {k: (0.01 * shared.standard_normal(s)
                + 0.02 * own.standard_normal(s)).astype(np.float32)
            for k, s in LSGD_SHAPES.items()}


def run_local_sgd(rank, n, payload):
    """Each ``(key, config kwargs, steps)`` of ``payload["cases"]``: a
    ``LocalSGD`` on the world's wire moves this replica by
    :func:`lsgd_step` each step; per sync the parameters, this rank's
    delta and the wire bytes.  Then the state round trip: a second
    ``LocalSGD`` loaded from the first's ``state_dict`` mid-round must
    continue identically."""
    from dlrover_tpu_torch.parallel import local_sgd as ls
    from dlrover_tpu_torch.parallel import wire as wire_lib

    out = {}
    for key, kw, steps in payload["cases"]:
        outer = ls.LocalSGD(ls.LocalSGDConfig(**kw))
        params = {k: torch.from_numpy(v) for k, v in lsgd_params().items()}
        outer.init(params)
        syncs = []
        saved = None
        for step in range(steps):
            move = lsgd_step(rank, step)
            params = {k: p + torch.from_numpy(move[k])
                      for k, p in params.items()}
            delta = {k: (params[k] - outer._anchor[k]).numpy().copy()
                     for k in params}
            wire_lib.reset_counts()
            params, synced = outer.maybe_sync(params)
            if synced:
                syncs.append({
                    "params": {k: v.numpy().copy()
                               for k, v in params.items()},
                    "delta": delta,
                    "bytes": dict(wire_lib.COUNTS["bytes"])})
            if step == 0:
                saved = (outer.state_dict(), {k: v.clone()
                                              for k, v in params.items()})
        # Continue a copy from the state after step 0.
        state, p = saved
        again = ls.LocalSGD(ls.LocalSGDConfig(**kw))
        again.load_state_dict(state)
        for step in range(1, steps):
            move = lsgd_step(rank, step)
            p = {k: v + torch.from_numpy(move[k]) for k, v in p.items()}
            p, _ = again.maybe_sync(p)
        out[key] = {"syncs": syncs, "resumed": {k: v.numpy().copy()
                                                for k, v in p.items()},
                    "final": {k: v.numpy().copy() for k, v in params.items()}}
    return out

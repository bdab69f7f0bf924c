"""Port parity: the data-parallel world's pure parts (``dlrover_tpu_torch.
runtime.mesh``, ``parallel.rules``, ``optimizers.zero1``,
``parallel.overlap``, ``runtime.virtual_mesh`` and
``train_lib.microbatch_phase_plan``) against the JAX package, on tables of
cases.  Everything here is exact: the same integers, names and specs.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from dlrover_tpu.optimizers import zero1 as jz1
from dlrover_tpu.parallel import overlap as jov
from dlrover_tpu.parallel import quantized_collectives as jqc
from dlrover_tpu.parallel import rules as jrules
from dlrover_tpu.runtime import mesh as jmesh
from dlrover_tpu.runtime import virtual_mesh as jvm
from dlrover_tpu.trainer import train_lib as jtl
from dlrover_tpu_torch.optimizers import zero1 as tz1
from dlrover_tpu_torch.parallel import overlap as tov
from dlrover_tpu_torch.parallel import quantized_collectives as tqc
from dlrover_tpu_torch.parallel import rules as trules
from dlrover_tpu_torch.runtime import mesh as tmesh
from dlrover_tpu_torch.runtime import virtual_mesh as tvm
from dlrover_tpu_torch.trainer import train_lib as ttl

CONFIGS = [
    dict(), dict(data=2), dict(data=4, fsdp=2), dict(data=-1, tensor=2),
    dict(data=-1, pipe=2, expert=2), dict(data=1, seq=2, tensor=4),
    dict(data=2, dcn_data=2), dict(data=3),
]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_parallel_config_sizes_match(kw, devices):
    j, t = jmesh.ParallelConfig(**kw), tmesh.ParallelConfig(**kw)
    assert j.model_parallel_degree == t.model_parallel_degree
    try:
        want = j.sizes(devices)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            t.sizes(devices)
        return
    assert t.sizes(devices) == want


def test_axis_names_and_order_match():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    for name in ("DATA_AXIS", "FSDP_AXIS", "PIPE_AXIS", "EXPERT_AXIS",
                 "SEQ_AXIS", "TENSOR_AXIS"):
        assert getattr(tmesh, name) == getattr(jmesh, name)


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12, 30, 64, 97])
@pytest.mark.parametrize("priority", [
    ("tensor", "pipe", "data"), ("data",), ("fsdp", "data"),
    ("expert", "tensor", "seq", "data")])
def test_factor_devices_matches(n, priority):
    assert tmesh.factor_devices(n, priority) == jmesh.factor_devices(
        n, priority)


@pytest.mark.parametrize("name", ["DEFAULT_RULES", "DDP_RULES",
                                  "RING_RULES"])
def test_rule_tables_equal_the_references(name):
    assert getattr(trules, name) == getattr(jrules, name)


@pytest.mark.parametrize("kw", [
    dict(fsdp=False), dict(tensor=False), dict(sequence=False),
    dict(expert=False), dict(pipeline=False), dict(context="ring"),
    dict(tensor=False, sequence=False), dict(context="ring", tensor=False),
])
def test_make_rules_matches(kw):
    assert trules.make_rules(**kw) == jrules.make_rules(**kw)


def test_logical_names_match():
    for name in ("BATCH", "ACT_SEQ", "ACT_HEADS", "ACT_EMBED", "EMBED",
                 "MLP", "HEADS", "KV", "VOCAB", "EXPERT", "LAYERS",
                 "STAGES", "NORM", "GATHERED"):
        assert getattr(trules, name) == getattr(jrules, name)


@pytest.mark.parametrize("kw", [dict(data=2), dict(data=4), dict(data=8),
                                dict(data=1)])
def test_batch_rule_resolves_to_the_data_group(kw):
    """At fsdp = tensor = seq = 1 the default table is data parallelism:
    the batch splits over the data axis only, as many ways as the
    reference's batch sharding."""
    devices = jax.devices()[:kw["data"]]
    jm = jmesh.build_mesh(jmesh.ParallelConfig(**kw), devices=devices)
    spec = jtl.logical_sharding(jm, jrules.DEFAULT_RULES, jrules.BATCH).spec
    want = jtl._batch_shard_count(jm, spec[0] if spec else None)
    sizes = tmesh.ParallelConfig(**kw).sizes(kw["data"])

    class Mesh:
        mesh_dim_names = tmesh.MESH_AXES
        shape = tuple(sizes[a] for a in tmesh.MESH_AXES)

    assert trules.batch_shard_count(Mesh, trules.DEFAULT_RULES) == want
    assert trules.batch_group_axes(Mesh, trules.DEFAULT_RULES) == (
        ("data",) if kw["data"] > 1 else ())
    assert trules.batch_axes(trules.DEFAULT_RULES) == ("data", "fsdp")


@pytest.mark.parametrize("axis,item", [("seq", 9), ("pipe", 9),
                                       ("expert", 6)])
def test_model_parallel_axes_are_refused_with_their_item(axis, item):
    """The seq and pipe axes (ROADMAP Queue 1 item 9) and the expert axis
    (item 6) are taken by the mesh; what is still refused beside them,
    with their items, is the overlap engine and the int8 wires."""

    class Mesh:  # what build_mesh would give on two devices
        mesh_dim_names = tmesh.MESH_AXES
        shape = tuple(2 if a == axis else 1 for a in tmesh.MESH_AXES)

    from dlrover_tpu_torch.models import gpt2_config

    cfg = gpt2_config("124m", num_layers=1, d_model=32, num_heads=2,
                      vocab_size=64, max_seq_len=16)
    tmesh.check_axes({"data": 1, axis: 2})
    options = dict(zero1=True, overlap=True)
    with pytest.raises(NotImplementedError, match=f"item.* {item}"):
        ttl.build_train(cfg, ttl.make_optimizer("sgd"), global_batch_size=4,
                        seq_len=8, mesh=Mesh, device="cpu", **options)


def test_single_device_mesh_is_world_one():
    mesh = tmesh.build_mesh(tmesh.ParallelConfig(), device_type="cpu")
    assert isinstance(mesh, tmesh.SingleDeviceMesh)
    assert tmesh.mesh_axis_sizes(mesh) == dict.fromkeys(tmesh.MESH_AXES, 1)
    assert tmesh.data_group(mesh) is None
    assert tmesh.mesh_axis_size(mesh, "data") == 1
    assert tmesh.mesh_axis_size(None, "data") == 1
    topo = tmesh.slice_topology()
    assert (topo["num_devices"], topo["num_hosts"], topo["host_index"]) == (
        1, 1, 0)
    with pytest.raises(ValueError, match="devices"):
        tmesh.build_mesh(tmesh.ParallelConfig(data=2), device_type="cpu")


# -- ZeRO-1 specs ------------------------------------------------------------------

SPEC_CASES = [
    ((48, 1600), (), {"data": 2}),
    ((48, 1600), (), {"data": 4}),
    ((1600,), (), {"data": 2}),
    ((1601,), (), {"data": 2}),
    ((3, 1600), (), {"data": 2}),
    ((50304, 1600), ("tensor", "fsdp"), {"data": 2, "tensor": 1,
                                         "fsdp": 1}),
    ((8, 64), ("fsdp",), {"data": 2, "fsdp": 2}),
    ((8, 64), ("fsdp",), {"data": 4, "fsdp": 4}),
    ((6, 10), (None, "tensor"), {"data": 2, "tensor": 5}),
    ((4, 6), ("data",), {"data": 2}),
    ((4, 6), (("fsdp", "data"),), {"data": 2, "fsdp": 1}),
    ((), (), {"data": 2}),
    ((5, 7), (), {"data": 2}),
    ((2, 3, 64), (None, None, "tensor"), {"data": 2, "tensor": 2}),
    ((48, 25, 192), (None, "tensor", None), {"data": 8, "tensor": 1}),
    ((16,), (), {"data": 1}),
]


def _jspec(spec):
    return PartitionSpec(*spec)


def _tspec(jspec):
    return None if jspec is None else tuple(jspec)


@pytest.mark.parametrize("shape,spec,sizes", SPEC_CASES)
def test_zero1_partition_spec_and_data_axis_dim_match(shape, spec, sizes):
    want = jz1.zero1_partition_spec(shape, _jspec(spec), sizes)
    got = tz1.zero1_partition_spec(shape, spec, sizes)
    assert got == _tspec(want)
    assert tz1.data_axis_dim(got) == (
        jz1.data_axis_dim(want) if want is not None else None)
    assert tz1._dim_shard_total(sizes, spec) == jz1._dim_shard_total(
        sizes, _jspec(spec))


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_shard_update_shardings_stats_match(dp):
    """The same stats keys and numbers as the reference's over a tree of
    leaves on a ``data``-``dp`` mesh (specs replicated, as the default
    rules give at fsdp = tensor = 1)."""
    shapes = {"a": (48, 1600), "b": (1600,), "c": (3, 5), "d": (),
              "e": (dp * 3, 7), "f": (1601, 8)}
    jm = jmesh.build_mesh(jmesh.ParallelConfig(data=dp),
                          devices=jax.devices()[:dp])
    abstract = {k: jax.ShapeDtypeStruct(s, np.float32)
                for k, s in shapes.items()}
    shardings = {k: NamedSharding(jm, PartitionSpec()) for k in shapes}
    jnew, jstats = jz1.shard_update_shardings(jm, abstract, shardings)
    tnew, tstats = tz1.shard_update_shardings(
        {"data": dp}, {k: (s, 4) for k, s in shapes.items()},
        {k: () for k in shapes})
    assert tstats == jstats
    for k in shapes:
        assert tnew[k] == tuple(jnew[k].spec)


@pytest.mark.parametrize("dp,block", [(2, 0), (4, 0), (2, 256), (4, 256)])
def test_shard_plan_slices_cover_each_leaf_once(dp, block):
    shapes = {"blocks.w": (2, 64, 256), "blocks.b": (2, 64), "wte": (128, 64),
              "ln": (64,), "odd": (3, 5)}
    plan = tz1.ShardPlan(shapes, dp, block=block)
    for name, shape in shapes.items():
        leaf = plan[name]
        want = tz1.data_axis_dim(tz1.zero1_partition_spec(shape, (),
                                                          {"data": dp}))
        if block and want is not None and not plan._aligned(shape, want):
            want = None
        assert leaf.dim == want
        t = torch.arange(int(np.prod(shape))).reshape(shape)
        seen = torch.zeros(shape, dtype=torch.int64)
        for r in range(dp):
            piece = leaf.take(t, r)
            assert tuple(piece.shape) == leaf.local_shape()
            idx = tuple(slice(b, e) for b, e in leaf.index(r))
            assert torch.equal(piece, t[idx])
            seen[idx] += 1
        assert bool((seen == (1 if leaf.dim is not None else dp)).all())
    if block:
        for leaf in plan.leaves.values():
            if leaf.dim is None:
                continue
            assert leaf.dim == 0 or all(d == 1 for d in leaf.shape[
                :leaf.dim])
            assert int(np.prod(leaf.local_shape())) % block == 0


# -- overlap plan --------------------------------------------------------------------

BUCKET_TREES = [
    [(48, 1600), (1600,), (50304, 1600), (1024, 1600), (48, 6400)],
    [(10,)] * 40,
    [(1000, 1000), (3,), (999, 1001), (7, 7)],
    [],
]


@pytest.mark.parametrize("shapes", BUCKET_TREES)
@pytest.mark.parametrize("bucket_mb", [0.0, -1.0, 0.0005, 1.0, 4.0, 1e4])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_plan_buckets_matches(shapes, bucket_mb, dtype_bytes):
    tree = {f"l{i:02d}": np.zeros(s, np.float32)
            for i, s in enumerate(shapes)}
    want = jov.plan_buckets(tree, bucket_mb, dtype_bytes=dtype_bytes)
    got = tov.plan_buckets(list(tree.values()), bucket_mb,
                           dtype_bytes=dtype_bytes)
    assert got.buckets == want.buckets
    assert got.bucket_bytes == want.bucket_bytes
    assert got.describe() == want.describe()
    assert (got.num_buckets, got.num_leaves) == (want.num_buckets,
                                                 want.num_leaves)
    # Shapes and element counts plan the same buckets as the arrays.
    assert tov.plan_buckets(shapes, bucket_mb, dtype_bytes=dtype_bytes
                            ).buckets == want.buckets


def test_bucket_issuer_issues_in_plan_order():
    """Hooks fire in any order; buckets go out in plan order, each once
    its leaves are whole, and ``finish`` sends the rest."""
    plan = tov.plan_buckets([1, 1, 1, 1, 1], 4e-6, dtype_bytes=1)
    assert plan.buckets == ((0, 1, 2, 3), (4,))
    plan = tov.OverlapPlan(((0, 1), (2,), (3, 4)), (2, 1, 2), 0.0, 5)
    sent = []
    issuer = tov.BucketIssuer(plan, [2, 1, 1, 1, 3],
                              lambda b, leaves: sent.append(b) or b)
    issuer.ready(2)           # bucket 1 whole, but bucket 0 is not
    issuer.ready(0)
    assert sent == []
    issuer.ready(1)           # leaf 0 has a second part
    assert sent == []
    issuer.ready(0)           # bucket 0 whole: buckets 0 and 1 go out
    assert sent == [0, 1] and issuer.early == 2
    issuer.ready(4)
    assert issuer.finish() == [0, 1, 2] and sent == [0, 1, 2]
    with pytest.raises(ValueError, match="rebuild the plan"):
        tov.BucketIssuer(plan, [1, 1], lambda b, l: None)


# -- collectives' pure parts -------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("payload", [0, 1000, 1 << 20, 1 << 24])
@pytest.mark.parametrize("dcn", [False, True])
def test_select_reduce_algo_matches(n, payload, dcn):
    assert tqc.select_reduce_algo(n, payload, dcn) == \
        jqc.select_reduce_algo(n, payload, dcn)
    assert tqc.RING_MIN_BYTES == jqc.RING_MIN_BYTES


# -- virtual mesh ---------------------------------------------------------------------


@pytest.mark.parametrize("logical,physical,new", [
    (4, 4, 2), (4, 2, 1), (4, 1, 4), (4, 4, 8), (3, 2, 3), (8, 3, 5),
    (1, 1, 1)])
def test_virtual_mesh_resize_accounting_matches(logical, physical, new):
    fake = type("M", (), {"devices": np.zeros((1,) * 6)})()
    j = jvm.VirtualMesh(fake, logical_world=logical,
                        physical_world=physical)
    t = tvm.VirtualMesh((1,) * 6, logical_world=logical,
                        physical_world=physical)
    assert t.fold == j.fold
    assert [t.owner(s) for s in range(logical)] == [
        j.owner(s) for s in range(logical)]
    for rank in range(max(physical, new) + 1):
        assert t.owned_shards(rank) == j.owned_shards(rank)
    assert t.with_world(new).physical_world == j.with_world(
        new).physical_world
    assert t.relayout_plan(new) == j.relayout_plan(new)


def test_shard_rng_is_keyed_by_the_logical_shard():
    t = tvm.VirtualMesh((1,), logical_world=4, physical_world=4)
    draws = {s: torch.rand(3, generator=t.shard_rng(7, s))
             for s in range(4)}
    folded = t.with_world(1)
    for s in range(4):
        again = torch.rand(3, generator=folded.shard_rng(7, s))
        assert torch.equal(again, draws[s])  # hosted anywhere: one stream
        assert torch.equal(torch.rand(3, generator=t.shard_rng(7, s + 4)),
                           draws[s])
    assert not torch.equal(draws[0], draws[1])


@pytest.mark.parametrize("accum", [1, 2, 4])
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("zero1,overlap", [(False, False), (True, False),
                                           (True, True)])
def test_microbatch_phase_plan_matches(accum, quant, zero1, overlap):
    want = jtl.microbatch_phase_plan(accum, quant, 0.731, zero1=zero1,
                                     overlap=overlap)
    got = ttl.microbatch_phase_plan(accum, quant, 0.731, zero1=zero1,
                                    overlap=overlap)
    assert got == want

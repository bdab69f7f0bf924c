"""Port parity: the data tier (``dlrover_tpu_torch.data``,
``master/messages.py``) against ``dlrover_tpu.data``.

The same inputs through both packages, compared exactly: the sampler's
index streams across rank, world, resume and grow cases
(``tests/test_data.py``), the loader's batches and shard-ack sequences
(one fake master drives both packages' clients), the prefetcher's order,
re-iteration, ack-after-consume and generation token
(``tests/test_step_pipeline.py``), and the text-shard reader's lines and
index file.  The CUDA-stream copy of the prefetcher runs on the card
(``chip_smoke.py``'s ``train_fit``); here it places on the CPU, where
``place_fn`` runs inline.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dlrover_tpu.data import loader as jloader
from dlrover_tpu.data import sharding_client as jsc
from dlrover_tpu.data import text_shards as jts
from dlrover_tpu.master import messages as jmsg
from dlrover_tpu_torch.data import loader as tloader
from dlrover_tpu_torch.data import sharding_client as tsc
from dlrover_tpu_torch.data import text_shards as tts
from dlrover_tpu_torch.master import messages as tmsg
from dlrover_tpu_torch.models import gpt2_config
from dlrover_tpu_torch.trainer import train_lib as ttl
from dlrover_tpu_torch.utils.profiler import pipeline_counters


# -- the sampler -------------------------------------------------------------


def _both_samplers(*args, **kwargs):
    return (jloader.ElasticDistributedSampler(*args, **kwargs),
            tloader.ElasticDistributedSampler(*args, **kwargs))


def _same_stream(j, t):
    assert list(t) == list(j)
    assert len(t) == len(j)
    assert t.state_dict() == j.state_dict()
    assert t.owned_logical_shards() == j.owned_logical_shards()


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("rank", range(4))
def test_sampler_rank_partition_matches(rank, shuffle):
    _same_stream(*_both_samplers(100, num_replicas=4, rank=rank,
                                 shuffle=shuffle, seed=3))


@pytest.mark.parametrize("completed", [4, 7, 11])
def test_sampler_resume_skew_matches(completed):
    for rank in range(3):
        j, t = _both_samplers(29, num_replicas=3, rank=rank, shuffle=True,
                              seed=7)
        for s in (j, t):
            s.load_state_dict({"epoch": 0, "completed": completed})
        _same_stream(j, t)


def test_sampler_record_batch_and_epoch_match():
    j, t = _both_samplers(64, num_replicas=2, rank=1, shuffle=True)
    for s in (j, t):
        s.record_batch(16)
    _same_stream(j, t)
    for s in (j, t):
        s.set_epoch(3)
    _same_stream(j, t)


@pytest.mark.parametrize("rank", range(2))
def test_sampler_logical_fold_matches(rank):
    _same_stream(*_both_samplers(48, num_replicas=2, rank=rank, shuffle=True,
                                 seed=5, logical_world=4))


def test_sampler_grow_resume_2_to_4_matches():
    """Consume under a folded 2-member world (L=4), rebind to 4 members:
    the same continuation in both packages, rank by rank."""
    for rank in range(2):
        j, t = _both_samplers(48, num_replicas=2, rank=rank, shuffle=True,
                              seed=9, logical_world=4)
        for s in (j, t):
            s.record_batch(16)
            s.rebind_world(rank=rank, num_replicas=4)
        _same_stream(j, t)
    # A legacy sampler (no logical world) freezes it on the first rebind.
    j, t = _both_samplers(30, num_replicas=3, rank=2, shuffle=False)
    for s in (j, t):
        s.rebind_world(num_replicas=2)
    assert (t.logical_world, t.rank) == (j.logical_world, j.rank) == (3, 0)
    _same_stream(j, t)


# -- the loader ----------------------------------------------------------------


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_match(prefetch, drop_last):
    def make(mod):
        return mod.ElasticDataLoader(
            mod.synthetic_lm_sample_fn(vocab_size=50, seq_len=16, seed=2),
            batch_size=4, source=range(10), prefetch=prefetch,
            drop_last=drop_last)

    _batches_equal(list(make(tloader)), list(make(jloader)))


def test_loader_over_a_sampler_and_unbounded_match():
    def sampled(mod):
        sampler = mod.ElasticDistributedSampler(40, num_replicas=2, rank=1,
                                                shuffle=True, seed=4)
        return list(mod.ElasticDataLoader(
            mod.synthetic_lm_sample_fn(64, 8), batch_size=5, source=sampler))

    _batches_equal(sampled(tloader), sampled(jloader))

    def unbounded(mod):
        it = iter(mod.ElasticDataLoader(mod.synthetic_lm_sample_fn(64, 8),
                                        batch_size=3))
        out = [next(it) for _ in range(4)]
        it.close()
        return out

    _batches_equal(unbounded(tloader), unbounded(jloader))


class _FakeTaskMaster:
    """A master double serving fixed-size shard tasks of either package's
    ``ShardTask`` and recording every call, in order."""

    def __init__(self, task_cls, num_shards, shard_size, indices=False):
        self.tasks = [
            task_cls(task_id=i, dataset_name="d", start=i * shard_size,
                     end=(i + 1) * shard_size,
                     record_indices=(list(range((i + 1) * shard_size - 1,
                                                i * shard_size - 1, -1))
                                     if indices else None))
            for i in range(num_shards)
        ]
        self.task_cls = task_cls
        self.calls = []

    def create_dataset(self, params):
        self.calls.append(("create", dataclasses.asdict(params)))

    def get_task(self, name):
        self.calls.append(("get", name))
        if self.tasks:
            return self.tasks.pop(0)
        return self.task_cls()

    def report_task(self, name, task_id, success):
        self.calls.append(("done", name, task_id, success))


def test_messages_match_the_reference():
    for name in ("DatasetShardParams", "ShardTask"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jmsg, name))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tmsg, name))]
        assert tf == jf
    assert tmsg.ShardTask().empty and not tmsg.ShardTask(task_id=0).empty


@pytest.mark.parametrize("indices", [False, True])
def test_task_sample_indices_match(indices):
    for jt, tt in zip(_FakeTaskMaster(jmsg.ShardTask, 3, 5, indices).tasks,
                      _FakeTaskMaster(tmsg.ShardTask, 3, 5, indices).tasks):
        assert list(tsc.task_sample_indices(tt)) == list(
            jsc.task_sample_indices(jt))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("indices", [False, True])
def test_loader_ack_sequence_matches(prefetch, indices):
    """One fake master per package, the same consumption pattern: the same
    calls in the same order, and no shard acked before its batch was
    consumed."""
    runs = []
    for sc, msg, mod in ((jsc, jmsg, jloader), (tsc, tmsg, tloader)):
        fake = _FakeTaskMaster(msg.ShardTask, 4, 8, indices)
        client = sc.ShardingClient(fake, "d", dataset_size=32, shard_size=8)
        loader = mod.ElasticDataLoader(lambda i: {"x": np.asarray([i])},
                                       batch_size=8, source=client,
                                       prefetch=prefetch)
        it = iter(loader)
        seen = [next(it)["x"].ravel().tolist()]
        acked_early = [c for c in fake.calls if c[0] == "done"]
        seen.append(next(it)["x"].ravel().tolist())
        seen += [b["x"].ravel().tolist() for b in it]
        runs.append((fake.calls, seen, acked_early))
    (jcalls, jseen, jearly), (tcalls, tseen, tearly) = runs
    assert tseen == jseen
    assert tearly == jearly == []
    if prefetch == 0:
        # Unthreaded: get/done interleave the same way in both packages.
        assert tcalls == jcalls
    else:
        # The producer thread's fetches race the consumer's acks, so the
        # interleaving may differ; each kind keeps one order.
        for kind in ("create", "get", "done"):
            assert [c for c in tcalls if c[0] == kind] == [
                c for c in jcalls if c[0] == kind]


def test_index_sharding_client_matches():
    runs = []
    for sc, msg in ((jsc, jmsg), (tsc, tmsg)):
        fake = _FakeTaskMaster(msg.ShardTask, 3, 4)
        client = sc.IndexShardingClient(fake, "d", create=False)
        got = []
        for batch in (3, 3, 4, 2):
            got.append([client.fetch_sample_index() for _ in range(batch)])
            client.report_batch_done(batch)
        got.append(client.fetch_sample_index())
        runs.append((got, fake.calls))
        assert list(sc.ShardingClient(_FakeTaskMaster(msg.ShardTask, 2, 3),
                                      "d", create=False).shard_indices()) \
            == list(range(6))
    assert runs[1] == runs[0]


# -- the device prefetcher (on the CPU: place_fn inline) ----------------------


def test_prefetcher_preserves_order_and_places_ahead():
    for mod in (jloader, tloader):
        placed = []

        def place(batch):
            placed.append(batch["i"])
            return batch

        pf = mod.DevicePrefetcher([{"i": i} for i in range(6)], place,
                                  depth=2)
        at_yield, got = [], []
        for batch in pf:
            at_yield.append(len(placed))
            got.append(batch["i"])
        assert got == placed == list(range(6))
        assert at_yield == [3, 4, 5, 6, 6, 6]


def test_prefetcher_reiterable_and_clean_shutdown():
    src = [{"i": i} for i in range(5)]
    pf = tloader.DevicePrefetcher(src, lambda b: b, depth=3, device="cpu")
    first = []
    for batch in pf:
        first.append(batch["i"])
        if batch["i"] == 1:
            break
    assert first == [0, 1]
    assert pf._buf is None
    assert [b["i"] for b in pf] == [0, 1, 2, 3, 4]


def test_prefetcher_ack_only_after_consume_matches():
    for sc, msg, mod in ((jsc, jmsg, jloader), (tsc, tmsg, tloader)):
        fake = _FakeTaskMaster(msg.ShardTask, 4, 8)
        loader = mod.ElasticDataLoader(
            lambda i: {"x": np.asarray([i])}, batch_size=8,
            source=sc.ShardingClient(fake, "d", create=False), prefetch=2)
        it = iter(mod.DevicePrefetcher(loader, lambda b: b, depth=2))
        next(it)
        assert [c for c in fake.calls if c[0] == "done"] == []
        next(it)
        assert [c[2] for c in fake.calls if c[0] == "done"] == [0]
        it.close()
        assert [c[2] for c in fake.calls if c[0] == "done"] == [0]


def test_prefetcher_drain_replaces_buffered_host_batches():
    placed = []

    def place(batch):
        placed.append(batch["i"])
        return dict(batch, gen=len(placed))

    pf = tloader.DevicePrefetcher([{"i": i} for i in range(5)], place,
                                  depth=2)
    it = iter(pf)
    assert next(it)["i"] == 0
    assert len(pf.device_buffers()) == 2
    assert pf.drain() == 2
    rest = [b["i"] for b in it]
    assert rest == [1, 2, 3, 4]
    # Batches 1 and 2 were placed twice: before and after the drain.
    assert placed == [0, 1, 2, 1, 2, 3, 4]
    assert pf.drain() == 0


def test_threaded_loader_generation_token_reiteration():
    loader = tloader.ElasticDataLoader(
        lambda i: {"x": np.asarray([i])}, batch_size=4,
        source=list(range(16)), prefetch=2)
    it = iter(loader)
    assert list(next(it)["x"].reshape(-1)) == [0, 1, 2, 3]
    it.close()
    assert loader._generation == 1
    batches = list(loader)
    assert loader._generation == 2
    assert [int(v) for b in batches for v in b["x"].reshape(-1)] == list(
        range(16))


def _tiny_train():
    cfg = gpt2_config("124m", num_layers=1, d_model=32, num_heads=2,
                      vocab_size=64, max_seq_len=8)
    return ttl.build_train(cfg, ttl.make_optimizer("adamw"),
                           global_batch_size=2, seq_len=8, device="cpu")


def test_shard_batch_places_in_the_steps_dtypes_and_passes_through():
    train = _tiny_train()
    host = {"inputs": np.arange(16, dtype=np.int32).reshape(2, 8),
            "targets": np.ones((2, 8), np.int32)}
    counters = pipeline_counters()
    counters.reset()
    placed = ttl.shard_batch(host, train)
    assert {k: v.dtype for k, v in placed.items()} == {
        "inputs": torch.int64, "targets": torch.int64,
        "weights": torch.float32}
    np.testing.assert_array_equal(placed["inputs"].numpy(), host["inputs"])
    assert placed["weights"].eq(1).all()
    again = ttl.shard_batch(placed, train)
    assert all(again[k] is placed[k] for k in placed)
    assert counters.summary()["place_count"] == 1
    # What Train._batch makes of a placed batch is the batch itself.
    inputs, targets, weights = train._batch(placed)
    assert inputs is placed["inputs"] and weights is placed["weights"]


def test_prefetched_fit_batches_equal_the_host_batches():
    """Through the prefetcher and ``shard_batch`` on the CPU: the batches
    the step is handed equal the loader's host batches bit for bit."""
    train = _tiny_train()
    loader = tloader.ElasticDataLoader(
        tloader.synthetic_lm_sample_fn(64, 8, seed=1), batch_size=2,
        source=range(12))
    host = list(loader)
    pf = tloader.DevicePrefetcher(
        loader, lambda b: ttl.shard_batch(b, train), depth=2, device="cpu")
    got = list(pf)
    assert len(got) == len(host) == 6
    for g, h in zip(got, host):
        for k in ("inputs", "targets"):
            assert g[k].dtype == torch.int64
            np.testing.assert_array_equal(g[k].numpy(), h[k])


# -- the text-shard reader ----------------------------------------------------


def _text_file(tmp_path, name):
    rng = np.random.default_rng(11)
    lines = []
    for i in range(200):
        words = rng.integers(0, 1000, size=int(rng.integers(0, 9)))
        lines.append(f"line {i}: " + " ".join(map(str, words))
                     + ("\r" if i % 17 == 0 else ""))
    path = tmp_path / name
    path.write_bytes(("\n".join(lines) + "\nno newline at the end").encode())
    return str(path)


def test_text_shard_reader_matches(tmp_path):
    jpath = _text_file(tmp_path, "j.txt")
    tpath = _text_file(tmp_path, "t.txt")
    j, t = jts.TextShardReader(jpath), tts.TextShardReader(tpath)
    try:
        assert t.num_lines == j.num_lines == 201
        np.testing.assert_array_equal(
            np.load(tpath + tts.TextShardReader.INDEX_SUFFIX),
            np.load(jpath + jts.TextShardReader.INDEX_SUFFIX))
        for start, end in ((0, 10), (5, 6), (190, 400), (-3, 2), (50, 50)):
            assert t.read_shard(start, end) == j.read_shard(start, end)
        for i in (0, 17, 100, 200):
            assert t.read_line(i) == j.read_line(i)
        with pytest.raises(IndexError):
            t.read_line(201)
        for indices in (False, True):
            jt = _FakeTaskMaster(jmsg.ShardTask, 3, 7, indices).tasks[2]
            tt = _FakeTaskMaster(tmsg.ShardTask, 3, 7, indices).tasks[2]
            assert t.read_task(tt) == j.read_task(jt)
    finally:
        j.close()
        t.close()
    # A second reader loads the cached index; a changed file rebuilds it.
    again = tts.TextShardReader(tpath)
    assert again.num_lines == 201
    again.close()
    with open(tpath, "ab") as f:
        f.write(b"\nmore")
    grown = tts.TextShardReader(tpath)
    assert grown.num_lines == 202 and grown.read_line(201) == "more"
    grown.close()
    assert os.path.exists(tpath + tts.TextShardReader.INDEX_SUFFIX)

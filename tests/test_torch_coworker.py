"""The port's coworker loader (a shared-memory ring filled by worker
processes) and its cross-host service (over the control plane's
standard-library transport) against the reference's.

The cases are ``tests/test_coworker.py``'s and
``tests/test_coworker_service.py``'s (the same names and assertions), run
on both packages from the same sample functions: the batches must be
equal bit for bit and in the same order, errors must surface with the
same message.  The stall watchdog runs at 1.5 s instead of 3 s, and the
cross-process case stops its server when the consumer is done instead of
after a fixed 8 s and runs the port alone (its stream against the
expected one).
"""

import multiprocessing as mp
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from dlrover_tpu.data import coworker as j_cw
from dlrover_tpu.data import coworker_service as j_svc
from dlrover_tpu.data import loader as j_loader
from dlrover_tpu_torch.data import coworker as t_cw
from dlrover_tpu_torch.data import coworker_service as t_svc
from dlrover_tpu_torch.data import loader as t_loader
from test_torch_master_parity import assert_same

REF = types.SimpleNamespace(cw=j_cw, svc=j_svc, loader=j_loader)
PORT = types.SimpleNamespace(cw=t_cw, svc=t_svc, loader=t_loader)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def run_both(scenario, together=False):
    """``scenario`` on both packages, the port's record first.
    ``together`` runs the two at once in two threads (the reference's
    shutdown waits out a 5 s join of a worker blocked on a slot); only
    for forked workers: two threads starting spawned workers at once
    have stalled a pipeline here."""
    if together:
        with ThreadPoolExecutor(2) as pool:
            want, got = pool.submit(scenario, REF), pool.submit(scenario,
                                                                 PORT)
            want, got = want.result(), got.result()
    else:
        want, got = scenario(REF), scenario(PORT)
    assert want, "the scenario recorded nothing"
    return got, want


# -- tests/test_coworker.py --------------------------------------------------


def test_coworker_matches_inprocess_batches():
    def scenario(ns):
        sample_fn = ns.loader.synthetic_lm_sample_fn(
            vocab_size=97, seq_len=12, seed=3)
        loader = ns.cw.CoworkerDataLoader(
            sample_fn, batch_size=4, num_workers=2, slot_bytes=1 << 20)
        try:
            it = iter(loader)
            got = [next(it) for _ in range(5)]
        finally:
            loader.close()
        expected = [{key: np.stack([sample_fn(b * 4 + i)[key]
                                    for i in range(4)])
                     for key in ("inputs", "targets")} for b in range(5)]
        _same_batches(got, expected)
        return got

    got, want = run_both(scenario)
    _same_batches(got, want)


def test_coworker_finite_sampler_drains_and_stops():
    def scenario(ns):
        sampler = ns.loader.ElasticDistributedSampler(
            dataset_size=24, num_replicas=1, rank=0, shuffle=False)
        sample_fn = ns.loader.synthetic_lm_sample_fn(vocab_size=31,
                                                     seq_len=4)
        loader = ns.cw.CoworkerDataLoader(
            sample_fn, batch_size=6, num_workers=2, slot_bytes=1 << 18)
        try:
            loader.source = sampler
            batches = list(loader)
        finally:
            loader.close()
        np.testing.assert_array_equal(batches[0]["inputs"][0],
                                      sample_fn(0)["inputs"])
        return batches

    got, want = run_both(scenario)
    assert len(got) == 4
    _same_batches(got, want)


def _error_of(ns, loader, drain=False):
    try:
        with pytest.raises(RuntimeError, match="coworker") as err:
            if drain:
                for _ in iter(loader):
                    pass
            else:
                next(iter(loader))
        return str(err.value)
    finally:
        loader.close()


def test_coworker_oversized_batch_raises_cleanly():
    def scenario(ns):
        sample_fn = ns.loader.synthetic_lm_sample_fn(vocab_size=31,
                                                     seq_len=4096)
        return [_error_of(ns, ns.cw.CoworkerDataLoader(
            sample_fn, batch_size=64, num_workers=1, slot_bytes=1 << 12))]

    got, want = run_both(scenario)
    assert got == want and "raise slot_bytes" in got[0]


def test_coworker_sample_error_surfaces_with_surviving_workers():
    def flaky(index):
        if index == 5:
            raise ValueError("bad record")
        return {"x": np.full((4,), index, np.int32)}

    def scenario(ns):
        return [_error_of(ns, ns.cw.CoworkerDataLoader(
            flaky, batch_size=2, num_workers=2, slot_bytes=1 << 16),
            drain=True)]

    got, want = run_both(scenario, together=True)
    assert got == want and "bad record" in got[0]


class _HangingSample:
    """Picklable sample_fn that never returns (wedged-worker simulator)."""

    def __call__(self, index):
        import time

        time.sleep(3600)


def test_stalled_pipeline_raises_instead_of_hanging():
    def scenario(ns):
        loader = ns.cw.CoworkerDataLoader(
            _HangingSample(), batch_size=2, num_workers=1,
            slot_bytes=1 << 16, stall_timeout_s=1.5)
        try:
            with pytest.raises(RuntimeError, match="stalled") as err:
                next(iter(loader))
            return [str(err.value)]
        finally:
            loader.close()

    got, want = run_both(scenario)
    assert got == want


def test_unpicklable_sample_fn_falls_back_to_fork():
    local = 3

    def closure_fn(index):
        return {"x": np.full((2,), index + local, np.int32)}

    def scenario(ns):
        loader = ns.cw.CoworkerDataLoader(
            closure_fn, batch_size=2, num_workers=1, slot_bytes=1 << 16)
        try:
            return [loader.start_method, next(iter(loader))]
        finally:
            loader.close()

    (method, batch), (ref_method, ref_batch) = run_both(scenario,
                                                        together=True)
    assert method == ref_method == "fork"
    np.testing.assert_array_equal(batch["x"][0], [3, 3])
    _same_batches([batch], [ref_batch])


def test_picklable_sample_fn_uses_spawn():
    def scenario(ns):
        loader = ns.cw.CoworkerDataLoader(
            ns.loader.synthetic_lm_sample_fn(vocab_size=7, seq_len=4),
            batch_size=2, num_workers=1, slot_bytes=1 << 16)
        loader.close()
        return [loader.start_method]

    assert run_both(scenario) == (["spawn"], ["spawn"])


# -- tests/test_coworker_service.py ------------------------------------------


def _batches(n, rows=4):
    for i in range(n):
        yield {
            "inputs": np.full((rows, 8), i, np.int32),
            "weights": np.ones((rows,), np.float32) * i,
        }


def test_encode_decode_roundtrip():
    batch = {
        "a": np.arange(12, dtype=np.int64).reshape(3, 4),
        "b": np.random.default_rng(0).normal(size=(2, 2)).astype(np.float32),
        "scalar": np.asarray(7, np.int32),
    }

    def scenario(ns):
        payload = ns.svc.encode_batch(5, batch)
        return [payload, ns.svc.decode_batch(payload)]

    (payload, out), (ref_payload, _) = run_both(scenario)
    assert_same(payload, ref_payload)
    assert set(out) == set(batch)
    for key in batch:
        np.testing.assert_array_equal(out[key], batch[key])


def test_remote_iterator_streams_in_order_and_ends():
    def scenario(ns):
        server = ns.svc.CoworkerDataServer(_batches(6), port=0)
        try:
            it = ns.svc.RemoteBatchIterator(f"localhost:{server.port}",
                                            consumer="t0")
            got = [int(b["inputs"][0, 0]) for b in it]
            it.close()
            return got
        finally:
            server.close()

    got, want = run_both(scenario)
    assert got == want == list(range(6))


def test_two_consumers_share_exactly_once():
    def scenario(ns):
        server = ns.svc.CoworkerDataServer(_batches(10), port=0)
        try:
            a = ns.svc.RemoteBatchIterator(f"localhost:{server.port}",
                                           consumer="a")
            b = ns.svc.RemoteBatchIterator(f"localhost:{server.port}",
                                           consumer="b")
            seen = []
            ita, itb = iter(a), iter(b)
            done_a = done_b = False
            while not (done_a and done_b):
                if not done_a:
                    try:
                        seen.append(int(next(ita)["inputs"][0, 0]))
                    except StopIteration:
                        done_a = True
                if not done_b:
                    try:
                        seen.append(int(next(itb)["inputs"][0, 0]))
                    except StopIteration:
                        done_b = True
            a.close()
            b.close()
            return sorted(seen)
        finally:
            server.close()

    got, want = run_both(scenario)
    assert got == want == list(range(10))


def test_producer_error_propagates():
    def bad():
        yield {"x": np.zeros((2,), np.float32)}
        raise ValueError("tokenizer exploded")

    def scenario(ns):
        server = ns.svc.CoworkerDataServer(bad(), port=0)
        try:
            it = ns.svc.RemoteBatchIterator(f"localhost:{server.port}")
            stream = iter(it)
            first = next(stream)
            with pytest.raises(RuntimeError,
                               match="tokenizer exploded") as err:
                next(stream)
            it.close()
            return [first, str(err.value)]
        finally:
            server.close()

    (first, error), (ref_first, ref_error) = run_both(scenario)
    _same_batches([first], [ref_first])
    assert error == ref_error


def _serve_proc(port_q, stop, n):
    # The coworker "host": its own process with its own server + loader.
    def sample_fn(i):
        return {"inputs": np.full((8,), i, np.int32)}

    loader = t_cw.CoworkerDataLoader(
        sample_fn, batch_size=4, num_workers=2,
        source=iter(range(n * 4)), slot_bytes=1 << 20,
    )
    server = t_svc.CoworkerDataServer(iter(loader), port=0)
    port_q.put(server.port)
    stop.wait(60)
    server.close()
    loader.close()


def test_cross_process_host_with_shm_ring():
    """Full stack across a process boundary: the coworker host process
    runs preprocessing workers, the shm ring and the server; this process
    consumes every preprocessed batch exactly once."""
    ctx = mp.get_context("fork")  # as the reference's case: a closure
    port_q, stop = ctx.Queue(), ctx.Event()
    n_batches = 5
    proc = ctx.Process(target=_serve_proc, args=(port_q, stop, n_batches))
    proc.start()
    try:
        port = port_q.get(timeout=60)
        it = t_svc.RemoteBatchIterator(f"localhost:{port}",
                                       consumer="trainer0")
        got = []
        for batch in it:
            got.extend(batch["inputs"][:, 0].tolist())
        it.close()
        assert sorted(got) == list(range(n_batches * 4))
    finally:
        stop.set()
        proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=5)
    assert proc.exitcode == 0

"""Adaptive batching (paddle_tpu_torch/inference/batching.py) on the CPU:
the contracts of tests/test_batching.py that are not about spans,
timelines or throughput, over a 4-slot CTR tower
(tests/torch_serving_cases.py ``ctr_tower``: benchmarks/bench_serving.py
``_build_ctr_tower``'s layers at 4 slots of 1000 x 16) exported at
max_batch 8, built by the reference and handed over.

- The bucket ladder and bucket choice; assembly offsets and padding (the
  last real row repeated); padded rows never reach an answer; a request
  that fills its bucket is bitwise the unbatched predict on that bucket's
  artifact; a single row equals bucket 1's answer (1e-5 relative: other
  bucket, other sums' order); the deadline flush answers a lone request
  (within 50 x max_wait_ms, so a loaded host does not flake it);
  concurrent submits each get their own answer; warmup readies every
  bucket and the loop none; without warmup the on-demand loads are
  counted; validation; close and drain reject; resident-bytes
  accounting; a shared servable; request ids are monotonic and an
  upstream id threads through.
- Cross-package: the port server's answers to 32 requests of 1-3 rows
  equal the reference ``BatchingInferenceServer``'s within 1e-5 absolute
  (sigmoid outputs; float32 sums in other orders).
- The AOT cache (PADDLE_TPU_TORCH_AOT_CACHE_DIR): a second server readies
  every bucket from the first one's entries, with no compile, bitwise
  (tests/test_torch_aot_cache.py holds the cache's own contract).

The throughput acceptance test (tests/test_batching.py:238) has no CPU
counterpart: chip_smoke.py phase 80 runs the CTR tower at bench_serving's
widths on the card.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.inference import BatchingInferenceServer as JServer
from paddle_tpu.inference import export_bucketed as jexport_bucketed

from paddle_tpu_torch.inference import (BatchingInferenceServer,
                                        InferenceServer, bucket_sizes,
                                        export_bucketed)
from paddle_tpu_torch.inference import batching
from paddle_tpu_torch.inference.batching import _Request

import torch_serving_cases as cases

MAX_BATCH = 8
SLOTS = 4
TOL = 1e-5
SPECS = dict({'C%d' % i: (1,) for i in range(SLOTS)}, I=(13,))


@pytest.fixture(scope='module')
def tower():
    return cases.reference(cases.ctr_tower, seed=17, n_sparse=SLOTS)


@pytest.fixture(scope='module')
def bucket_paths(tower, tmp_path_factory):
    jmain, _, jscope, out = tower
    tmain, texe, tscope = cases.handover(jmain, jscope)
    d = tmp_path_factory.mktemp('buckets')
    return export_bucketed(str(d), SPECS, [out.name], executor=texe,
                           main_program=tmain, scope=tscope,
                           max_batch=MAX_BATCH)


@pytest.fixture(scope='module')
def server(bucket_paths):
    srv = BatchingInferenceServer(bucket_paths, max_wait_ms=50.0,
                                  linger_ms=2.0, device='cpu')
    yield srv
    srv.close()


@pytest.fixture(scope='module')
def ref1(bucket_paths):
    return InferenceServer(bucket_paths[1], device='cpu')


def _feed(rng, rows=None):
    return cases.ctr_feed(rng, rows, SLOTS)


def _bucket_predict(bucket_paths, feed):
    rows = feed['I'].shape[0]
    return InferenceServer(bucket_paths[rows], device='cpu').predict(feed)


def test_bucket_sizes_ladder():
    assert bucket_sizes(1) == [1]
    assert bucket_sizes(8) == [1, 2, 4, 8]
    assert bucket_sizes(6) == [1, 2, 4, 8]  # rounds up
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_bucket_selection(server):
    assert [server._bucket_for(r) for r in (1, 2, 3, 5, 8)] == \
        [1, 2, 4, 8, 8]
    with pytest.raises(ValueError):
        server._bucket_for(MAX_BATCH + 1)


def test_assemble_offsets_and_padding(server):
    rng = np.random.default_rng(0)
    reqs = []
    for i, rows in enumerate((1, 2, 1)):
        norm, k = server._normalize(_feed(rng, rows))
        reqs.append(_Request(norm, k, 0.0, i))
    bucket, stacked, offsets = server._assemble(reqs)
    assert bucket == 4
    assert offsets == [(0, 1), (1, 3), (3, 4)]
    assert stacked['I'].shape == (4, 13) and stacked['C0'].shape == (4, 1)
    np.testing.assert_array_equal(stacked['I'][0], reqs[0].feed['I'][0])
    np.testing.assert_array_equal(stacked['I'][1:3], reqs[1].feed['I'])
    np.testing.assert_array_equal(stacked['C2'][3], reqs[2].feed['C2'][0])
    # 3 rows into bucket 4: the pad row repeats the last real row
    bucket, stacked, offsets = server._assemble(reqs[:2])
    assert bucket == 4 and offsets == [(0, 1), (1, 3)]
    for n in stacked:
        np.testing.assert_array_equal(stacked[n][3], stacked[n][2])


def test_padded_rows_never_leak(server, bucket_paths):
    """A 5-row request (padded to bucket 8) returns exactly the first 5
    rows of a full 8-row run whose trailing rows hold unrelated data."""
    rng = np.random.default_rng(1)
    f5 = _feed(rng, 5)
    got, = server.predict(f5)
    assert got.shape == (5, 1)
    garbage = _feed(rng, 3)
    garbage['I'] *= 100.0
    full = {n: np.concatenate([f5[n], garbage[n]]) for n in f5}
    want, = _bucket_predict(bucket_paths, full)
    np.testing.assert_array_equal(got, want[:5])


def test_bucket_exact_request_bitwise_matches_unbatched(server,
                                                        bucket_paths):
    rng = np.random.default_rng(2)
    for rows in (1, 2, 4, 8):
        f = _feed(rng, rows)
        got, = server.predict(f)
        want, = _bucket_predict(bucket_paths, f)
        np.testing.assert_array_equal(got, want)


def test_single_row_request_matches_unbatched(server, ref1):
    rng = np.random.default_rng(3)
    f = _feed(rng)
    got, = server.predict(f)
    want, = ref1.predict({n: a[None] for n, a in f.items()})
    assert got.shape == (1, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)


def test_deadline_flush_fires_for_lone_request(bucket_paths):
    max_wait_ms = 40.0
    srv = BatchingInferenceServer(bucket_paths, max_wait_ms=max_wait_ms,
                                  linger_ms=1.0, device='cpu')
    try:
        t0 = time.perf_counter()
        out, = srv.submit(_feed(np.random.default_rng(4))).result(
            timeout=10.0)
        elapsed = time.perf_counter() - t0
        assert out.shape == (1, 1)
        assert elapsed < 50 * max_wait_ms / 1e3
        st = srv.stats()
        assert st['batches'] == 1
        assert st['requests_completed'] == 1
        assert st['mean_batch_occupancy'] == 1
        assert st['p50_latency_ms'] > 0
    finally:
        srv.close()


def test_concurrent_submits_all_get_their_own_result(server, ref1):
    """More client threads than cores, the interpreter switching threads
    every 10 us: every request completes once, with its own row."""
    n_threads, per_thread = max(8, 2 * (os.cpu_count() or 1)), 4
    rng = np.random.default_rng(5)
    feeds = [[_feed(rng) for _ in range(per_thread)]
             for _ in range(n_threads)]
    results = [[None] * per_thread for _ in range(n_threads)]
    errors = []

    def client(i):
        try:
            for j in range(per_thread):
                results[i][j] = server.predict(feeds[i][j], timeout=30.0)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    before = server.stats()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    after = server.stats()
    done = after['requests_completed'] - before['requests_completed']
    assert done == n_threads * per_thread
    for i in range(n_threads):
        for j in range(per_thread):
            want, = ref1.predict({n: a[None]
                                  for n, a in feeds[i][j].items()})
            np.testing.assert_allclose(results[i][j][0], want, rtol=TOL,
                                       atol=1e-6)


def test_warmup_readies_every_bucket_and_loop_never_compiles(server):
    st = server.stats()
    assert st['buckets'] == [1, 2, 4, 8]
    assert st['compiles'] == len(st['buckets'])
    assert st['compiles_after_warmup'] == 0
    rng = np.random.default_rng(6)
    for rows in (1, 2, 3, 5, 8):
        server.predict(_feed(rng, rows), timeout=30.0)
    st = server.stats()
    assert st['compiles_after_warmup'] == 0
    assert st['compiles'] == len(st['buckets'])
    assert set(st['per_bucket']) <= {1, 2, 4, 8}


def test_no_warmup_counts_on_demand_compiles(bucket_paths):
    srv = BatchingInferenceServer(bucket_paths, warmup=False,
                                  max_wait_ms=40.0, linger_ms=1.0,
                                  device='cpu')
    try:
        assert srv.stats()['compiles'] == 0
        srv.predict(_feed(np.random.default_rng(7)), timeout=30.0)
        st = srv.stats()
        assert st['compiles'] == 1
        assert st['compiles_after_warmup'] == 1  # the counted stall
    finally:
        srv.close()


def test_request_validation(server):
    rng = np.random.default_rng(8)
    f = _feed(rng)
    with pytest.raises(ValueError):
        server.submit(dict(f, Y=f['I']))                     # extra name
    with pytest.raises(ValueError):
        server.submit({'y': f['I'], **{n: f[n] for n in list(f)[1:]}})
    with pytest.raises(ValueError):
        server.submit(dict(f, I=np.zeros((14,), np.float32)))  # shape
    with pytest.raises(ValueError):
        server.submit(_feed(rng, MAX_BATCH + 1))             # too many rows
    with pytest.raises(ValueError):
        server.submit(dict(_feed(rng, 2), I=np.zeros((3, 13), np.float32)))


def test_close_and_drain_reject_new_requests(bucket_paths):
    srv = BatchingInferenceServer(bucket_paths, warmup=False, device='cpu')
    srv.close()
    with pytest.raises(RuntimeError, match='closed'):
        srv.submit(_feed(np.random.default_rng(9)))
    with BatchingInferenceServer(bucket_paths, warmup=False,
                                 device='cpu') as srv:
        fut = srv.submit(_feed(np.random.default_rng(9)))
        assert srv.drain(timeout=30.0)
        assert fut.result(timeout=1.0)[0].shape == (1, 1)
        assert srv.queue_state() == {
            'queued_requests': 0, 'queued_rows': 0,
            'in_flight_batches': 0, 'accepting': False}
        with pytest.raises(RuntimeError, match='draining'):
            srv.submit(_feed(np.random.default_rng(9)))


def test_resident_bytes_accounting(server):
    rb = server.resident_bytes()
    assert rb['total_bytes'] > 0
    assert sorted(rb['per_bucket']) == bucket_sizes(MAX_BATCH)
    table_bytes = SLOTS * 1000 * 16 * 4
    for b, e in rb['per_bucket'].items():
        assert e['compiled'] is True
        assert e['artifact_bytes'] > table_bytes
        assert e['argument_bytes'] > table_bytes
        assert e['output_bytes'] == b * 4
        assert e['estimate_bytes'] >= e['artifact_bytes']
    assert rb['total_bytes'] == sum(
        e['estimate_bytes'] for e in rb['per_bucket'].values())
    assert rb['servable_key'] == server.resident_bytes()['servable_key']


def test_shared_servable_and_eviction(bucket_paths):
    a = BatchingInferenceServer(bucket_paths, warmup=False, device='cpu')
    b = BatchingInferenceServer(bucket_paths, warmup=False, device='cpu',
                                share_artifacts_with=a)
    c = BatchingInferenceServer(bucket_paths, warmup=False, device='cpu')
    try:
        assert a.resident_bytes()['servable_key'] == \
            b.resident_bytes()['servable_key']
        assert a.resident_bytes()['servable_key'] != \
            c.resident_bytes()['servable_key']
        a.predict(_feed(np.random.default_rng(10)), timeout=30.0)
        assert b.resident_bytes()['per_bucket'][1]['compiled']
        gen = b.residency_generation
        assert set(a.bucket_last_used()) == {1}
        assert b.evict_buckets([1]) > 0
        assert b.residency_generation > gen
        assert not a.resident_bytes()['per_bucket'][1]['compiled']
    finally:
        for s in (a, b, c):
            s.close()


def test_request_ids_are_monotonic_and_threadable(server, monkeypatch):
    seen = []
    real = batching._Request

    class Spy(real):
        def __init__(self, feed, rows, t_submit, rid):
            seen.append(rid)
            real.__init__(self, feed, rows, t_submit, rid)

    monkeypatch.setattr(batching, '_Request', Spy)
    rng = np.random.default_rng(3)
    server.submit(_feed(rng)).result(timeout=30.0)
    server.submit(_feed(rng)).result(timeout=30.0)
    server.submit(_feed(rng), request_id='fleet-77').result(timeout=30.0)
    server.submit(_feed(rng)).result(timeout=30.0)
    assert seen[2] == 'fleet-77'
    auto = [r for r in seen if r != 'fleet-77']
    assert len(auto) == 3
    assert auto == sorted(auto) and len(set(auto)) == 3


def test_the_aot_cache_comes_later(bucket_paths, monkeypatch, tmp_path):
    """The AOT cache is on when PADDLE_TPU_TORCH_AOT_CACHE_DIR is set: the
    first server loads every bucket from its artifact (counted compiles)
    and stores an entry each; a second one readies every bucket from the
    entries with no compile, and answers bitwise as the first."""
    from paddle_tpu_torch.inference import AotCache
    monkeypatch.setenv('PADDLE_TPU_TORCH_AOT_CACHE_DIR', str(tmp_path))
    feed = _feed(np.random.default_rng(5), 3)
    s0 = AotCache.stats()
    with BatchingInferenceServer(bucket_paths, device='cpu') as cold:
        assert cold.stats()['compiles'] == len(cold._buckets)
        want, = cold.predict(feed, timeout=30.0)
    s1 = AotCache.stats()
    assert s1['stores'] - s0['stores'] == len(bucket_paths)
    with BatchingInferenceServer(bucket_paths, device='cpu') as warm:
        assert warm.stats()['compiles'] == 0
        got, = warm.predict(feed, timeout=30.0)
    assert AotCache.stats()['hits'] - s1['hits'] == len(bucket_paths)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):
        BatchingInferenceServer(bucket_paths, device='cpu', aot_cache='d')


def test_answers_match_the_reference_server(tower, server, tmp_path):
    jmain, jexe, jscope, out = tower
    paths = jexport_bucketed(str(tmp_path), SPECS, [out], executor=jexe,
                             main_program=jmain, scope=jscope,
                             max_batch=MAX_BATCH)
    rng = np.random.default_rng(11)
    feeds = [_feed(rng, int(rng.integers(1, 4))) for _ in range(32)]
    with JServer(paths, max_wait_ms=20.0, linger_ms=1.0) as jsrv:
        jfuts = [jsrv.submit(f) for f in feeds]
        want = [f.result(timeout=60.0)[0] for f in jfuts]
    tfuts = [server.submit(f) for f in feeds]
    for f, w, fut in zip(feeds, want, tfuts):
        got, = fut.result(timeout=60.0)
        assert got.shape == (f['I'].shape[0], 1)
        assert np.abs(got - np.asarray(w)).max() <= TOL

"""The serving fleet (paddle_tpu_torch/inference/fleet.py) and the io
version helpers on the CPU: the contracts of tests/test_fleet.py, less
its routing-span test, which tests/test_torch_observability.py holds
with the other span contracts.

- The io helpers (``bucket_artifacts``, ``resolve_version_dir``,
  ``gc_versions``, ``write_rollback_json`` / ``read_rollback_json``) run
  through both packages on mirrored directory trees (``bucket_<N>.pt2``
  in the port's, ``bucket_<N>.stablehlo`` in the reference's) and must
  give the same answers.
- Two versions of the 6 -> 16 -> 4 MLP (max batch 4), built and
  initialised by the reference at seeds 11 and 42 and handed over
  (tests/torch_serving_cases.py); the fleet's answers to version 2 are
  held against the reference's ``InferenceServer`` of the same program
  and state within 1e-5 absolute (float32 sums in other orders).
- Drain and close on the batching server; routing by queue depth with
  rotating ties; retries onto another replica, UNROUTABLE after its
  strikes and the health loop restoring it; hot-swap and rollback, and
  remove / add replica, under live traffic with no request lost; the
  deploy record's ``.prev`` protocol; a joining replica that shares its
  sibling's servable compiles nothing and adds no AOT cache entry; the
  counters and live aggregates of ``stats()``; resident bytes with a
  shared servable counted once, the deploy overlap in the watermark, the
  warn-only budget check and its flag default.

Every wait carries its own timeout, and no test sleeps more than 0.5 s.
"""
import logging
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import io as jio
from paddle_tpu.inference import InferenceServer as JServer
from paddle_tpu.inference import export_bucketed as jexport_bucketed

from paddle_tpu_torch import io
from paddle_tpu_torch.inference import (BatchingInferenceServer,
                                        ServingFleet, export_bucketed)

import torch_serving_cases as cases

MAX_BATCH = 4
TOL = 1e-5


def _mlp():
    x = fluid.layers.data(name='x', shape=[6], dtype='float32')
    h = fluid.layers.fc(input=x, size=16, act='relu')
    return fluid.layers.fc(input=h, size=4)


@pytest.fixture(scope='module')
def versions(tmp_path_factory):
    """A base directory of two numbered versions exported by the port,
    and the reference's export of version 2 (its bucket artifacts)."""
    base = tmp_path_factory.mktemp('model_versions')
    ref = {}
    for ver, seed in (('1', 11), ('2', 42)):
        jmain, jexe, jscope, out = cases.reference(_mlp, seed=seed)
        tmain, texe, tscope = cases.handover(jmain, jscope)
        export_bucketed(str(base / ver), {'x': (6,)}, [out.name],
                        executor=texe, main_program=tmain, scope=tscope,
                        max_batch=MAX_BATCH)
        if ver == '2':
            ref = jexport_bucketed(str(base / 'ref2'), {'x': (6,)}, [out],
                                   executor=jexe, main_program=jmain,
                                   scope=jscope, max_batch=MAX_BATCH)
    return str(base), ref


def _feed(rng, rows=1):
    return {'x': rng.randn(rows, 6).astype('float32')}


def _mk_fleet(versions, **kw):
    kw.setdefault('replicas', 2)
    kw.setdefault('max_wait_ms', 20.0)
    kw.setdefault('linger_ms', 0.5)
    kw.setdefault('health_interval_ms', 0)
    kw.setdefault('device', 'cpu')
    return ServingFleet(versions[0] if isinstance(versions, tuple)
                        else versions, **kw)


def _wait_for(cond, timeout):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


# -- io.py version helpers, against the reference ------------------------
def _tree(root, ext, layout):
    for name, buckets in layout.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for b in buckets:
            open(os.path.join(d, 'bucket_%d.%s' % (b, ext)), 'wb').close()
    return root


LAYOUT = {'1': (1, 2, 4), '2': (1, 2), '10': (1,), '3': (), 'canary': (1,),
          '7': (1, 8)}


def _mirrored(tmp_path):
    return (_tree(str(tmp_path / 'port'), 'pt2', LAYOUT),
            _tree(str(tmp_path / 'ref'), 'stablehlo', LAYOUT))


def test_resolve_version_dir(versions, tmp_path):
    base = versions[0]
    d, name = io.resolve_version_dir(base)
    # 'ref2' holds the reference's .stablehlo files, not the port's
    assert name == '2' and d.endswith('2')
    d1, n1 = io.resolve_version_dir(base, version='1')
    assert n1 == '1' and io.bucket_artifacts(d1)
    d2, n2 = io.resolve_version_dir(os.path.join(base, '1'))
    assert d2 == os.path.join(base, '1') and n2 == '1'
    assert sorted(io.bucket_artifacts(d2)) == [1, 2, 4]
    with pytest.raises(ValueError):
        io.resolve_version_dir(base, version='99')
    (tmp_path / 'not_a_version').mkdir()
    with pytest.raises(ValueError):
        io.resolve_version_dir(str(tmp_path))
    port, ref = _mirrored(tmp_path / 'm')
    for version in (None, '1', '7', 'canary'):
        assert io.resolve_version_dir(port, version)[1] == \
            jio.resolve_version_dir(ref, version)[1]
    for name in LAYOUT:
        assert sorted(io.bucket_artifacts(os.path.join(port, name))) == \
            sorted(jio.bucket_artifacts(os.path.join(ref, name)))
    for bad in ('3', '99'):
        with pytest.raises(ValueError):
            io.resolve_version_dir(port, bad)
        with pytest.raises(ValueError):
            jio.resolve_version_dir(ref, bad)


def test_gc_versions_and_rollback_records(tmp_path):
    port, ref = _mirrored(tmp_path)
    for root in (port, ref):   # a crashed GC's leftover, finished now
        os.makedirs(os.path.join(root, '5.gc.1'))
    for keep, protect in ((1, ('1',)), (1, ()), (2, ())):
        got = io.gc_versions(port, keep=keep,
                             protect=[os.path.join(port, p)
                                      for p in protect])
        want = jio.gc_versions(ref, keep=keep,
                               protect=[os.path.join(ref, p)
                                        for p in protect])
        assert sorted(got) == sorted(want), (keep, protect)
        assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == ['10', '3', 'canary']
    records = [{'version': '1', 'dir': '/a'}, {'version': '1', 'dir': '/a'},
               {'version': '2', 'dir': '/b'}, {'version': '3', 'dir': '/c'}]
    tp, rp = str(tmp_path / 'DEPLOY.json'), str(tmp_path / 'J.json')
    assert io.read_rollback_json(tp) is None
    for rec in records:
        io.write_rollback_json(tp, rec)
        jio.write_rollback_json(rp, rec)
        for prev in (False, True):
            assert io.read_rollback_json(tp, prev) == \
                jio.read_rollback_json(rp, prev)
    assert io.read_rollback_json(tp, prev=True)['version'] == '2'


# -- batching drain / post-close submit -----------------------------------
def test_drain_flushes_then_rejects(versions):
    paths = io.bucket_artifacts(os.path.join(versions[0], '1'))
    srv = BatchingInferenceServer(paths, max_wait_ms=40.0, linger_ms=1.0,
                                  device='cpu')
    try:
        rng = np.random.RandomState(0)
        futs = [srv.submit(_feed(rng)) for _ in range(10)]
        assert srv.drain(timeout=30.0) is True
        for f in futs:
            out, = f.result(timeout=5.0)
            assert out.shape == (1, 4)
        with pytest.raises(RuntimeError, match='draining'):
            srv.submit(_feed(rng))
        st = srv.stats()
        assert st['requests_completed'] == 10
        assert st['queue_depth'] == 0 and st['in_flight_batches'] == 0
        assert srv.queue_state()['accepting'] is False
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match='closed'):
        srv.submit(_feed(np.random.RandomState(1)))


def test_submit_after_close_raises_even_under_backpressure(versions):
    paths = io.bucket_artifacts(os.path.join(versions[0], '1'))
    srv = BatchingInferenceServer(paths, warmup=False, max_queue=1,
                                  max_wait_ms=10000.0, linger_ms=10000.0,
                                  device='cpu')
    rng = np.random.RandomState(2)
    srv.submit(_feed(rng))
    errors = []

    def blocked_submit():
        try:
            srv.submit(_feed(rng))
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=blocked_submit)
    t.start()
    time.sleep(0.1)
    srv.close()
    t.join(10.0)
    assert not t.is_alive(), "submit hung past close()"
    assert len(errors) == 1 and 'closed' in str(errors[0])


def test_queue_wait_compute_split_in_stats(versions):
    paths = io.bucket_artifacts(os.path.join(versions[0], '1'))
    srv = BatchingInferenceServer(paths, max_wait_ms=20.0, linger_ms=0.5,
                                  device='cpu')
    try:
        rng = np.random.RandomState(3)
        for rows in (1, 2, 4, 1, 3):
            srv.predict(_feed(rng, rows), timeout=30.0)
        st = srv.stats()
        for key in ('queue_wait_p50_ms', 'queue_wait_p99_ms',
                    'compute_p50_ms', 'compute_p99_ms'):
            assert st[key] >= 0.0
        assert st['per_bucket']
        for b, row in st['per_bucket'].items():
            assert b in st['buckets']
            assert row['batches'] >= 1 and row['compute_p99_ms'] > 0.0
        assert st['queue_wait_p50_ms'] <= st['p99_latency_ms'] + 1.0
    finally:
        srv.close()


# -- routing --------------------------------------------------------------
def test_fleet_serves_and_matches_reference(versions):
    fleet = _mk_fleet(versions)
    try:
        assert fleet.version == '2'
        ref = JServer(versions[1][1])
        rng = np.random.RandomState(4)
        for _ in range(8):
            f = _feed(rng)
            got, = fleet.predict(f, timeout=30.0)
            want, = ref.predict(f)
            assert np.abs(got - np.asarray(want)).max() <= TOL
        st = fleet.stats()
        assert st['failed'] == 0 and st['completed'] == 8
        done = [p['server']['requests_completed'] for p in st['replicas']]
        assert all(d > 0 for d in done), done
    finally:
        fleet.close()


def test_fleet_routes_to_less_loaded_replica(versions):
    fleet = _mk_fleet(versions)
    try:
        rep_busy, rep_idle = fleet._replicas
        with rep_busy.server._cv:
            rep_busy.server._pending_rows += 1000
        try:
            picked = {fleet._pick(frozenset()).rid for _ in range(6)}
            assert picked == {rep_idle.rid}
        finally:
            with rep_busy.server._cv:
                rep_busy.server._pending_rows -= 1000
    finally:
        fleet.close()


def test_fleet_default_replicas_flag(versions, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_FLEET_REPLICAS', '1')
    fleet = ServingFleet(versions[0], health_interval_ms=0, device='cpu')
    try:
        assert len(fleet.replica_ids) == 1
    finally:
        fleet.close()


# -- failure containment --------------------------------------------------
def _break(rep):
    def boom(feed, **kw):
        raise OSError("replica %s: injected dispatch failure" % rep.rid)
    rep.server.submit = boom


def test_dispatch_failure_is_retried_and_marks_unroutable(versions):
    fleet = _mk_fleet(versions, unroutable_after=1, retry_limit=2)
    try:
        bad = fleet._replicas[0]
        _break(bad)
        rng = np.random.RandomState(5)
        for _ in range(4):
            out, = fleet.predict(_feed(rng), timeout=30.0)
            assert out.shape == (1, 4)
        st = fleet.stats()
        assert st['failed'] == 0 and st['unroutable'] == 1
        bad_stat, = [p for p in st['replicas'] if p['id'] == bad.rid]
        assert bad_stat['state'] == 'unroutable'
        before = st['retries']
        fleet.predict(_feed(rng), timeout=30.0)
        assert fleet.stats()['retries'] == before
    finally:
        fleet.close()


def test_health_loop_restores_recovered_replica(versions):
    fleet = _mk_fleet(versions, unroutable_after=1, retry_limit=2,
                      health_interval_ms=30.0)
    try:
        bad = fleet._replicas[0]
        _break(bad)
        rng = np.random.RandomState(6)
        # the first request may take either replica: send until one
        # reaches the broken one
        assert _wait_for(lambda: fleet.predict(_feed(rng), timeout=30.0)
                         and bad.state == 'unroutable', 10.0)
        del bad.server.submit   # recovered: the class method again
        assert _wait_for(lambda: bad.state == 'ready', 10.0), \
            "health loop never restored it"
        assert fleet.stats()['health_probes'] >= 1
        assert fleet.stats()['failed'] == 0
    finally:
        fleet.close()


def test_all_replicas_dead_yields_clear_error(versions):
    fleet = _mk_fleet(versions, replicas=2, unroutable_after=1,
                      retry_limit=3)
    try:
        for rep in list(fleet._replicas):
            _break(rep)
        fut = fleet.submit(_feed(np.random.RandomState(7)))
        with pytest.raises(Exception) as ei:
            fut.result(timeout=30.0)
        assert 'injected dispatch failure' in str(ei.value) \
            or 'no routable replica' in str(ei.value)
        assert fleet.stats()['failed'] == 1
    finally:
        fleet.close()


def test_invalid_feed_fails_fast_without_striking_replicas(versions):
    fleet = _mk_fleet(versions)
    try:
        fut = fleet.submit({'x': np.zeros((1, 7), np.float32)})
        with pytest.raises(ValueError):
            fut.result(timeout=10.0)
        st = fleet.stats()
        assert st['unroutable'] == 0 and st['retries'] == 0
    finally:
        fleet.close()


# -- lifecycle under traffic ----------------------------------------------
class _Traffic(object):
    """A background closed-loop client recording each outcome."""

    def __init__(self, fleet, rng, period_s=0.002):
        self.fleet, self.rng, self.period = fleet, rng, period_s
        self.errors, self.ok = [], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                out, = self.fleet.predict(_feed(self.rng), timeout=30.0)
                assert out.shape == (1, 4)
                self.ok += 1
            except Exception as e:
                self.errors.append(e)
            time.sleep(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(30.0)
        assert not self._thread.is_alive()


def test_remove_add_replica_under_traffic(versions):
    fleet = _mk_fleet(versions, replicas=2)
    try:
        with _Traffic(fleet, np.random.RandomState(8)) as traffic:
            time.sleep(0.1)
            rid = fleet.remove_replica()
            assert rid not in fleet.replica_ids
            assert len(fleet.replica_ids) == 1
            time.sleep(0.1)
            new_rid = fleet.add_replica()
            assert new_rid in fleet.replica_ids
            time.sleep(0.1)
        assert traffic.errors == [] and traffic.ok > 0
        assert fleet.stats()['failed'] == 0
        with pytest.raises(ValueError):
            fleet.remove_replica('nonexistent')
    finally:
        fleet.close()


def test_deploy_hot_swap_and_rollback_under_traffic(versions):
    base = versions[0]
    fleet = ServingFleet(os.path.join(base, '1'), replicas=2,
                         max_wait_ms=20.0, linger_ms=0.5,
                         health_interval_ms=0, device='cpu')
    try:
        from paddle_tpu_torch.inference import InferenceServer
        ref1 = InferenceServer(
            io.bucket_artifacts(os.path.join(base, '1'))[1], device='cpu')
        ref2 = InferenceServer(
            io.bucket_artifacts(os.path.join(base, '2'))[1], device='cpu')
        probe = _feed(np.random.RandomState(9))
        w1, w2 = ref1.predict(probe)[0], ref2.predict(probe)[0]
        assert not np.allclose(w1, w2)
        np.testing.assert_array_equal(fleet.predict(probe, 30.0)[0], w1)
        with _Traffic(fleet, np.random.RandomState(10)) as traffic:
            time.sleep(0.05)
            assert fleet.deploy(os.path.join(base, '2')) == '2'
            assert fleet.version == '2'
            np.testing.assert_array_equal(fleet.predict(probe, 30.0)[0],
                                          w2)
            time.sleep(0.05)
            assert fleet.rollback() == '1' and fleet.version == '1'
            np.testing.assert_array_equal(fleet.predict(probe, 30.0)[0],
                                          w1)
        assert traffic.errors == []
        st = fleet.stats()
        assert st['failed'] == 0
        assert st['deploys'] == 3 and st['rollbacks'] == 1
        assert {p['version'] for p in st['replicas']} == {'1'}
    finally:
        fleet.close()


def test_deploy_record_prev_protocol(versions, tmp_path):
    base = versions[0]
    state = str(tmp_path / 'state')
    rec_path = os.path.join(state, 'DEPLOY.json')
    fleet = ServingFleet(os.path.join(base, '1'), replicas=1,
                         state_dir=state, health_interval_ms=0,
                         device='cpu')
    try:
        assert io.read_rollback_json(rec_path)['version'] == '1'
        assert io.read_rollback_json(rec_path, prev=True) is None
        fleet.deploy(os.path.join(base, '2'))
        assert io.read_rollback_json(rec_path)['version'] == '2'
        assert io.read_rollback_json(rec_path, prev=True)['version'] == '1'
    finally:
        fleet.close()
    assert os.path.isdir(state)


# -- a joining replica ----------------------------------------------------
def test_cold_replica_with_warm_cache_reports_zero_compiles(
        versions, tmp_path, monkeypatch):
    """With the AOT cache on, the first replica stores one entry a
    bucket; a replica joining later shares its sibling's servable:
    serving-ready with no compile of its own and no new cache entry, and
    no compile after serving every bucket."""
    aot = tmp_path / 'aot'
    monkeypatch.setenv('PADDLE_TPU_TORCH_AOT_CACHE_DIR', str(aot))
    fleet = _mk_fleet(versions, replicas=1)
    try:
        entries = os.listdir(aot / 'paddle_tpu_aot')
        n_buckets = len(io.bucket_artifacts(os.path.join(versions[0],
                                                         '2')))
        assert len(entries) == n_buckets
        first, = fleet._replicas
        assert fleet.stats()['replicas'][0]['compiles'] == n_buckets
        rid = fleet.add_replica()
        st = fleet.stats()
        cold, = [p for p in st['replicas'] if p['id'] == rid]
        assert cold['compiles'] == 0 and cold['compiles_after_warmup'] == 0
        added, = [r for r in fleet._replicas if r.rid == rid]
        assert added.server._compiled is first.server._compiled
        assert os.listdir(aot / 'paddle_tpu_aot') == entries
        rng = np.random.RandomState(11)
        for rows in (1, 2, 4):
            fleet.predict(_feed(rng, rows), timeout=30.0)
        assert all(p['compiles_after_warmup'] == 0
                   for p in fleet.stats()['replicas'])
    finally:
        fleet.close()


# -- counters and aggregates ----------------------------------------------
def test_fleet_metrics_labels_and_retirement(versions):
    """The fleet's counters: one request counted fleet-wide and on the
    replica that took it, under that replica's version label; a replica
    retired by a deploy keeps its counters readable."""
    fleet = _mk_fleet(versions)
    try:
        fleet.predict(_feed(np.random.RandomState(12)), timeout=30.0)
        st = fleet.stats()
        assert st['requests'] == 1 and st['completed'] == 1
        assert st['ready'] == 2
        disp = {r.rid: r.m_dispatch.value for r in fleet._replicas}
        assert sorted(disp.values()) == [0, 1]
        old = list(fleet._replicas)
        fleet.deploy(versions[0], version='1')
        assert all(r.state == 'retired' for r in old)
        assert sum(r.m_dispatch.value for r in old) == 1
        assert {p['version'] for p in fleet.stats()['replicas']} == {'1'}
    finally:
        fleet.close()
    with pytest.raises(RuntimeError, match='closed'):
        fleet.submit(_feed(np.random.RandomState(13)))


def test_stats_aggregates_read_live(versions):
    """The reference's callback gauges are ``stats()`` aggregates here:
    queued rows and in-flight batches read from the replicas' queues at
    the call."""
    fleet = _mk_fleet(versions)
    try:
        rep = fleet._replicas[0]
        with rep.server._cv:
            rep.server._pending_rows += 7
        try:
            assert fleet.stats()['queued_rows'] == 7
            assert fleet._aggregate('queued_rows') == 7
        finally:
            with rep.server._cv:
                rep.server._pending_rows -= 7
        assert fleet.stats()['queued_rows'] == 0
        assert fleet._state_count('ready') == 2
    finally:
        fleet.close()


# -- resident bytes and the budget ----------------------------------------
def test_resident_bytes_gauges_and_shared_dedupe(versions):
    fleet = _mk_fleet(versions, replicas=2)
    try:
        st = fleet.stats()
        per = st['replicas']
        assert all(p['resident_bytes'] > 0 for p in per)
        assert st['resident_bytes'] == per[0]['resident_bytes']
        assert st['resident_bytes_watermark'] >= st['resident_bytes']
        for rep in fleet._replicas:
            assert rep.resident['total_bytes'] > 0
    finally:
        fleet.close()


def test_deploy_overlap_raises_resident_watermark(versions):
    fleet = _mk_fleet(versions, replicas=2, version='1')
    try:
        v1 = fleet.stats()['resident_bytes']
        fleet.deploy(versions[0], version='2')
        st = fleet.stats()
        assert st['resident_bytes_watermark'] > st['resident_bytes']
        assert st['resident_bytes_watermark'] > v1
    finally:
        fleet.close()


def test_hbm_budget_precheck_is_warn_only(versions, caplog):
    fleet = _mk_fleet(versions, replicas=1, version='1')
    try:
        assert fleet.stats()['hbm_budget_precheck_failures'] == 0
        with caplog.at_level(logging.WARNING,
                             logger='paddle_tpu_torch.inference.fleet'):
            vname = fleet.deploy(versions[0], version='2',
                                 hbm_budget_bytes=1)
        assert vname == '2'
        assert fleet.stats()['hbm_budget_precheck_failures'] == 1
        assert any('would exceed the HBM budget' in r.message
                   for r in caplog.records)
        out, = fleet.predict(_feed(np.random.RandomState(1)), timeout=30.0)
        assert out.shape == (1, 4)
        fleet.deploy(versions[0], version='1', hbm_budget_bytes=1 << 40)
        assert fleet.stats()['hbm_budget_precheck_failures'] == 1
    finally:
        fleet.close()


def test_fleet_budget_defaults_to_peak_hbm_flag(versions, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_PEAK_HBM_BYTES', '1')
    fleet = _mk_fleet(versions, replicas=1)
    try:
        st = fleet.stats()
        assert st['hbm_budget_bytes'] == 1
        assert st['hbm_budget_precheck_failures'] == 1
    finally:
        fleet.close()


def test_fleet_entry_points_default_to_the_card(versions):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ServingFleet(versions[0], health_interval_ms=0)

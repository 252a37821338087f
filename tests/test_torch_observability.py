"""The port's observability (paddle_tpu_torch/observability/) against the
reference's (paddle_tpu/observability/), on the CPU.

- The same sequence of counter, gauge and histogram operations on one
  registry of each package renders byte-equal Prometheus text and an
  equal JSON snapshot; quantiles clamp to the observed max; a kind,
  label or bucket mismatch is an error.
- The executor's series after the same fc-net loop (3 ``run`` and one
  ``run_steps`` of 4 steps, from pre-staged feeds) hold the same values
  in both packages, but ``feed_bytes`` of the stacked call, where the
  reference stages its first feed a second time to build its plan
  (asserted to the byte).
- The port's metric names are a subset of the reference's; the names it
  lacks are the ones ``WAITING`` lists, each with the ROADMAP.md item
  that brings it.
- ``reader.metered`` / ``buffered`` count as the reference's do.
- Disabled metrics leave the executor's series untouched and spans
  collapse to the shared no-op.
- The servers report into the process registry under ``server=`` /
  ``fleet=`` labels and ``close()`` retires every series (and the fleet's
  /healthz check); ``stats()`` keeps its shape; the fleet's callback
  gauges read live state; /metrics and /healthz serve over HTTP.

The registries are process-wide, and the two packages' are separate
objects: each test reads deltas of its own package's registry and
compares them with the other's explicitly.
"""
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import observability as jobs
from paddle_tpu.core import program as jprog

import paddle_tpu_torch as tfl
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.observability import tracing as ttracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_RE = re.compile(r'^[a-z_]+(\{[^}]*\})? [0-9.eE+-]+$')

# reference metric names the port does not register yet, by the
# ROADMAP.md Queue 1 item that brings them
WAITING = {
    'paddle_tpu_executor_collective_exposed_bytes_total': 'item 10',
    'paddle_tpu_executor_collective_modeled_bytes_total': 'item 10',
    'paddle_tpu_executor_collective_overlapped_bytes_total': 'item 10',
    'paddle_tpu_executor_collectives_modeled_total': 'item 10',
    'paddle_tpu_embed_cache_evictions_total': 'item 10',
    'paddle_tpu_embed_cache_hits_total': 'item 10',
    'paddle_tpu_embed_cache_misses_total': 'item 10',
    'paddle_tpu_online_freshness_slo_violations_total': 'item 11',
    'paddle_tpu_online_gate_auc': 'item 11',
    'paddle_tpu_online_live_auc': 'item 11',
    'paddle_tpu_online_model_age_seconds': 'item 11',
    'paddle_tpu_online_round_seconds': 'item 11',
    'paddle_tpu_online_rounds_total': 'item 11',
    'paddle_tpu_online_rows_trained_total': 'item 11',
    'paddle_tpu_online_steps_total': 'item 11',
}
# string literals of that form that are not metric names (a directory,
# the port's operator namespace and file-name prefixes)
NOT_METRICS = {'paddle_tpu_tuning', 'paddle_tpu_torch',
               'paddle_tpu_torch_prof'}


def _literal_names(pkg_dir):
    out = set()
    for root, _, files in os.walk(os.path.join(REPO, pkg_dir)):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(root, f)) as fh:
                    out.update(re.findall(r"'(paddle_tpu_[a-z_]*[a-z])'",
                                          fh.read()))
    return out - NOT_METRICS


def _value(snap, name, labels=None):
    fam = snap.get(name)
    if not fam:
        return 0.0
    out = 0.0
    for s in fam['samples']:
        if labels and any(s['labels'].get(k) != v for k, v in
                          labels.items()):
            continue
        out += s['value'] if 'value' in s else s['count']
    return out


# -- registry primitives, byte for byte -----------------------------------
def _exercise(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter('paddle_tpu_test_requests_total',
                    'requests\nserved', ('server', 'code'))
    c.labels(server='b0', code='200').inc(3)
    c.labels(server='b1', code='5"0\\0').inc(2.5)
    c.labels(server='b0', code='200').inc()
    g = reg.gauge('paddle_tpu_test_depth', 'queue depth')
    g.set(7)
    g.inc(2.5)
    g.dec()
    inf = reg.gauge('paddle_tpu_test_nonfinite', '', ('kind',))
    inf.labels(kind='inf').set(float('inf'))
    inf.labels(kind='nan').set(float('nan'))
    inf.labels(kind='big').set(3e20)
    fn = reg.gauge('paddle_tpu_test_pull', 'pull gauge', ('fleet',))
    fn.labels(fleet='f0').set_function(lambda: 41 + 1)
    h = reg.histogram('paddle_tpu_test_latency_seconds', 'latency',
                      ('server',))
    rng = np.random.RandomState(3)
    for v in rng.exponential(0.02, size=200):
        h.labels(server='b0').observe(float(v))
    h.labels(server='b1').observe(12.0)
    occ = reg.histogram('paddle_tpu_test_occupancy', 'rows',
                        buckets=(1, 2, 4, 8))
    for v in (1, 3, 3, 8, 9):
        occ.observe(v)
    q = [h.labels(server='b0').quantile(p) for p in (0.0, 0.5, 0.99, 1.0)]
    q.append(h.labels(server='b1').quantile(0.99))
    return reg, q


def test_exposition_and_snapshot_equal_the_reference():
    treg, tq = _exercise(tobs)
    jreg, jq = _exercise(jobs)
    ttext = tobs.prometheus_text(treg)
    assert ttext.encode() == jobs.prometheus_text(jreg).encode()
    assert tobs.json_snapshot(treg) == jobs.json_snapshot(jreg)
    assert json.loads(tobs.json_snapshot(treg, indent=1)) == \
        json.loads(jobs.json_snapshot(jreg, indent=1))
    assert tq == jq
    # the overflow bucket clamps to the observed max, never +Inf
    assert tq[-1] == 12.0
    for line in ttext.splitlines():
        if line and not line.startswith('#') and 'nonfinite' not in line:
            assert SAMPLE_RE.match(line), line


@pytest.mark.parametrize('pkg', [tobs, jobs], ids=['port', 'reference'])
def test_registry_contracts(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter('paddle_tpu_test_x_total', 'x', ('a',))
    assert reg.counter('paddle_tpu_test_x_total', 'x', ('a',)) is c
    with pytest.raises(ValueError):
        reg.gauge('paddle_tpu_test_x_total')
    with pytest.raises(ValueError):
        reg.counter('paddle_tpu_test_x_total', 'x', ('b',))
    with pytest.raises(ValueError):
        reg.counter('paddle_tpu_test_digits_2_total')
    with pytest.raises(ValueError):
        c.labels(a='1').inc(-1)
    reg.histogram('paddle_tpu_test_h', buckets=(1, 2))
    with pytest.raises(ValueError):
        reg.histogram('paddle_tpu_test_h', buckets=(1, 3))
    with pytest.raises(ValueError):
        reg.histogram('paddle_tpu_test_h2', buckets=(1, float('inf')))
    h = reg.histogram('paddle_tpu_test_q').labels()
    assert h.quantile(0.5) == 0.0
    h.observe(0.3)
    assert h.quantile(1.0) == 0.3
    with pytest.raises(ValueError):
        h.quantile(1.5)
    c.labels(a='1').inc()
    c.remove(a='1')
    assert reg.snapshot()['paddle_tpu_test_x_total']['samples'] == []


# -- the executor's series against the reference's -----------------------
def _fc_net(pkg, prog_mod):
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[4], dtype='float32')
            y = pkg.layers.data(name='y', shape=[1], dtype='float32')
            pred = pkg.layers.fc(input=x, size=1)
            cost = pkg.layers.mean(
                pkg.layers.square_error_cost(input=pred, label=y))
            pkg.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return main, startup, cost


EXEC_SERIES = ('runs', 'steps', 'plan_cache_hits', 'plan_cache_misses',
               'compiles', 'feed_bytes', 'donated_state_bytes',
               'donated_feed_bytes', 'feed_blocking_puts',
               'feed_prefetched_puts', 'feed_prefetched_bytes')


def _exec_deltas(obs, s0, s1):
    out = {k: _value(s1, 'paddle_tpu_executor_%s_total' % k) -
           _value(s0, 'paddle_tpu_executor_%s_total' % k)
           for k in EXEC_SERIES}
    for k in ('graph_opt_ops_eliminated', 'amp_ops_lowered',
              'amp_skipped_steps', 'ir_verify_failures'):
        out[k] = _value(s1, 'paddle_tpu_%s_total' % k) - \
            _value(s0, 'paddle_tpu_%s_total' % k)
    for k in ('executor_compile_seconds', 'graph_opt_seconds'):
        out[k + '_count'] = _value(s1, 'paddle_tpu_' + k) - \
            _value(s0, 'paddle_tpu_' + k)
    return out


def _loop(pkg, prog_mod, obs, stage, mode):
    main, startup, cost = _fc_net(pkg, prog_mod)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feeds = [{'x': stage(rng.randn(8, 4).astype('float32')),
              'y': stage(rng.randn(8, 1).astype('float32'))}
             for _ in range(4)]
    s0 = obs.snapshot()
    losses = [np.asarray(exe.run(main, feed=feeds[i], fetch_list=[cost],
                                 scope=scope)[0]) for i in range(3)]
    if mode == 'stacked':
        out = exe.run_steps(main, feed=feeds, fetch_list=[cost],
                            scope=scope)
    else:
        out = exe.run_steps(main, feed=feeds[0], fetch_list=[cost],
                            scope=scope, repeat=4)
    losses.append(np.asarray(out[0]))
    return _exec_deltas(obs, s0, obs.snapshot()), losses


@pytest.mark.parametrize('mode', ['stacked', 'repeat'])
def test_executor_series_equal_the_reference(mode):
    import jax.numpy as jnp
    jd, jl = _loop(fluid, jprog, jobs, jnp.asarray, mode)
    td, tl = _loop(tfl, tprog, tobs, torch.from_numpy, mode)
    want = dict(jd)
    if mode == 'stacked':
        # the reference stages its first feed (8x4 + 8x1 float32) a
        # second time to build its plan; the port plans from the specs
        want['feed_bytes'] -= 8 * 4 * 4 + 8 * 1 * 4
    assert td == want, (td, jd)
    assert td['runs'] == 3 and td['steps'] == 7 and td['compiles'] == 2
    assert td['plan_cache_hits'] == 3 and td['plan_cache_misses'] == 2
    assert td['feed_blocking_puts'] == (mode == 'stacked')
    assert [np.shape(a) for a in tl] == [np.shape(b) for b in jl]
    assert all(np.isfinite(a).all() for a in tl)


def test_metric_names_are_a_subset_of_the_reference():
    ref = _literal_names('paddle_tpu')
    port = _literal_names('paddle_tpu_torch')
    assert port <= ref, sorted(port - ref)
    assert ref - port == set(WAITING), sorted((ref - port) ^ set(WAITING))
    registered = {m.name for m in tobs.registry().collect()
                  if not m.name.startswith('paddle_tpu_test_')}
    assert registered <= ref, sorted(registered - ref)


def test_disabled_mode_is_inert():
    tobs.set_enabled(False)
    try:
        assert tobs.span('anything') is ttracing._NULL_SPAN
        main, startup, cost = _fc_net(tfl, tprog)
        exe = tfl.Executor(tfl.CPUPlace())
        scope = tfl.Scope()
        exe.run(startup, scope=scope)
        s0 = tobs.snapshot()
        feed = {'x': np.ones((3, 4), np.float32),
                'y': np.ones((3, 1), np.float32)}
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        exe.run_steps(main, feed=[feed, feed], fetch_list=[cost],
                      scope=scope)
        assert _exec_deltas(tobs, s0, tobs.snapshot()) == \
            {k: 0.0 for k in _exec_deltas(tobs, s0, s0)}
        assert list(tfl.reader.decorator.metered(
            lambda: iter(range(5)), 'off')()) == list(range(5))
        assert _value(tobs.snapshot(), 'paddle_tpu_reader_samples_total',
                      {'reader': 'off'}) == 0
    finally:
        tobs.reload_enabled()
    assert tobs.enabled()


# -- readers ---------------------------------------------------------------
def _reader_counts(pkg, obs):
    def src():
        for i in range(300):
            yield i

    s0 = obs.snapshot()
    assert list(pkg.reader.decorator.metered(src, name='unit')()) == \
        list(range(300))
    assert list(pkg.reader.decorator.buffered(src, 10)()) == \
        list(range(300))
    it = pkg.reader.decorator.metered(src, name='abandon')()
    for _, _ in zip(range(10), it):
        pass
    it.close()
    s1 = obs.snapshot()
    return {r: _value(s1, 'paddle_tpu_reader_samples_total',
                      {'reader': r}) -
            _value(s0, 'paddle_tpu_reader_samples_total', {'reader': r})
            for r in ('unit', 'buffered', 'abandon')}


def test_metered_counts_equal_the_reference():
    t = _reader_counts(tfl, tobs)
    assert t == _reader_counts(fluid, jobs)
    assert t == {'unit': 300, 'buffered': 300, 'abandon': 10}


# -- the servers -------------------------------------------------------------
def _mlp_dir(base):
    from paddle_tpu_torch.inference import export_bucketed
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[4], dtype='float32')
        y = tfl.layers.fc(input=x, size=2)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    export_bucketed(str(base), {'x': (4,)}, [y], executor=exe,
                    main_program=main, scope=scope, max_batch=2)
    return str(base)


def _label_values(snap, prefix, key):
    out = set()
    for name, fam in snap.items():
        if name.startswith(prefix):
            for s in fam['samples']:
                out.add(s['labels'].get(key))
    return out


def test_batching_server_series_stats_and_retirement(tmp_path):
    from paddle_tpu_torch.inference import BatchingInferenceServer
    vdir = _mlp_dir(tmp_path / 'v1')
    paths = {1: os.path.join(vdir, 'bucket_1.pt2'),
             2: os.path.join(vdir, 'bucket_2.pt2')}
    srv = BatchingInferenceServer(paths, device='cpu', max_wait_ms=20.0,
                                  linger_ms=0.5)
    sid = srv._m._sid
    try:
        rng = np.random.RandomState(1)
        for _ in range(3):
            srv.predict({'x': rng.randn(4).astype(np.float32)},
                        timeout=30.0)
        st = srv.stats()
        assert set(st) == {
            'queue_depth', 'in_flight_batches', 'requests_submitted',
            'requests_completed', 'batches', 'mean_batch_occupancy',
            'mean_bucket_fill', 'compiles', 'compiles_after_warmup',
            'p50_latency_ms', 'p99_latency_ms', 'buckets',
            'queue_wait_p50_ms', 'queue_wait_p99_ms', 'compute_p50_ms',
            'compute_p99_ms', 'per_bucket'}
        for k in ('requests_submitted', 'requests_completed', 'batches',
                  'compiles', 'compiles_after_warmup'):
            assert isinstance(st[k], int), k
        assert st['requests_completed'] == 3 and st['compiles'] == 2
        snap = tobs.snapshot()
        assert sid in _label_values(snap, 'paddle_tpu_serving_', 'server')
        assert _value(snap, 'paddle_tpu_serving_request_latency_seconds',
                      {'server': sid}) == 3
        assert _value(snap, 'paddle_tpu_span_seconds',
                      {'span': 'serving.bucket_compile'}) >= 2
    finally:
        srv.close()
    assert sid not in _label_values(tobs.snapshot(), 'paddle_tpu_serving_',
                                    'server')


def test_decode_server_series_and_retirement():
    from paddle_tpu_torch.inference.decode import DecodeEngine, DecodeServer
    from paddle_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_params)
    cfg = TransformerConfig(50, 32, 1, 16, 2)
    gen = torch.Generator().manual_seed(0)
    eng = DecodeEngine(init_params(cfg, gen, 'cpu'), n_layers=1, n_heads=2,
                       page_size=8, max_streams=2, prefill_bucket=16,
                       device='cpu')
    srv = DecodeServer(eng)
    sid = srv._m._sid
    try:
        toks = srv.submit(np.array([1, 2, 3]), max_new_tokens=3).result(60)
        assert len(toks) == 3
        snap = tobs.snapshot()
        assert _value(snap, 'paddle_tpu_decode_ttft_seconds',
                      {'server': sid}) == 1
        assert _value(snap, 'paddle_tpu_decode_tokens_generated_total',
                      {'server': sid}) == 3
    finally:
        srv.close()
    assert sid not in _label_values(tobs.snapshot(), 'paddle_tpu_decode_',
                                    'server')


def test_fleet_gauges_healthz_and_retirement(tmp_path):
    from paddle_tpu_torch.inference import ServingFleet
    _mlp_dir(tmp_path / 'base' / '1')
    fleet = ServingFleet(str(tmp_path / 'base'), replicas=2, device='cpu',
                         health_interval_ms=0, max_wait_ms=20.0,
                         linger_ms=0.5)
    fid = fleet._fid
    try:
        rng = np.random.RandomState(2)
        for _ in range(3):
            fleet.predict({'x': rng.randn(4).astype(np.float32)},
                          timeout=30.0)
        snap = tobs.snapshot()
        f = {'fleet': fid}
        assert _value(snap, 'paddle_tpu_fleet_requests_total', f) == 3
        assert _value(snap, 'paddle_tpu_fleet_replicas',
                      dict(f, state='ready')) == 2
        assert _value(snap, 'paddle_tpu_fleet_resident_bytes', f) == \
            fleet.stats()['resident_bytes']
        assert _value(snap, 'paddle_tpu_fleet_tenant_requests_total',
                      f) == 3
        assert _value(snap, 'paddle_tpu_fleet_dispatches_total', f) == 3
        ok, checks = tobs.healthz_report()
        assert checks['fleet_%s' % fid]['ok'] and \
            checks['fleet_%s' % fid]['detail']['replicas'] == {'ready': 2}
        st = fleet.stats()
        assert st['requests'] == 3 and st['completed'] == 3
    finally:
        fleet.close()
    snap = tobs.snapshot()
    assert fid not in _label_values(snap, 'paddle_tpu_fleet_', 'fleet')
    assert fid not in _label_values(snap, 'paddle_tpu_serving_resident',
                                    'fleet')
    assert 'fleet_%s' % fid not in tobs.healthz_report()[1]


def test_fleet_routing_span_carries_request_id(tmp_path, monkeypatch):
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.observability import timeline
    _mlp_dir(tmp_path / 'base' / '1')
    monkeypatch.setenv('PADDLE_TPU_TORCH_TRACE_DIR', str(tmp_path / 'tr'))
    timeline.reset()
    fleet = ServingFleet(str(tmp_path / 'base'), replicas=2, device='cpu',
                         health_interval_ms=0, max_wait_ms=20.0,
                         linger_ms=0.5)
    try:
        fleet.predict({'x': np.ones(4, np.float32)}, timeout=30.0)
        evs = timeline.ring().events()
        disp = [e for e in evs if e['name'] == 'fleet.dispatch']
        qw = [e for e in evs if e['name'] == 'serving.queue_wait']
        assert disp and qw
        rid = disp[0]['args']['request_id']
        assert disp[0]['args']['replica'] in fleet.replica_ids
        assert disp[0]['args']['version'] == fleet.version
        assert any(e['args'].get('request_id') == rid for e in qw)
    finally:
        fleet.close()
        monkeypatch.delenv('PADDLE_TPU_TORCH_TRACE_DIR')
        timeline.reset()


# -- /metrics and /healthz ---------------------------------------------------
def test_metrics_http_endpoint_serves_and_parses():
    tobs.counter('paddle_tpu_test_endpoint_total').inc()
    tobs.register_healthz('test_check', lambda: (True, {'n': 1}))
    h = tobs.serve_metrics(port=0)
    try:
        base = 'http://127.0.0.1:%d' % h.port
        body = urllib.request.urlopen(base + '/metrics',
                                      timeout=10).read().decode()
        assert 'paddle_tpu_test_endpoint_total 1' in body
        for line in body.splitlines():
            if line and not line.startswith('#'):
                assert SAMPLE_RE.match(line), line
        hz = json.loads(urllib.request.urlopen(
            base + '/healthz', timeout=10).read().decode())
        assert hz['status'] == 'ok' and hz['checks']['test_check']['ok']
        tobs.register_healthz('test_check', lambda: (False, 'stale'))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + '/healthz', timeout=10)
        assert e.value.code == 503
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + '/nope', timeout=10)
    finally:
        tobs.unregister_healthz('test_check')
        h.close()


def test_serve_metrics_needs_a_port_and_survives_a_conflict(monkeypatch):
    from paddle_tpu_torch.observability import http
    monkeypatch.delenv('PADDLE_TPU_TORCH_METRICS_PORT', raising=False)
    with pytest.raises(ValueError):
        tobs.serve_metrics()
    assert tobs.maybe_serve_from_env() is None
    h = tobs.serve_metrics(port=0)
    try:
        monkeypatch.setenv('PADDLE_TPU_TORCH_METRICS_PORT', str(h.port))
        monkeypatch.setattr(http, '_auto_server', None)
        with pytest.warns(UserWarning):
            assert tobs.maybe_serve_from_env() is None
    finally:
        h.close()


def test_flags_cli_and_top_level_exports():
    assert tfl.FLAGS is tfl.flags.FLAGS
    out = subprocess.run(
        [sys.executable, '-m', 'paddle_tpu_torch.flags'],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    for name in ('PADDLE_TPU_TORCH_METRICS_ENABLED',
                 'PADDLE_TPU_TORCH_METRICS_PORT',
                 'PADDLE_TPU_TORCH_PROFILER_EVENT_CAP',
                 'PADDLE_TPU_TORCH_CHECK_NAN_INF',
                 'PADDLE_TPU_TORCH_TRACE_DIR',
                 'PADDLE_TPU_TORCH_DEVICE_PREFETCH_CHUNK',
                 'PADDLE_TPU_TORCH_USE_NATIVE_RUNTIME'):
        assert name in out.stdout, name
    # the item-9a flags keep the reference's defaults (profile_dir lies
    # under the process's temporary directory instead of /tmp)
    from paddle_tpu.flags import FLAGS as JFLAGS
    for name in ('metrics_enabled', 'metrics_port', 'metrics_host',
                 'profiler_event_cap', 'trace_dir', 'trace_steps',
                 'trace_dump_on_error', 'device_prefetch',
                 'device_prefetch_chunk', 'use_native_runtime',
                 'reader_buf_size', 'check_nan_inf'):
        assert tfl.FLAGS.definitions()[name][0] == \
            JFLAGS.definitions()[name][0], name

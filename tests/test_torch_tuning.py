"""The port's autotuner (paddle_tpu_torch/tuning/) against the
reference's (paddle_tpu/tuning/).

- The search: with one fixed model and measurement function over
  tunables of equal domains, the port's ``Autotuner`` gives the
  reference's trace, winners and measurement count, exactly (the
  reasons' env names read with the reference's prefix): ties, the
  memory-budget and modelled-worse pruning, the measure budget, a
  pinned tunable and an infeasible candidate.
- The roofline: ``report`` equals the reference's on one cost dict at
  equal explicit peaks (the port calls the compute-bound resource
  'compute' where the reference says 'mxu'), and the default peak
  follows the AMP mode.
- ``model_program`` on a small fc program built by both packages gives
  equal scores at equal explicit peaks, and the dry-run search over
  ``amp`` and ``device_prefetch_chunk`` picks the same winners.
- The cache (its round trip, corruption counted into
  ``paddle_tpu_tune_cache_corrupt_total``, disabled without a dir,
  cached mode with no search, the key stable under tuner-applied env,
  separating programs but not rebuilds), the executor hook under
  PADDLE_TPU_TORCH_TUNE=cached, and tune off bitwise.
- The registry is the reference's names less ``WAITING``, with the one
  rename.

Scores are compared exactly: both sides compute the same float64
arithmetic from the same integer FLOP and byte counts.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.tuning import registry as jreg
from paddle_tpu.tuning import roofline as jroof
from paddle_tpu.tuning import runtime as jrt
from paddle_tpu.tuning import search as jsearch

import paddle_tpu_torch as tfl
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.tuning import cache as tcache
from paddle_tpu_torch.tuning import registry as treg
from paddle_tpu_torch.tuning import roofline as troof
from paddle_tpu_torch.tuning import runtime as trt
from paddle_tpu_torch.tuning import search as tsearch

PEAK, HBM = 100.0, 1000.0   # explicit peaks both sides price at


@pytest.fixture(autouse=True)
def _clean_tuner_env(monkeypatch):
    """Every test starts untuned on both sides and leaves no env behind."""
    saved = {r: set(r._TUNER_APPLIED) for r in (jreg, treg)}
    for r in (jreg, treg):
        for env in r._TUNER_APPLIED:
            monkeypatch.delenv(env, raising=False)
        r._TUNER_APPLIED.clear()
    for name in ('PADDLE_TPU_TORCH_TUNE', 'PADDLE_TPU_TORCH_TUNE_CACHE_DIR',
                 'PADDLE_TPU_TORCH_AOT_CACHE_DIR', 'PADDLE_TPU_TORCH_AMP',
                 'PADDLE_TPU_TORCH_DEVICE_PREFETCH_CHUNK'):
        monkeypatch.delenv(name, raising=False)
    trt.reset()
    jrt.reset()
    yield
    for r in (jreg, treg):
        for t in r.registered_tunables():
            if t.env in r._TUNER_APPLIED:
                os.environ.pop(t.env, None)
        r._TUNER_APPLIED.clear()
        r._TUNER_APPLIED.update(saved[r])
    trt.reset()
    jrt.reset()


def _norm(trace):
    """A trace with the port's env prefix read as the reference's."""
    out = []
    for e in trace:
        e = dict(e)
        if e.get('reason'):
            e['reason'] = e['reason'].replace('PADDLE_TPU_TORCH_',
                                              'PADDLE_TPU_')
        out.append(e)
    return out


# -- the search -------------------------------------------------------------
_DET = {(1, 'a'): 1.0, (2, 'a'): 0.8, (4, 'a'): 0.7,
        (1, 'b'): 0.9, (2, 'b'): 0.5, (4, 'b'): 0.4}


def _det_model(c):
    return {'score': _DET[(c['tile'], c['mode'])], 'peak_bytes': 0}


def _det_measure(c):
    return _DET[(c['tile'], c['mode'])]


def _tile(reg, domain, default, feasible=None, prefix='PADDLE_TPU_'):
    return reg.Tunable('tile', domain, default, 'test',
                       env=prefix + 'TEST_TILE', feasible=feasible)


def _mode(reg, prefix='PADDLE_TPU_'):
    return reg.Tunable('mode', ('a', 'b'), 'a', 'test',
                       env=prefix + 'TEST_MODE')


# each case: (tunables(reg, prefix), Autotuner kwargs)
SEARCH_CASES = {
    'deterministic': (
        lambda r, p: [_tile(r, (1, 2, 4), 2, prefix=p), _mode(r, p)],
        dict(model_fn=_det_model, measure_fn=_det_measure,
             hbm_budget_bytes=0, measure_budget=100)),
    'ties_keep_the_incumbent': (
        lambda r, p: [_tile(r, (1, 2), 1, prefix=p)],
        dict(model_fn=lambda c: {'score': 1.0, 'peak_bytes': 0},
             measure_fn=lambda c: 1.0, hbm_budget_bytes=0,
             measure_budget=10)),
    'hbm_budget_prunes': (
        lambda r, p: [_tile(r, (1, 2, 4), 1, prefix=p)],
        dict(model_fn=lambda c: {'score': 1.0 / c['tile'],
                                 'peak_bytes': c['tile'] * 10 ** 9},
             measure_fn=lambda c: 1.0 / c['tile'],
             hbm_budget_bytes=2 * 10 ** 9, measure_budget=100)),
    'modeled_worse_prunes': (
        lambda r, p: [_tile(r, (1, 2, 4, 8), 1, prefix=p)],
        dict(model_fn=lambda c: {'score': float(c['tile']),
                                 'peak_bytes': 0},
             measure_fn=lambda c: 1.0, hbm_budget_bytes=0,
             prune_slack=0.15, measure_budget=100)),
    'measure_budget_bounds': (
        lambda r, p: [_tile(r, (1, 2, 4, 8), 1, prefix=p)],
        dict(model_fn=None, measure_fn=lambda c: 1.0 / c['tile'],
             hbm_budget_bytes=0, measure_budget=2)),
    'infeasible_never_measured': (
        lambda r, p: [_tile(r, (1, 2, 4), 1, feasible=lambda v: v != 4,
                            prefix=p), _mode(r, p)],
        dict(model_fn=_det_model, measure_fn=_det_measure,
             hbm_budget_bytes=0, measure_budget=100)),
    'dry_run': (
        lambda r, p: [_tile(r, (1, 2, 4), 2, prefix=p), _mode(r, p)],
        dict(model_fn=_det_model, measure_fn=None, hbm_budget_bytes=0,
             measure_budget=100)),
}


@pytest.mark.parametrize('case', sorted(SEARCH_CASES))
def test_search_equals_the_reference(case):
    make, kw = SEARCH_CASES[case]
    results = []
    for reg, mod, prefix in ((jreg, jsearch, 'PADDLE_TPU_'),
                             (treg, tsearch, 'PADDLE_TPU_TORCH_')):
        calls = []
        kwargs = dict(kw)
        if kwargs['measure_fn'] is not None:
            fn = kwargs['measure_fn']
            kwargs['measure_fn'] = lambda c, fn=fn: calls.append(
                dict(c)) or fn(c)
        r = mod.Autotuner(tunables=make(reg, prefix), **kwargs).search()
        results.append((r, calls))
    (jr, jcalls), (tr, tcalls) = results
    assert tr.winners == jr.winners
    assert tr.config == jr.config
    assert _norm(tr.trace) == jr.trace
    assert tr.measurements == jr.measurements
    assert (tr.base_score, tr.best_score) == (jr.base_score, jr.best_score)
    assert tcalls == jcalls
    assert tr.format_trace() == jr.format_trace().replace(
        'PADDLE_TPU_', 'PADDLE_TPU_TORCH_')
    if case == 'hbm_budget_prunes':
        assert not any(c['tile'] == 4 for c in tcalls)
    if case == 'infeasible_never_measured':
        assert not any(c['tile'] == 4 for c in tcalls)
        assert any(e.get('reason') == 'infeasible on this backend'
                   for e in tr.trace)


def test_pinned_tunable_is_skipped_as_the_reference_skips_it(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TEST_MODE', 'b')
    monkeypatch.setenv('PADDLE_TPU_TORCH_TEST_MODE', 'b')
    out = []
    for reg, mod, p in ((jreg, jsearch, 'PADDLE_TPU_'),
                        (treg, tsearch, 'PADDLE_TPU_TORCH_')):
        r = mod.Autotuner(model_fn=_det_model, measure_fn=_det_measure,
                          tunables=[_tile(reg, (1, 2, 4), 2, prefix=p),
                                    _mode(reg, p)],
                          hbm_budget_bytes=0, measure_budget=100).search()
        out.append(r)
    jr, tr = out
    assert all(e['tunable'] != 'mode' for e in tr.trace[1:])
    assert tr.config['mode'] == 'b'
    assert (tr.winners, _norm(tr.trace), tr.measurements) == \
        (jr.winners, jr.trace, jr.measurements)


# -- the registry -------------------------------------------------------------
def test_registry_is_the_references_less_waiting():
    jnames = [t.name for t in jreg.registered_tunables()]
    want = [treg.RENAMED.get(n, n) for n in jnames
            if n not in treg.WAITING]
    assert [t.name for t in treg.registered_tunables()] == want
    assert set(treg.WAITING) <= set(jnames)
    assert set(treg.WAITING.values()) == {'item 10'}
    for t in treg.registered_tunables():
        assert t.env.startswith('PADDLE_TPU_TORCH_'), t
        assert t.default in t.domain and 1 < len(t.domain) <= 64
        ref = jreg.tunable({v: k for k, v in treg.RENAMED.items()}.get(
            t.name, t.name))
        assert t.scope == ref.scope
        if t.name in treg.RENAMED.values():
            continue
        assert (t.domain, t.default, t.subsystem) == \
            (ref.domain, ref.default, ref.subsystem)
        assert t.env == ref.env.replace('PADDLE_TPU_', 'PADDLE_TPU_TORCH_')
    t = treg.tunable('dense_apply_blocks_per_sm')
    assert (t.domain, t.default) == ((2, 4, 8, 16, 32), 16)
    assert t.env == 'PADDLE_TPU_TORCH_DENSE_APPLY_BLOCKS_PER_SM'


def test_pinning_persistent_apply_and_base_env(monkeypatch):
    t = treg.tunable('device_prefetch_chunk')
    assert not treg.is_pinned(t)
    with treg.applied({t.name: 8}):
        assert os.environ[t.env] == '8'
    assert t.env not in os.environ
    assert treg.apply_persistent({t.name: 4}) == {t.name: 4}
    assert not treg.is_pinned(t)
    with treg.base_env():
        assert t.env not in os.environ
    assert os.environ[t.env] == '4'
    p = treg.tunable('amp')
    monkeypatch.setenv(p.env, 'bf16')
    assert treg.is_pinned(p)
    assert treg.apply_persistent({p.name: 'f16'}) == {}
    assert os.environ[p.env] == 'bf16'


# -- the roofline -----------------------------------------------------------
def _fake_cost():
    return {
        'total': {'flops': 4.0e9, 'bytes': 1.0e8},
        'memory': {'peak_bytes': 123},
        'per_op': [
            {'index': 0, 'type': 'mul', 'role': 'forward',
             'flops': 3.8e11, 'bytes': 1.0e6},
            {'index': 1, 'type': 'relu', 'role': 'forward',
             'flops': 1.0e6, 'bytes': 9.0e7},
            {'index': 2, 'type': 'add', 'role': 'forward',
             'flops': 1.0e5, 'bytes': 9.0e6},
        ],
    }


@pytest.mark.parametrize('measured', [None, 1e-2])
def test_roofline_report_equals_the_reference(measured):
    kw = dict(measured_step_s=measured, peak_tflops=PEAK, hbm_gbps=HBM,
              top=2)
    j = jroof.report(_fake_cost(), **kw)
    t = troof.report(_fake_cost(), **kw)
    assert set(t) - set(j) == {'compute_dtype', 'device'}
    for k in j:
        if k == 'top':
            continue
        assert t[k] == j[k], k
    assert len(t['top']) == len(j['top']) == 2
    for a, b in zip(t['top'], j['top']):
        b = dict(b, bound={'mxu': 'compute'}.get(b['bound'], b['bound']))
        assert a == b
    assert troof.modeled_step_s(_fake_cost(), PEAK, HBM) == \
        jroof.modeled_step_s(_fake_cost(), PEAK, HBM)
    text = troof.format_report(t)
    assert 'peak 100 TFLOP/s' in text and 'hbm 1000 GB/s' in text
    assert 'H100 80GB HBM3' in text


def test_roofline_peak_follows_the_amp_mode(monkeypatch):
    monkeypatch.delenv('PADDLE_TPU_TORCH_PEAK_TFLOPS', raising=False)
    monkeypatch.delenv('PADDLE_TPU_TORCH_HBM_GBPS', raising=False)
    assert troof.resolved_peak_tflops('0') == 67.0
    assert troof.resolved_peak_tflops('bf16') == 989.0
    assert troof.resolved_peak_tflops('f16') == 989.0
    assert troof.resolved_hbm_gbps() == 3350.0
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'bf16')
    rep = troof.report(_fake_cost())
    assert (rep['peak_tflops'], rep['compute_dtype']) == (989.0, 'bfloat16')
    monkeypatch.setenv('PADDLE_TPU_TORCH_PEAK_TFLOPS', '100')
    monkeypatch.setenv('PADDLE_TPU_TORCH_HBM_GBPS', '400')
    rep = troof.report(_fake_cost())
    assert (rep['peak_tflops'], rep['hbm_gbps']) == (100.0, 400.0)


# -- model_program and the dry-run search on a real program ---------------
def _fc_program(pkg, prog_mod):
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[32], dtype='float32')
            label = pkg.layers.data(name='label', shape=[1],
                                    dtype='int64')
            h = pkg.layers.fc(input=x, size=64, act='relu')
            pred = pkg.layers.fc(input=h, size=10, act='softmax')
            cost = pkg.layers.mean(x=pkg.layers.cross_entropy(
                input=pred, label=label))
            pkg.optimizer.SGDOptimizer(0.1).minimize(cost)
    return main, startup, cost


_SPECS = {'x': ((8, 32), 'float32'), 'label': ((8, 1), 'int32')}


def _model_fn(reg, rt, prog, cost):
    def model_fn(cfg):
        with reg.applied(cfg):
            return rt.model_program(prog, fetch_names=(cost.name,),
                                    feed_specs=_SPECS, peak_tflops=PEAK,
                                    hbm_gbps=HBM)
    return model_fn


def test_model_program_and_dry_run_search_equal_the_reference():
    jp, _js, jc = _fc_program(fluid, jprog)
    tp, _ts, tc = _fc_program(tfl, tprog)
    jm, tm = _model_fn(jreg, jrt, jp, jc), _model_fn(treg, trt, tp, tc)
    for amp in ('0', 'bf16', 'f16'):
        a, b = jm({'amp': amp}), tm({'amp': amp})
        assert b['score'] == a['score'] and b['score'] > 0, amp
        assert b['peak_bytes'] == a['peak_bytes'] > 0, amp
    names = ('amp', 'device_prefetch_chunk')
    jr = jsearch.Autotuner(jm, tunables=[jreg.tunable(n) for n in names],
                           hbm_budget_bytes=0, measure_budget=100).search()
    tr = tsearch.Autotuner(tm, tunables=[treg.tunable(n) for n in names],
                           hbm_budget_bytes=0, measure_budget=100).search()
    assert tr.winners == jr.winners
    assert tr.trace == jr.trace
    assert tr.best_score <= tr.base_score


# -- the cache ----------------------------------------------------------------
def _counter(name):
    fam = tobs.snapshot().get(name) or {}
    return sum(smp['value'] for smp in fam.get('samples', ()))


def test_cache_round_trip_and_keying(tmp_path):
    c = tcache.TuneCache(str(tmp_path))
    keys = {c.key(('pm', 2, 'bf16'), 'cpu', ''),
            c.key(('pm', 2, None), 'cpu', ''),
            c.key(('pm', 2, 'bf16'), 'cpu', 'dp=2'),
            c.key(('pm', 2, 'bf16'), 'NVIDIA H100 80GB HBM3', '')}
    assert len(keys) == 4
    k = c.key(('pm', 2, 'bf16'), 'cpu', '')
    before = tcache.TuneCache.stats()
    assert c.load(k) is None
    assert c.store(k, {'amp': 'bf16'}, meta={'base_score': 1.0})
    assert c.load(k) == {'amp': 'bf16'}
    after = tcache.TuneCache.stats()
    assert after['misses'] == before['misses'] + 1
    assert after['hits'] == before['hits'] + 1
    assert after['stores'] == before['stores'] + 1
    assert os.path.dirname(c.path(k)).endswith('paddle_tpu_tuning')


def test_corrupted_cache_file_is_counted_and_read_as_a_miss(tmp_path):
    c = tcache.TuneCache(str(tmp_path))
    k = c.key(('pm',), 'cpu', '')
    assert c.store(k, {'amp': 'bf16'})
    before = tcache.TuneCache.stats()['corrupt']
    metric = _counter('paddle_tpu_tune_cache_corrupt_total')
    with open(c.path(k), 'w') as f:
        f.write('{not json')
    assert c.load(k) is None
    with open(c.path(k), 'w') as f:
        json.dump({'schema': 999, 'winners': {'amp': 'bf16'}}, f)
    assert c.load(k) is None
    assert tcache.TuneCache.stats()['corrupt'] == before + 2
    assert _counter('paddle_tpu_tune_cache_corrupt_total') == metric + 2


def test_cache_dir_resolution(tmp_path, monkeypatch):
    c = tcache.TuneCache()
    assert not c.enabled()
    assert c.load('deadbeef') is None
    assert not c.store('deadbeef', {'amp': 'bf16'})
    monkeypatch.setenv('PADDLE_TPU_TORCH_AOT_CACHE_DIR', str(tmp_path / 'a'))
    assert tcache.TuneCache().root == str(tmp_path / 'a' /
                                          'paddle_tpu_tuning')
    monkeypatch.setenv('PADDLE_TPU_TORCH_TUNE_CACHE_DIR', str(tmp_path / 't'))
    assert tcache.TuneCache().root == str(tmp_path / 't' /
                                          'paddle_tpu_tuning')


def test_autotune_cached_mode_does_no_search(tmp_path):
    tun = [_tile(treg, (1, 2, 4), 2, prefix='PADDLE_TPU_TORCH_'),
           _mode(treg, 'PADDLE_TPU_TORCH_')]
    cache = tcache.TuneCache(str(tmp_path))
    key = cache.key(('pm', 2), 'cpu', '')
    r = tsearch.autotune(lambda c: {'score': 1.0 / c['tile'],
                                    'peak_bytes': 0},
                         tunables=tun, cache=cache, cache_key=key)
    assert not r.cached and r.winners == {'tile': 4}

    def boom(c):
        raise AssertionError('cached mode must not search or measure')

    r2 = tsearch.autotune(boom, measure_fn=boom, tunables=tun, cache=cache,
                          cache_key=key, mode='cached')
    assert r2.cached and r2.winners == {'tile': 4}
    assert 'cache hit' in r2.format_trace()
    r3 = tsearch.autotune(boom, measure_fn=boom, tunables=tun, cache=cache,
                          cache_key=cache.key(('pm', 3), 'cpu', ''),
                          mode='cached')
    assert not r3.cached and r3.winners == {}
    assert tsearch.autotune(boom, mode='off') is None


def test_cache_key_stable_under_tuner_env_and_by_program():
    a = _fc_program(tfl, tprog)[0]
    with tprog.reset_unique_name_guard():
        a2 = _fc_program(tfl, tprog)[0]
        main = tfl.Program()
        with tfl.program_guard(main, tfl.Program()):
            x = tfl.layers.data(name='x', shape=[4], dtype='float32')
            y = tfl.layers.data(name='y', shape=[1], dtype='float32')
            loss = tfl.layers.mean(x=tfl.layers.square_error_cost(
                input=tfl.layers.fc(input=x, size=1), label=y))
            tfl.optimizer.SGDOptimizer(0.01).minimize(loss)
    key = trt.cache_key_for(a, 'cpu')
    assert trt.cache_key_for(a2, 'cpu') == key
    assert trt.cache_key_for(main, 'cpu') != key
    treg.apply_persistent({'amp': 'bf16'})
    assert trt.cache_key_for(a, 'cpu') == key
    os.environ.pop('PADDLE_TPU_TORCH_AMP')
    treg._TUNER_APPLIED.discard('PADDLE_TPU_TORCH_AMP')
    os.environ['PADDLE_TPU_TORCH_AMP'] = 'bf16'   # a user's pin
    try:
        assert trt.cache_key_for(a, 'cpu') != key
    finally:
        os.environ.pop('PADDLE_TPU_TORCH_AMP')
    assert trt.device_kind('cpu') == 'cpu'


# -- the executor -------------------------------------------------------------
def _feed():
    rng = np.random.default_rng(0)
    return {'x': rng.normal(size=(8, 32)).astype(np.float32),
            'label': rng.integers(0, 10, (8, 1)).astype(np.int64)}


def test_executor_applies_cached_winners(tmp_path, monkeypatch):
    prog, startup, cost = _fc_program(tfl, tprog)
    monkeypatch.setenv('PADDLE_TPU_TORCH_TUNE_CACHE_DIR', str(tmp_path))
    tcache.TuneCache(str(tmp_path)).store(
        trt.cache_key_for(prog, 'cpu'), {'device_prefetch_chunk': 4})
    monkeypatch.setenv('PADDLE_TPU_TORCH_TUNE', 'cached')
    hits = tcache.TuneCache.stats()['hits']
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    out = exe.run(prog, feed=_feed(), fetch_list=[cost], scope=scope)
    exe.run(prog, feed=_feed(), fetch_list=[cost], scope=scope)
    assert np.isfinite(out[0]).all()
    assert os.environ['PADDLE_TPU_TORCH_DEVICE_PREFETCH_CHUNK'] == '4'
    assert 'PADDLE_TPU_TORCH_DEVICE_PREFETCH_CHUNK' in \
        treg.tuner_applied_env()
    # one lookup for the main program: memoised per (uid, version)
    assert tcache.TuneCache.stats()['hits'] == hits + 1


def test_tune_off_is_bitwise_untuned(tmp_path, monkeypatch):
    prog, startup, cost = _fc_program(tfl, tprog)
    prog.random_seed = startup.random_seed = 7
    tcache.TuneCache(str(tmp_path)).store(
        trt.cache_key_for(prog, 'cpu'), {'device_prefetch_chunk': 4})
    monkeypatch.setenv('PADDLE_TPU_TORCH_TUNE_CACHE_DIR', str(tmp_path))
    env_before = dict(os.environ)

    def two_steps():
        exe = tfl.Executor(tfl.CPUPlace())
        scope = tfl.Scope()
        exe.run(startup, scope=scope)
        return [exe.run(prog, feed=_feed(), fetch_list=[cost],
                        scope=scope)[0] for _ in range(2)]

    first = two_steps()
    assert trt.maybe_apply_cached(prog, 'cpu') is None
    second = two_steps()
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    assert dict(os.environ) == env_before


def test_tune_trace_flag_prints_a_searchs_trace(monkeypatch, capsys):
    tun = [_tile(treg, (1, 2, 4), 2, prefix='PADDLE_TPU_TORCH_')]
    model = lambda c: {'score': 1.0 / c['tile'], 'peak_bytes': 0}  # noqa
    tsearch.autotune(model, tunables=tun, cache=tcache.TuneCache(''))
    assert capsys.readouterr().err == ''
    monkeypatch.setenv('PADDLE_TPU_TORCH_TUNE_TRACE', '1')
    r = tsearch.autotune(model, tunables=tun, cache=tcache.TuneCache(''))
    assert capsys.readouterr().err.strip() == r.format_trace()

"""Multi-tenant serving (paddle_tpu_torch/inference/tenancy.py and the
fleet's tenancy) on the CPU: the contracts of tests/test_tenancy.py.

- Registry and planner units, each also run through the reference's
  module (paddle_tpu/inference/tenancy.py) on the same seeded inputs,
  whose outputs must be identical: SLO parameters, flag-scaled quotas,
  the eviction plan over random candidates, the admission error, and a
  seeded script of ``ensure`` / ``admit`` / ``release_one`` /
  ``take_deferred`` / ``drain_all`` calls on both registries (the
  weighted round-robin drain order included).
- Fleet integration over three exported 6 -> 16 -> 4 MLPs (max batch 4):
  tenants with their own records; the implicit default tenant; an
  over-budget deploy rejected before any build under ``enforce``; an
  enforced deploy that evicts the cold tenant's buckets, which re-warm
  on its next request, counted; quotas that defer and never drop; close
  failing parked requests instead of hanging; a fresh server set over a
  warm AOT cache with zero compiles; a poisoned AOT entry falling back
  to a counted compile; a redeploy of the resident version reusing its
  servable.
"""
import os

import numpy as np
import pytest

from paddle_tpu.inference import tenancy as jtenancy

import paddle_tpu_torch as tfl
from paddle_tpu_torch import io
from paddle_tpu_torch.inference import (AdmissionError, AotCache,
                                        ServingFleet, export_bucketed)
from paddle_tpu_torch.inference import tenancy

MAX_BATCH = 4
CLASSES = ('gold', 'silver', 'bronze')


# -- registry / planner units, against the reference ---------------------
def test_slo_params_and_unknown_class():
    w_gold, s_gold = tenancy.slo_params('gold')
    w_bronze, s_bronze = tenancy.slo_params('bronze')
    assert w_gold > w_bronze and s_gold < 1.0 < s_bronze
    assert tenancy.slo_params('silver')[1] == 1.0
    for c in CLASSES:
        assert tenancy.slo_params(c) == jtenancy.slo_params(c)
    with pytest.raises(ValueError, match='unknown SLO class'):
        tenancy.slo_params('platinum')


def test_effective_quota(monkeypatch):
    assert tenancy.effective_quota(7, 'bronze') == 7
    assert tenancy.effective_quota(None, 'gold') == 0
    for base in ('0', '1', '16', '100'):
        monkeypatch.setenv('PADDLE_TPU_TORCH_FLEET_TENANT_QUOTA', base)
        monkeypatch.setenv('PADDLE_TPU_FLEET_TENANT_QUOTA', base)
        for quota in (None, 0, 3, 7):
            for c in CLASSES:
                assert tenancy.effective_quota(quota, c) == \
                    jtenancy.effective_quota(quota, c), (base, quota, c)
    monkeypatch.setenv('PADDLE_TPU_TORCH_FLEET_TENANT_QUOTA', '16')
    assert [tenancy.effective_quota(None, c) for c in CLASSES] == [16, 8, 2]


def _candidates(rng, n):
    return [{'tenant': 't%d' % rng.integers(0, 3),
             'tenant_last_used': float(rng.integers(0, 4)),
             'bucket': int(2 ** rng.integers(0, 4)),
             'bucket_last_used': float(rng.integers(0, 4)),
             'bytes': int(rng.integers(1, 100)), 'payload': i}
            for i in range(n)]


def test_plan_eviction_orders_coldest_first():
    cands = [
        {'tenant': 'hot', 'tenant_last_used': 100.0, 'bucket': 1,
         'bucket_last_used': 99.0, 'bytes': 50},
        {'tenant': 'cold', 'tenant_last_used': 10.0, 'bucket': 4,
         'bucket_last_used': 9.0, 'bytes': 40},
        {'tenant': 'cold', 'tenant_last_used': 10.0, 'bucket': 2,
         'bucket_last_used': 5.0, 'bytes': 30},
    ]
    plan, freed = tenancy.plan_eviction(cands, 60)
    assert [(c['tenant'], c['bucket']) for c in plan] == \
        [('cold', 2), ('cold', 4)]
    assert freed == 70
    assert tenancy.plan_eviction(cands, 0) == ([], 0)
    tied = [dict(c, tenant_last_used=1.0, bucket_last_used=1.0)
            for c in cands]
    plan, _ = tenancy.plan_eviction(tied, 10)
    assert plan[0]['bytes'] == 50
    rng = np.random.default_rng(26)
    for _ in range(50):
        cands = _candidates(rng, int(rng.integers(0, 12)))
        need = int(rng.integers(-10, 400))
        assert tenancy.plan_eviction(cands, need) == \
            jtenancy.plan_eviction(cands, need)


def test_admission_error_payload():
    args = dict(budget_bytes=100, live_bytes=80, incoming_bytes=60,
                freed_bytes=20)
    e = AdmissionError('t', 'v7', **args)
    j = jtenancy.AdmissionError('t', 'v7', **args)
    assert e.projected_bytes == j.projected_bytes == 140
    assert str(e) == str(j)
    assert 'rejected' in str(e) and 'v7' in str(e)
    assert isinstance(e, RuntimeError)


def test_registry_quota_park_and_release():
    reg = tenancy.TenantRegistry()
    reg.ensure('a', slo_class='silver', quota=2)
    assert reg.admit('a', 'r1') and reg.admit('a', 'r2')
    assert not reg.admit('a', 'r3')
    assert reg.pending_total() == 1
    assert reg.info('a')['deferred'] == 1
    assert reg.take_deferred() == []
    reg.release_one('a')
    assert reg.take_deferred() == [('a', 'r3')]
    assert reg.pending_total() == 0
    reg.ensure('free', quota=0)
    assert all(reg.admit('free', i) for i in range(100))


def _script(reg, seed):
    """A seeded sequence of registry calls; returns every output."""
    rng = np.random.default_rng(seed)
    names = ['g', 's', 'b', 'x']
    out = [reg.ensure('g', 'gold', 3), reg.ensure('s', 'silver', 2),
           reg.ensure('b', 'bronze', 4), reg.ensure('x', None, 0)]
    for i in range(400):
        op = rng.integers(0, 10)
        name = names[rng.integers(0, 4)]
        if op < 5:
            out.append(('admit', reg.admit(name, i)))
        elif op < 8:
            reg.release_one(name)
        elif op < 9:
            out.append(('take', reg.take_deferred(
                int(rng.integers(1, 6)))))
        else:
            out.append(('pending', reg.pending_total()))
    out.append(('take', reg.take_deferred(1000)))
    out.append(('drain', sorted(reg.drain_all())))
    for n in names:
        info = reg.info(n)
        out.append((n, info['outstanding'], info['submitted'],
                    info['deferred'], info['quota']))
    return out


def test_registry_wrr_drain_is_weighted_not_starving():
    reg = tenancy.TenantRegistry()
    reg.ensure('g', slo_class='gold', quota=9)
    reg.ensure('b', slo_class='bronze', quota=9)
    for name in ('g', 'b'):
        for i in range(9):
            assert reg.admit(name, i)
        for i in range(9):
            assert not reg.admit(name, i)
        for _ in range(9):
            reg.release_one(name)
    names = [n for n, _ in reg.take_deferred(max_items=9)]
    assert names.count('g') == 8 and names.count('b') == 1
    for seed in (0, 1, 2):
        assert _script(tenancy.TenantRegistry(), seed) == \
            _script(jtenancy.TenantRegistry(), seed)


def test_registry_drain_all_ignores_quota():
    reg = tenancy.TenantRegistry()
    reg.ensure('a', quota=1)
    reg.admit('a', 'live')
    for i in range(3):
        reg.admit('a', i)
    assert len(reg.drain_all()) == 3
    assert reg.pending_total() == 0


def test_registry_regrade_rederives_flag_quota(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_FLEET_TENANT_QUOTA', '16')
    monkeypatch.setenv('PADDLE_TPU_FLEET_TENANT_QUOTA', '16')
    for mod in (tenancy, jtenancy):
        reg = mod.TenantRegistry()
        assert reg.ensure('t', slo_class='bronze')[3] == 2
        assert reg.ensure('t', slo_class='gold')[3] == 16
        assert reg.ensure('t', slo_class='bronze', quota=5)[3] == 5


# -- fleet integration ----------------------------------------------------
def _build_mlp(seed):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = seed
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[6], dtype='float32')
        h = tfl.layers.fc(input=x, size=16, act='relu')
        pred = tfl.layers.fc(input=h, size=4)
    exe, scope = tfl.Executor('cpu'), tfl.Scope()
    exe.run(startup, scope=scope)
    return main, scope, exe, pred


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """Three exported models (different seeds), one directory each."""
    base = tmp_path_factory.mktemp('tenant_models')
    out = {}
    for name, seed in (('a', 11), ('b', 42), ('c', 77)):
        main, scope, exe, pred = _build_mlp(seed)
        d = str(base / name)
        export_bucketed(d, {'x': (6,)}, [pred], executor=exe,
                        main_program=main, scope=scope, max_batch=MAX_BATCH)
        out[name] = d
    return out


def _feed(rows=2):
    rng = np.random.RandomState(0)
    return {'x': rng.randn(rows, 6).astype('float32')}


def _mk_fleet(vdir, **kw):
    kw.setdefault('replicas', 1)
    kw.setdefault('max_wait_ms', 20.0)
    kw.setdefault('linger_ms', 0.5)
    kw.setdefault('health_interval_ms', 0)
    kw.setdefault('device', 'cpu')
    return ServingFleet(vdir, **kw)


def test_multi_tenant_deploy_route_and_records(models, tmp_path):
    state = str(tmp_path / 'state')
    fleet = _mk_fleet(models['a'], state_dir=state, tenant='alpha',
                      slo_class='gold')
    try:
        fleet.deploy(models['b'], replicas=1, tenant='beta',
                     slo_class='bronze')
        ra = fleet.predict(_feed(), timeout=30.0, tenant='alpha')
        rb = fleet.predict(_feed(), timeout=30.0, tenant='beta')
        assert not np.allclose(ra[0], rb[0])
        st = fleet.stats()
        assert sorted(st['tenants']) == ['alpha', 'beta']
        assert st['tenants']['alpha']['slo_class'] == 'gold'
        assert st['tenants']['beta']['slo_class'] == 'bronze'
        assert {p['tenant'] for p in st['replicas']} == {'alpha', 'beta'}
        assert sorted(fleet.tenants()) == ['alpha', 'beta']
        assert fleet.deployment(tenant='alpha')['tenant'] == 'alpha'
        assert fleet.deployment(tenant='beta')['slo_class'] == 'bronze'
        assert os.path.exists(os.path.join(state, 'DEPLOY_beta.json'))
        with pytest.raises(ValueError, match='pass tenant='):
            fleet.submit(_feed())
        with pytest.raises(ValueError, match='no tenant'):
            fleet.submit(_feed(), tenant='nobody')
        prot = [os.path.abspath(p) for p in fleet.protected_version_dirs()]
        assert os.path.abspath(models['a']) in prot
        assert os.path.abspath(models['b']) in prot
    finally:
        fleet.close()


def test_single_tenant_defaults_are_implicit(models):
    fleet = _mk_fleet(models['a'])
    try:
        fleet.predict(_feed(), timeout=30.0)
        st = fleet.stats()
        assert list(st['tenants']) == [tenancy.DEFAULT_TENANT]
        t = st['tenants'][tenancy.DEFAULT_TENANT]
        assert t['slo_class'] == 'silver'
        assert t['wait_scale'] == 1.0 and t['quota'] == 0
        assert st['admission_mode'] == 'warn'
        assert st['quota_deferred'] == 0
    finally:
        fleet.close()


def test_enforce_rejects_over_budget_before_build(models):
    fleet = _mk_fleet(models['a'], hbm_admission='enforce')
    try:
        n_before = len(fleet._replicas)
        with pytest.raises(AdmissionError) as ei:
            fleet.deploy(models['b'], replicas=1, tenant='beta',
                         hbm_budget_bytes=1)
        assert ei.value.tenant == 'beta'
        assert ei.value.budget_bytes == 1
        st = fleet.stats()
        assert st['admission_rejections'] == 1
        assert st['hbm_budget_precheck_failures'] == 1
        assert len(fleet._replicas) == n_before
        assert 'beta' not in fleet.tenants()
        assert fleet.deployment(tenant='beta') is None
        fleet.predict(_feed(), timeout=30.0)
    finally:
        fleet.close()


def test_enforce_evicts_cold_tenant_then_rewarms_counted(models):
    fleet = _mk_fleet(models['a'], tenant='cold', hbm_admission='enforce')
    try:
        fleet.deploy(models['b'], replicas=1, tenant='hot')
        fleet.predict(_feed(), timeout=30.0, tenant='cold')
        fleet.predict(_feed(), timeout=30.0, tenant='hot')
        resident = fleet.stats()['resident_bytes']
        cold_rep, = [r for r in fleet._replicas if r.tenant == 'cold']
        cold_bytes = cold_rep.server.resident_bytes()['total_bytes']
        incoming = sum(os.path.getsize(p) for p in
                       io.bucket_artifacts(models['c']).values())
        budget = resident + incoming - cold_bytes + 16
        fleet.deploy(models['c'], replicas=1, tenant='third',
                     hbm_budget_bytes=budget)
        st = fleet.stats()
        assert st['evictions'] >= 1
        assert st['tenants']['cold']['evicted_buckets'] >= 1
        assert st['tenants']['hot']['evicted_buckets'] == 0
        before = cold_rep.server.stats()['compiles_after_warmup']
        out = fleet.predict(_feed(), timeout=30.0, tenant='cold')
        assert out[0].shape == (2, 4)
        assert cold_rep.server.stats()['compiles_after_warmup'] > before
    finally:
        fleet.close()


def test_quota_defers_never_drops(models):
    fleet = _mk_fleet(models['a'], tenant='q', quota=1, max_wait_ms=1.0)
    try:
        futs = [fleet.submit(_feed(1), tenant='q') for _ in range(16)]
        outs = [f.result(timeout=60) for f in futs]
        assert len(outs) == 16
        assert all(o[0].shape == (1, 4) for o in outs)
        st = fleet.stats()
        assert st['tenants']['q']['quota'] == 1
        assert st['quota_deferred'] >= 1
        assert st['quota_pending'] == 0
        assert st['completed'] == 16 and st['failed'] == 0
    finally:
        fleet.close()


def test_close_fails_parked_requests_instead_of_hanging(models):
    fleet = _mk_fleet(models['a'], tenant='q', quota=1, max_wait_ms=1.0)
    futs = [fleet.submit(_feed(1), tenant='q') for _ in range(8)]
    fleet.close()
    for f in futs:
        assert f.done()
        if f.exception() is not None:
            assert ('quota queue' in str(f.exception())
                    or 'no routable replica' in str(f.exception()))


def test_cold_start_zero_compiles_from_warm_aot_cache(models, tmp_path,
                                                      monkeypatch):
    """A second fleet over a warm AOT cache readies every bucket from its
    entries: compile counters at 0 through warmup and serving, one hit a
    bucket, the same answers bitwise."""
    monkeypatch.setenv('PADDLE_TPU_TORCH_AOT_CACHE_DIR',
                       str(tmp_path / 'aot'))
    n_buckets = len(io.bucket_artifacts(models['a']))
    s0 = AotCache.stats()
    fleet = _mk_fleet(models['a'], replicas=2)
    try:
        assert fleet.stats()['replicas'][0]['compiles'] == n_buckets
        want = fleet.predict(_feed(), timeout=30.0)
    finally:
        fleet.close()
    assert AotCache.stats()['stores'] - s0['stores'] == n_buckets
    s1 = AotCache.stats()
    fleet2 = _mk_fleet(models['a'], replicas=2)
    try:
        for p in fleet2.stats()['replicas']:
            assert p['compiles'] == 0 and p['compiles_after_warmup'] == 0
        assert AotCache.stats()['hits'] - s1['hits'] == n_buckets
        got = fleet2.predict(_feed(), timeout=30.0)
        np.testing.assert_array_equal(got[0], want[0])
        assert all(p['compiles'] == 0 and p['compiles_after_warmup'] == 0
                   for p in fleet2.stats()['replicas'])
    finally:
        fleet2.close()


def test_poisoned_aot_entry_falls_back_to_compile(models, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_AOT_CACHE_DIR',
                       str(tmp_path / 'aot'))
    n_buckets = len(io.bucket_artifacts(models['b']))
    _mk_fleet(models['b']).close()
    cache = AotCache()
    entries = [e for e in os.listdir(cache.root)
               if e.startswith('aot_') and e.endswith('.bin')]
    assert len(entries) == n_buckets
    for e in entries:   # poison every body, keep the headers
        p = os.path.join(cache.root, e)
        with open(p, 'rb') as f:
            hdr = f.readline()
        with open(p, 'wb') as f:
            f.write(hdr + b'\x00not-a-zip')
    s0 = AotCache.stats()
    fleet2 = _mk_fleet(models['b'])
    try:
        assert fleet2.stats()['replicas'][0]['compiles'] == n_buckets
        assert AotCache.stats()['corrupt'] - s0['corrupt'] == n_buckets
        fleet2.predict(_feed(), timeout=30.0)
    finally:
        fleet2.close()


def test_redeploy_resident_version_reuses_servable(models):
    fleet = _mk_fleet(models['a'], replicas=2)
    try:
        st = fleet.stats()
        resident = st['resident_bytes']
        assert st['hbm_budget_precheck_failures'] == 0
        fleet.deploy(models['a'], replicas=2, hbm_budget_bytes=resident)
        st = fleet.stats()
        assert st['hbm_budget_precheck_failures'] == 0
        assert st['admission_rejections'] == 0
        assert all(p['compiles'] == 0 for p in st['replicas'])
        fleet.predict(_feed(), timeout=30.0)
    finally:
        fleet.close()

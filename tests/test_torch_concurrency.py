"""The port's concurrency analyzer and lock watchdog
(paddle_tpu_torch/analysis/) against the reference's (paddle_tpu/analysis/).

- The analyzer: on every fixture of tests/test_concurrency_lint.py (its
  module-level sources) and on the sweep of paddle_tpu/, the port's
  ``Report`` equals the reference's: findings, waivers, entrypoints,
  order edges, the guarded-by map and the class count.
- The sweep of paddle_tpu_torch/ reports no unwaived finding, and
  ``StagingArena._free`` carries the reference's waiver and reason.
- ``lockdebug``: disarmed, the factories return plain ``threading``
  primitives; armed, an inverted acquisition is counted in
  ``paddle_tpu_lock_order_violations_total`` and recorded, the static
  graph is the port's sweep's, and a decode server serves under it with
  no violation.
- The servers create their locks under the reference's names.
"""
import ast
import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.analysis import concurrency as jconc

from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.analysis import concurrency as tconc
from paddle_tpu_torch.analysis import lockdebug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixtures():
    """{NAME: source} of the reference test module's fixture sources."""
    path = os.path.join(REPO, 'tests', 'test_concurrency_lint.py')
    spec = importlib.util.spec_from_file_location('_ref_concurrency_lint',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, str) and 'class ' in v}


FIXTURES = _fixtures()


def _as_tuple(rep):
    return (rep.findings, rep.waived, rep.entrypoints,
            sorted(rep.order_edges.items()), sorted(rep.guarded_by.items()),
            rep.classes)


def test_fixtures_are_found():
    assert len(FIXTURES) >= 10, sorted(FIXTURES)


@pytest.mark.parametrize('name', sorted(FIXTURES))
def test_fixture_report_equals_the_reference(name):
    import textwrap
    src = textwrap.dedent(FIXTURES[name])
    j = jconc.analyze_source(src, path='fixture.py')
    t = tconc.analyze_source(src, path='fixture.py')
    assert _as_tuple(t) == _as_tuple(j)
    assert t.errors() == j.errors()


def test_reference_sweep_equals_the_reference():
    root = os.path.join(REPO, 'paddle_tpu')
    j = jconc.analyze_package(root)
    t = tconc.analyze_package(root)
    assert _as_tuple(t) == _as_tuple(j)
    assert t.findings == []


def test_port_sweep_has_no_unwaived_finding(port_report):
    rep = port_report
    assert rep.errors() == []
    assert rep.classes >= 12 and len(rep.entrypoints) >= 13
    waived = {(f.cls, f.field) for f, _ in rep.waived}
    assert ('StagingArena', '_free') in waived
    ref = jconc.analyze_package(os.path.join(REPO, 'paddle_tpu'))
    reason = {r for f, r in ref.waived if f.cls == 'StagingArena'}
    assert {r for f, r in rep.waived if f.cls == 'StagingArena'} == reason
    # the fleet's deploy lock is taken before its route lock and the
    # tenant registry's, as in the reference
    assert ('ServingFleet._deploy_lock', 'ServingFleet._lock') in \
        rep.order_edges
    assert ('ServingFleet._deploy_lock', 'TenantRegistry._lock') in \
        rep.order_edges


_SERVER_FILES = ('batching.py', 'decode.py', 'fleet.py', 'tenancy.py')


def _factory_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr.startswith('make_') and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.append((node.func.attr, node.args[0].value))
    return sorted(out)


@pytest.mark.parametrize('fname', _SERVER_FILES)
def test_server_locks_carry_the_reference_names(fname):
    t = _factory_names(os.path.join(REPO, 'paddle_tpu_torch', 'inference',
                                    fname))
    j = _factory_names(os.path.join(REPO, 'paddle_tpu', 'inference', fname))
    assert t and t == j


@pytest.fixture(scope='module')
def port_report():
    return tconc.analyze_package()


@pytest.fixture
def armed(port_report):
    """The watchdog armed, its static graph the port sweep's (installed
    from one sweep of this module; load_static_edges has its own test)."""
    lockdebug.set_enabled(True)
    lockdebug.reset_state()
    lockdebug.install_static_edges(port_report.order_edges)
    lockdebug._static_loaded = True
    yield lockdebug
    lockdebug.set_enabled(False)
    lockdebug.reset_state()
    lockdebug.reload_enabled()


def _violations_metric():
    fam = tobs.snapshot().get('paddle_tpu_lock_order_violations_total') or {}
    return sum(s['value'] for s in fam.get('samples', ()))


def test_disarmed_factories_are_plain_threading():
    lockdebug.set_enabled(False)
    try:
        lk = lockdebug.make_lock('X._l')
        assert type(lk) is type(threading.Lock())
        assert type(lockdebug.make_rlock('X._r')) is \
            type(threading.RLock())
        cv = lockdebug.make_condition('X._cv', lk)
        cv2 = lockdebug.make_condition('X._cv', lk)
        assert isinstance(cv, threading.Condition)
        assert cv._lock is lk and cv2._lock is lk
    finally:
        lockdebug.reload_enabled()


def test_flag_arms_the_factories(monkeypatch):
    lockdebug.reload_enabled()
    monkeypatch.setenv('PADDLE_TPU_TORCH_LOCK_DEBUG', '1')
    assert lockdebug.enabled()
    monkeypatch.delenv('PADDLE_TPU_TORCH_LOCK_DEBUG')
    assert not lockdebug.enabled()


def test_armed_inversion_is_counted_and_recorded(armed):
    a, b = armed.make_lock('T.A'), armed.make_lock('T.B')
    before = _violations_metric()

    def forward():
        with a:
            with b:
                pass

    t = threading.Thread(target=forward)
    t.start()
    t.join()
    assert armed.violations() == []
    with b:
        with a:       # the inverse of the order the other thread showed
            pass
    v = armed.violations()
    assert len(v) == 1
    assert (v[0]['acquiring'], v[0]['inverted_against'], v[0]['held']) == \
        ('T.A', 'T.B', ['T.B'])
    assert 'test_torch_concurrency' in v[0]['stack']
    assert _violations_metric() == before + 1


def test_armed_static_graph_is_the_port_sweeps(armed):
    armed.reset_state()
    armed.load_static_edges()
    edges = armed.order_edges()
    assert 'ServingFleet._lock' in edges['ServingFleet._deploy_lock']
    inner = armed.make_lock('ServingFleet._lock')
    outer = armed.make_lock('ServingFleet._deploy_lock')
    with inner:
        with outer:   # the sweep's order is _deploy_lock -> _lock
            pass
    assert [x['acquiring'] for x in armed.violations()] == \
        ['ServingFleet._deploy_lock']


def test_condition_wait_and_rlock_bookkeeping(armed):
    raw = threading.Lock()
    cv = armed.make_condition('T.CV', raw)
    cv2 = armed.make_condition('T.CV', raw)
    with cv:
        cv2.notify_all()
        cv.wait(0.005)
        with armed.make_lock('T.Other'):
            pass
    r = armed.make_rlock('T.R')
    with r:
        with r:
            pass
    assert armed.violations() == [] and armed._stack() == []
    assert 'T.R' not in armed.order_edges().get('T.R', set())


def test_servers_run_armed_without_violations(armed):
    from paddle_tpu_torch.inference.decode import DecodeEngine, DecodeServer
    from paddle_tpu_torch.inference.tenancy import TenantRegistry
    from paddle_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_params)
    reg = TenantRegistry()
    assert reg._lock.name == 'TenantRegistry._lock'
    cfg = TransformerConfig(50, 32, 1, 16, 2)
    eng = DecodeEngine(init_params(cfg, torch.Generator().manual_seed(0),
                                   'cpu'),
                       n_layers=1, n_heads=2, page_size=8, max_streams=2,
                       prefill_bucket=16, device='cpu')
    srv = DecodeServer(eng)
    try:
        assert srv._cv.name == 'DecodeServer._cv'
        futs = [srv.submit(np.array([1, 2, 3 + i]), max_new_tokens=3)
                for i in range(3)]
        assert [len(f.result(60)) for f in futs] == [3, 3, 3]
    finally:
        srv.close()
    assert armed.violations() == []

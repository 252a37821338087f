"""The port's profiler (paddle_tpu_torch/profiler.py, on
``torch.profiler``) and NaN / Inf guards (paddle_tpu_torch/debug.py)
against the reference's, on the CPU.

- ``RecordEvent`` records into the shared ring, bounded by the event cap
  as the reference's is; ``get_events`` keeps only the ``user``
  category; ``reset_profiler`` clears the ring.
- ``profiler(sorted_key=...)`` writes a Chrome trace under its log dir
  and ``profile_table`` tabulates it in the reference's columns (on the
  CPU the trace has no device events, so its host ops are the rows);
  a bad key raises as in the reference.
- ``cost_analysis`` gives the reference's keys, its FLOPs the cost
  model's (2 x 4 x 16 x 32 + 2 x 4 x 32 x 4 for the mlp forward, plus the
  backward's twice that).
- ``has_nan_inf`` / ``check_nan_inf`` / ``guarded_fetches`` give the
  reference's verdicts and message on the same arrays (and on tensors).
- ``nan_guard()`` makes the executor raise FloatingPointError naming the
  first op that wrote a NaN (a planted NaN fed to the net: its ``mul``),
  and a gradient's autodiff op; disarmed, the same run returns NaN
  without raising; PADDLE_TPU_TORCH_CHECK_NAN_INF=1 arms it for a
  process.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu import debug as jdebug
from paddle_tpu import profiler as jprofiler

import paddle_tpu_torch as tfl
from paddle_tpu_torch import debug as tdebug
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.observability import timeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv('PADDLE_TPU_TORCH_PROFILER_EVENT_CAP', raising=False)
    tprofiler.reset_profiler()
    yield
    tprofiler.reset_profiler()


@pytest.mark.parametrize('pkg,env', [
    (tprofiler, 'PADDLE_TPU_TORCH_PROFILER_EVENT_CAP'),
    (jprofiler, 'PADDLE_TPU_PROFILER_EVENT_CAP')], ids=['port', 'ref'])
def test_record_events_bounded_by_the_cap(pkg, env, monkeypatch):
    monkeypatch.setenv(env, '5')
    pkg.reset_profiler()
    for i in range(12):
        with pkg.RecordEvent('ev%d' % i):
            pass
    assert [n for n, _ in pkg.get_events()] == \
        ['ev7', 'ev8', 'ev9', 'ev10', 'ev11']
    monkeypatch.delenv(env)
    pkg.reset_profiler()
    assert pkg.get_events() == []


def test_get_events_keeps_the_user_category():
    with tprofiler.RecordEvent('mine'):
        pass
    timeline.record('executor.dispatch', cat='compute', dur=0.1)
    assert [n for n, _ in tprofiler.get_events()] == ['mine']


def _mlp(pkg=tfl, prog_mod=tprog):
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[16], dtype='float32')
            y = pkg.layers.data(name='y', shape=[1], dtype='float32')
            h = pkg.layers.fc(input=x, size=32, act='relu')
            p = pkg.layers.fc(input=h, size=4)
            cost = pkg.layers.mean(pkg.layers.square_error_cost(
                input=pkg.layers.reduce_sum(p, dim=1, keep_dim=True),
                label=y))
            pkg.optimizer.SGDOptimizer(0.01).minimize(cost)
    return main, startup, cost


def _feed(nan=False):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16).astype(np.float32)
    if nan:
        x[1, 3] = np.nan
    return {'x': x, 'y': rng.randn(4, 1).astype(np.float32)}


def _exe():
    main, startup, cost = _mlp()
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    return main, cost, exe, scope


def test_profiler_writes_a_trace_and_tabulates_it(tmp_path, capsys):
    main, cost, exe, scope = _exe()
    with tprofiler.profiler('All', sorted_key='total',
                            log_dir=str(tmp_path)):
        with tprofiler.RecordEvent('step'):
            exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    assert [f for f in os.listdir(str(tmp_path))
            if f.endswith('.pt.trace.json')]
    out = capsys.readouterr().out
    assert out.splitlines()[0].split() == \
        ['Event', 'Calls', 'Total(us)', 'Min(us)', 'Max(us)', 'Ave(us)']
    rows = tprofiler.profile_rows(str(tmp_path))
    assert 'step' in rows and rows['step'][0] == 1
    assert any(n.startswith('aten::') for n in rows)
    table = tprofiler.profile_table('calls', log_dir=str(tmp_path))
    calls = [int(ln[52:].split()[0]) for ln in table.splitlines()[1:]]
    assert calls == sorted(calls, reverse=True)
    with pytest.raises(ValueError):
        tprofiler.profile_table('bogus')
    with pytest.raises(ValueError):
        jprofiler.profile_table('bogus')
    assert [n for n, _ in tprofiler.get_events()] == \
        ['step', 'profile_region']


def test_start_stop_profiler(tmp_path):
    tprofiler.start_profiler('CPU', log_dir=str(tmp_path))
    with pytest.raises(RuntimeError):
        tprofiler.start_profiler('CPU', log_dir=str(tmp_path))
    torch.ones(8).sum()
    table = tprofiler.stop_profiler('total', str(tmp_path / 'table.txt'))
    assert open(str(tmp_path / 'table.txt')).read() == table
    with pytest.raises(RuntimeError):
        tprofiler.stop_profiler()


def test_cost_analysis_keys_and_flops():
    main, cost, _, scope = _exe()
    costs = tprofiler.cost_analysis(main, _feed(), [cost], scope=scope,
                                    place='cpu')
    assert set(costs) == {'flops', 'bytes accessed'}
    fwd = 2 * 4 * 16 * 32 + 2 * 4 * 32 * 4
    assert costs['flops'] >= 3 * fwd and costs['bytes accessed'] > 0
    jmain, jstartup, jcost = _mlp(__import__('paddle_tpu'),
                                  __import__('paddle_tpu.core.program',
                                             fromlist=['x']))
    import paddle_tpu as fluid
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup)
    jc = jprofiler.cost_analysis(jmain, _feed(), [jcost])
    assert set(costs) <= set(jc)


@pytest.mark.parametrize('value', [
    np.array([1.0, 2.0], np.float32), np.array([1.0, np.nan, np.inf]),
    np.array([[np.inf, -np.inf]], np.float32), np.arange(4)])
def test_host_checks_equal_the_reference(value):
    assert tdebug.has_nan_inf(value) == jdebug.has_nan_inf(value)
    assert tdebug.has_nan_inf(torch.from_numpy(value)) == \
        jdebug.has_nan_inf(value)
    try:
        jdebug.check_nan_inf(value, 'v')
        want = None
    except RuntimeError as e:
        want = str(e)
    try:
        tdebug.check_nan_inf(torch.from_numpy(value), 'v')
        got = None
    except RuntimeError as e:
        got = str(e)
    assert got == want
    if want is None:
        assert tdebug.guarded_fetches([value], ['v']) == [value]


def test_nan_guard_names_the_op():
    main, cost, exe, scope = _exe()
    out, = exe.run(main, feed=_feed(nan=True), fetch_list=[cost],
                   scope=scope)
    assert np.isnan(out).all()     # disarmed: no scan, no raise
    main, cost, exe, scope = _exe()
    # the NaN at x[1, 3] fills row 1 of the first fc's product
    with pytest.raises(FloatingPointError,
                       match=r"op 'mul' \(#0\).*has 32 NaN and 0 Inf"):
        with tdebug.nan_guard():
            exe.run(main, feed=_feed(nan=True), fetch_list=[cost],
                    scope=scope)
    assert not tdebug.armed()
    # a NaN made in the backward: the autodiff op is named
    main, cost, exe, scope = _exe()
    w = scope.get('fc_1.w_0')
    w[0, 0] = float('inf')
    with pytest.raises(FloatingPointError, match="op '"):
        with tdebug.nan_guard():
            exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)


def test_check_nan_inf_flag_arms_the_guard():
    code = ("import numpy as np, paddle_tpu_torch as tfl\n"
            "from paddle_tpu_torch import debug\n"
            "assert debug.armed()\n")
    env = dict(os.environ, PADDLE_TPU_TORCH_CHECK_NAN_INF='1')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr

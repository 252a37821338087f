"""``run_steps`` with device prefetch (PADDLE_TPU_TORCH_DEVICE_PREFETCH)
in the port against its one-shot path and against the reference's
prefetching ``run_steps`` (tests/test_device_prefetch.py's contracts),
on the CPU.

- Bitwise: the chunked path's losses and every persistable equal the
  one-shot path's at the reference's (k, chunk) cases, remainder chunks
  included, with dropout drawing a mask every step (the per-step
  generators are keyed by the absolute step, so chunk boundaries do not
  exist numerically), and across two calls.
- Against the reference (no dropout: the two packages draw different
  masks): the same program from the reference's startup state, both
  packages prefetching in chunks of 2, losses and parameters within
  1e-5 (float32 sums in other orders).
- The reference's semantics: repeat mode stays one-shot; a failure
  between chunks leaves the scope at that chunk boundary and raises a
  RuntimeError ("after 2 of 4 steps") from the original error, and the
  run resumes from there bitwise; a failure inside a chunk's steps
  raises the original error; a column whose dtype differs across steps
  joins to one dtype and matches the one-shot path; a chunk whose shapes
  do not match raises before any step; steady state makes exactly one
  blocking put (the prime) and counts the others as prefetched.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog

import paddle_tpu_torch as tfl
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import scope_from_numpy

TOL = 1e-5


def _build(pkg, prog_mod, dropout=True):
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 42
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[6], dtype='float32')
            label = pkg.layers.data(name='label', shape=[1],
                                    dtype='float32')
            h = pkg.layers.fc(
                input=x, size=5, act='tanh',
                param_attr=pkg.ParamAttr(
                    name='w1',
                    initializer=pkg.initializer.NormalInitializer(seed=3)))
            if dropout:
                h = pkg.layers.dropout(x=h, dropout_prob=0.3)
            pred = pkg.layers.fc(
                input=h, size=1,
                param_attr=pkg.ParamAttr(
                    name='w2',
                    initializer=pkg.initializer.NormalInitializer(seed=9)))
            loss = pkg.layers.mean(
                x=pkg.layers.square_error_cost(input=pred, label=label))
            pkg.optimizer.AdamOptimizer(0.01).minimize(loss)
    return main, startup, loss


def _feeds(k, batch=4):
    r = np.random.RandomState(7)
    return [{'x': r.randn(batch, 6).astype('float32'),
             'label': r.randn(batch, 1).astype('float32')}
            for _ in range(k)]


def _set_prefetch(monkeypatch, prefetch, chunk=None, prefix='TORCH_'):
    env = 'PADDLE_TPU_%sDEVICE_PREFETCH' % prefix
    if prefetch:
        monkeypatch.setenv(env, '1')
    else:
        monkeypatch.delenv(env, raising=False)
    if chunk is not None:
        monkeypatch.setenv(env + '_CHUNK', str(chunk))
    else:
        monkeypatch.delenv(env + '_CHUNK', raising=False)


def _state(main, scope):
    return {v.name: scope.get_numpy(v.name) for v in main.list_vars()
            if v.persistable and scope.has(v.name)}


def _run(k, monkeypatch, prefetch, chunk=None, calls=1, feeds=None):
    _set_prefetch(monkeypatch, prefetch, chunk)
    main, startup, loss = _build(tfl, tprog)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    losses = []
    for _ in range(calls):
        out = exe.run_steps(main, feed=feeds or _feeds(k),
                            fetch_list=[loss], scope=scope)
        losses.append(out[0])
    return np.concatenate(losses), _state(main, scope), exe


def _bitwise(a, b):
    assert set(a) == set(b)
    for n in sorted(a):
        eq = a[n] == b[n]
        assert eq.all(), '%s: %d/%d differ' % (n, (~eq).sum(), eq.size)


@pytest.mark.parametrize('k,chunk', [(5, 2), (6, 3), (4, None)])
def test_prefetch_bitwise_parity(k, chunk, monkeypatch):
    l_off, s_off, _ = _run(k, monkeypatch, prefetch=False)
    l_on, s_on, exe = _run(k, monkeypatch, prefetch=True, chunk=chunk)
    np.testing.assert_array_equal(l_off, l_on)
    _bitwise(s_off, s_on)
    rep = exe.last_step_report
    assert rep['device_prefetch'] is True
    assert rep['chunks'] == (-(-k // chunk) if chunk else min(4, k))


def test_prefetch_across_calls_continues_stream(monkeypatch):
    l_two, s_two, _ = _run(4, monkeypatch, prefetch=True, chunk=2,
                           calls=2)
    l_one, s_one, _ = _run(4, monkeypatch, prefetch=False, calls=2)
    np.testing.assert_array_equal(l_two, l_one)
    _bitwise(s_two, s_one)


def test_prefetch_matches_the_reference(monkeypatch):
    _set_prefetch(monkeypatch, True, 2)
    _set_prefetch(monkeypatch, True, 2, prefix='')
    jmain, jstartup, jloss = _build(fluid, jprog, dropout=False)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    init = {v.name: np.asarray(jscope.get(v.name))
            for v in jmain.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}
    tmain, _, tloss = _build(tfl, tprog, dropout=False)
    tscope = scope_from_numpy(init, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    feeds = _feeds(5)
    jl = np.asarray(jexe.run_steps(jmain, feed=feeds, fetch_list=[jloss],
                                   scope=jscope)[0])
    tl = texe.run_steps(tmain, feed=feeds, fetch_list=[tloss],
                        scope=tscope)[0]
    assert texe.last_step_report['chunks'] == \
        jexe.last_step_report['chunks'] == 3
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    for name in ('w1', 'w2'):
        np.testing.assert_allclose(tscope.get_numpy(name),
                                   np.asarray(jscope.get(name)),
                                   rtol=0, atol=TOL)


def test_repeat_mode_stays_one_shot(monkeypatch):
    _set_prefetch(monkeypatch, True)
    main, startup, loss = _build(tfl, tprog)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    out = exe.run_steps(main, feed=_feeds(1)[0], fetch_list=[loss],
                        scope=scope, repeat=3)
    assert out[0].shape[0] == 3
    rep = exe.last_step_report
    assert rep['device_prefetch'] is False and rep['chunks'] == 1


def _flaky_chunks(monkeypatch, boom_at, run_one_first):
    real = Executor._dispatch_chunk
    state = {'calls': 0, 'armed': False}

    class Boom(Exception):
        pass

    def flaky(self, program, scope, staged, *a):
        state['calls'] += 1
        if state['armed'] and state['calls'] == boom_at:
            if run_one_first:
                # one step of the chunk runs before the failure
                real(self, program, scope, staged[:1], *a)
            raise Boom('injected chunk failure')
        return real(self, program, scope, staged, *a)

    monkeypatch.setattr(Executor, '_dispatch_chunk', flaky)
    return state, Boom


def test_mid_stream_failure_lands_chunk_boundary(monkeypatch):
    _set_prefetch(monkeypatch, True, 2)
    state, Boom = _flaky_chunks(monkeypatch, boom_at=2,
                                run_one_first=False)
    feeds = _feeds(4)
    l_clean, s_clean, _ = _run(4, monkeypatch, True, 2, feeds=feeds)

    main, startup, loss = _build(tfl, tprog)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    state['calls'], state['armed'] = 0, True
    with pytest.raises(RuntimeError, match=r'after 2 of 4 steps') as e:
        exe.run_steps(main, feed=feeds, fetch_list=[loss], scope=scope)
    assert isinstance(e.value.__cause__, Boom)
    state['armed'] = False
    l_rest = exe.run_steps(main, feed=feeds[2:], fetch_list=[loss],
                           scope=scope)[0]
    np.testing.assert_array_equal(l_clean[2:], l_rest)
    _bitwise(s_clean, _state(main, scope))


def test_mid_chunk_failure_surfaces_the_original_error(monkeypatch):
    _set_prefetch(monkeypatch, True, 2)
    state, Boom = _flaky_chunks(monkeypatch, boom_at=2, run_one_first=True)
    main, startup, loss = _build(tfl, tprog)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    state['armed'] = True
    with pytest.raises(Boom):
        exe.run_steps(main, feed=_feeds(4), fetch_list=[loss], scope=scope)


def test_mixed_dtype_feed_matches_one_shot(monkeypatch):
    def run(prefetch):
        _set_prefetch(monkeypatch, prefetch, 2 if prefetch else None)
        with tprog.reset_unique_name_guard():
            main, startup = tfl.Program(), tfl.Program()
            main.random_seed = startup.random_seed = 42
            with tfl.program_guard(main, startup):
                xi = tfl.layers.data(name='xi', shape=[6], dtype='int32')
                xf = tfl.layers.cast(x=xi, dtype='float32')
                label = tfl.layers.data(name='label', shape=[1],
                                        dtype='float32')
                pred = tfl.layers.fc(
                    input=xf, size=1, param_attr=tfl.ParamAttr(
                        name='w', initializer=tfl.initializer
                        .NormalInitializer(seed=3)))
                loss = tfl.layers.mean(
                    x=tfl.layers.square_error_cost(input=pred,
                                                   label=label))
                tfl.optimizer.SGDOptimizer(0.01).minimize(loss)
        r = np.random.RandomState(7)
        feeds = [{'xi': r.randint(-5, 5, (4, 6)).astype(
                      np.int8 if i < 2 else np.int32),
                  'label': r.randn(4, 1).astype('float32')}
                 for i in range(4)]
        exe = tfl.Executor(tfl.CPUPlace())
        scope = tfl.Scope()
        exe.run(startup, scope=scope)
        out = exe.run_steps(main, feed=feeds, fetch_list=[loss],
                            scope=scope)
        return out[0], scope.get_numpy('w')

    l_off, w_off = run(False)
    l_on, w_on = run(True)
    np.testing.assert_array_equal(l_off, l_on)
    np.testing.assert_array_equal(w_off, w_on)


def test_chunk_shape_mismatch_raises_before_any_step(monkeypatch):
    _set_prefetch(monkeypatch, True, 2)
    main, startup, loss = _build(tfl, tprog)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    before = _state(main, scope)
    feeds = _feeds(4)
    feeds[3] = {'x': np.zeros((9, 6), np.float32),
                'label': np.zeros((9, 1), np.float32)}
    with pytest.raises(ValueError, match='agree in shape'):
        exe.run_steps(main, feed=feeds, fetch_list=[loss], scope=scope)
    _bitwise(before, _state(main, scope))
    feeds[3] = {'x': np.zeros((4, 6), np.float32)}
    with pytest.raises(ValueError):
        exe.run_steps(main, feed=feeds, fetch_list=[loss], scope=scope)


def _counter(snap, name):
    fam = snap.get(name)
    return sum(s['value'] for s in fam['samples']) if fam else 0


def test_steady_state_makes_one_blocking_put(monkeypatch):
    k, chunk = 8, 2
    _set_prefetch(monkeypatch, True, chunk)
    main, startup, loss = _build(tfl, tprog)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeds = _feeds(k)
    exe.run_steps(main, feed=feeds, fetch_list=[loss], scope=scope)
    s0 = tobs.snapshot()
    exe.run_steps(main, feed=feeds, fetch_list=[loss], scope=scope)
    s1 = tobs.snapshot()

    def d(name):
        return _counter(s1, name) - _counter(s0, name)
    assert d('paddle_tpu_executor_feed_blocking_puts_total') == 1
    assert d('paddle_tpu_executor_feed_prefetched_puts_total') == \
        k // chunk - 1
    per_chunk = chunk * 4 * (6 + 1) * 4
    assert d('paddle_tpu_executor_feed_prefetched_bytes_total') == \
        per_chunk * (k // chunk - 1)
    assert d('paddle_tpu_executor_steps_total') == k
    assert d('paddle_tpu_executor_compiles_total') == 0
    rep = exe.last_step_report
    assert rep['chunks'] == k // chunk and rep['feed_overlap_s'] >= 0.0
    assert rep['feed_bytes'] == k * 4 * (6 + 1) * 4
    assert rep['feed_peak_bytes'] == 2 * per_chunk

"""Learning-rate decay and ``global_step`` through the port
(paddle_tpu_torch/learning_rate_decay.py, optimizer.py, the ``increment``
op) against the reference's (paddle_tpu/learning_rate_decay.py), on the
CPU.

- The cases of tests/test_lr_decay.py through both packages: each
  schedule (exponential with and without staircase, natural exp,
  inverse time, polynomial with and without cycle, piecewise) serialises
  to exactly the reference's program, and its rate over 12 runs equals
  the reference's and the closed form.
- A schedule driving SGD and Momentum: 6 steps from the reference's
  initial state, the loss, the rate and w each step against the
  reference's; the step counter advances once a run, inside the
  gradient pass, also through ``run_steps``; the decayed rate shrinks
  the late steps as the reference test asks.
- ``global_step=``: the optimizer's ``increment`` op (optimize role)
  counts the runs, as the reference's does.

Tolerances: rates 1e-6 relative against the reference and 1e-5 against
the closed form (the reference test's bound; float32 pow, exp and
division of one element); losses, rates and w 1e-5.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import learning_rate_decay as jlrd
from paddle_tpu.core import program as jprog

import paddle_tpu_torch as tfl
from paddle_tpu_torch import learning_rate_decay as tlrd
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy

BASE, DECAY_STEPS, RATE = 1.0, 5, 0.5
TOL_REF = 1e-6
TOL_FORM = 1e-5
TOL = 1e-5


def _lrd(pkg):
    return jlrd if pkg is fluid else tlrd


def _programs(pkg, build, seed=7):
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup):
            fetch = build(pkg)
    return main, startup, fetch


def _closed_form(name, step):
    d = step / DECAY_STEPS
    if name == 'exponential':
        return BASE * RATE ** d
    if name == 'exponential_staircase':
        return BASE * RATE ** np.floor(d)
    if name == 'natural_exp':
        return BASE * np.exp(-RATE * d)
    if name == 'inverse_time':
        return BASE / (1 + RATE * d)
    if name.startswith('polynomial'):
        end, power = 0.1, 2.0
        if name.endswith('cycle'):
            frac = step / (max(1.0, np.ceil(d)) * DECAY_STEPS)
        else:
            frac = min(step, DECAY_STEPS) / DECAY_STEPS
        return (BASE - end) * (1 - frac) ** power + end
    return 1.0 if step < 3 else 0.5 if step < 7 else 0.1


SCHEDULES = {
    'exponential': lambda m: m.exponential_decay(BASE, DECAY_STEPS, RATE),
    'exponential_staircase': lambda m: m.exponential_decay(
        BASE, DECAY_STEPS, RATE, True),
    'natural_exp': lambda m: m.natural_exp_decay(BASE, DECAY_STEPS, RATE),
    'inverse_time': lambda m: m.inverse_time_decay(BASE, DECAY_STEPS, RATE),
    'polynomial': lambda m: m.polynomial_decay(BASE, DECAY_STEPS, 0.1, 2.0),
    'polynomial_cycle': lambda m: m.polynomial_decay(
        BASE, DECAY_STEPS, 0.1, 2.0, True),
    'piecewise': lambda m: m.piecewise_decay(boundaries=[3, 7],
                                             values=[1.0, 0.5, 0.1]),
}


def _trajectory(pkg, main, startup, lr, steps=12):
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    return [float(np.ravel(exe.run(main, fetch_list=[lr.name],
                                   scope=scope)[0])[0])
            for _ in range(steps)]


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_the_reference_and_its_closed_form(name):
    progs = {pkg: _programs(pkg, lambda p: SCHEDULES[name](_lrd(p)))
             for pkg in (fluid, tfl)}
    assert progs[tfl][0].to_dict() == progs[fluid][0].to_dict()
    assert progs[tfl][1].to_dict() == progs[fluid][1].to_dict()
    got = _trajectory(tfl, *progs[tfl])
    want = _trajectory(fluid, *progs[fluid])
    np.testing.assert_allclose(got, want, rtol=TOL_REF)
    form = [_closed_form(name, s) for s in range(1, 13)]
    np.testing.assert_allclose(got, form, rtol=TOL_FORM)


def _decayed(opt_name):
    def build(pkg):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        p = pkg.layers.fc(input=x, size=1, param_attr='w_lr')
        loss = pkg.layers.mean(
            x=pkg.layers.square_error_cost(input=p, label=y))
        lr = _lrd(pkg).exponential_decay(0.5, 2, 0.1)
        if opt_name == 'sgd':
            opt = pkg.optimizer.SGDOptimizer(learning_rate=lr)
        else:
            opt = pkg.optimizer.MomentumOptimizer(learning_rate=lr,
                                                  momentum=0.9)
        opt.minimize(loss)
        return loss, lr
    return build


def _feed():
    rng = np.random.RandomState(0)
    return {'x': rng.randn(8, 4).astype('float32'),
            'y': rng.randn(8, 1).astype('float32')}


@pytest.mark.parametrize('opt', ['sgd', 'momentum'])
def test_decay_drives_updates_as_the_reference(opt):
    jm, js, (jloss, jlr) = _programs(fluid, _decayed(opt))
    tm, ts, (tloss, tlr) = _programs(tfl, _decayed(opt))
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jm.list_vars()
               if v.persistable and jscope.has(v.name)}
    tscope, texe = scope_from_numpy(persist, 'cpu'), tfl.Executor('cpu')
    counter = next(n for n in persist if n.startswith('@STEP_COUNTER@'))
    feed = _feed()
    deltas = []
    for i in range(6):
        before = tscope.get_numpy('w_lr').copy()
        want = jexe.run(jm, feed=feed, fetch_list=[jloss, jlr],
                        scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[tloss.name, tlr.name],
                       scope=tscope)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[1], 0.5 * 0.1 ** ((i + 1) / 2),
                                   rtol=TOL_FORM)
        w = tscope.get_numpy('w_lr')
        np.testing.assert_allclose(w, np.asarray(jscope.get('w_lr')),
                                   rtol=TOL, atol=TOL)
        deltas.append(np.abs(w - before).max())
        # the counter advanced once in the run, in the gradient pass
        assert tscope.get_numpy(counter)[0] == i + 1
    if opt == 'sgd':
        assert deltas[-1] < deltas[0] * 0.2
    # run_steps: one increment per step
    out, = texe.run_steps(tm, feed=feed, fetch_list=[tlr.name],
                          scope=tscope, repeat=3)
    np.testing.assert_allclose(out.ravel(), [0.5 * 0.1 ** (s / 2)
                                             for s in (7, 8, 9)],
                               rtol=TOL_FORM)
    assert tscope.get_numpy(counter)[0] == 9


def test_global_step_counts_the_runs_as_the_reference():
    def build(pkg):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        p = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(
            x=pkg.layers.square_error_cost(input=p, label=y))
        step = pkg.layers.create_global_var(
            shape=[1], value=0.0, dtype='float32', persistable=True,
            name='global_step')
        pkg.optimizer.AdamOptimizer(learning_rate=0.01,
                                    global_step=step).minimize(loss)
        return loss
    jm, js, _ = _programs(fluid, build)
    tm, ts, loss = _programs(tfl, build)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    inc = [op for op in tm.global_block().ops if op.type == 'increment']
    assert len(inc) == 1 and inc[0].attrs['op_role'] == 'optimize'
    exe, scope = tfl.Executor('cpu'), tfl.Scope()
    exe.run(ts, scope=scope)
    for _ in range(4):
        exe.run(tm, feed=_feed(), fetch_list=[loss.name], scope=scope)
    assert scope.get_numpy('global_step')[0] == 4.0

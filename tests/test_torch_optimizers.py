"""The rest of the optimizers, their update ops, the truncated normal
and MSRA initializers and ``nets.glu`` (paddle_tpu_torch/ops/
optim_ops.py, optimizer.py, ops/random.py, initializer.py, nets.py)
against the reference, on the CPU.

- The seven update ops (adamax, decayed_adagrad, adadelta, rmsprop,
  ftrl, proximal_gd, proximal_adagrad) on the cases of
  tests/test_optim_ops.py (a 4 x 3 parameter, its gradient and state at
  the same attrs), and each with a (rows, values) gradient with a
  repeated row, which both packages densify first: every output slot
  against the reference's compute function; the port's outputs are the
  state tensors it was given, updated in place.
- The five optimizers on fit_a_line: ``build`` + ``minimize`` serialise
  to the reference's main and startup programs, and 3 steps from the
  reference's state match its losses and state.
- ``truncated_gaussian_random`` / ``TruncatedNormal`` and
  ``MSRAInitializer`` by distribution (JAX's and torch's generators never
  agree): the startup programs serialise equal, and the port's draws of
  a 256 x 256 parameter against the reference's by a two-sample
  Kolmogorov-Smirnov test (p > 1e-3), with the truncated normal's bounds
  and moments.
- ``nets.glu``: the program, its output and its input's gradient.

Tolerances: the update ops 1e-6 relative and absolute (float32 rules in
the same order of operations; sqrt, pow and division differ by a float32
ulp or two); fit_a_line's loss 1e-5 relative and its state 1e-5 of
max(1, the entry's size) (the cost is O(500) at the init, gradients
O(1e2) and Ftrl's squared sums O(1e3), each carrying the sides' 1e-7
relative rounding); glu 1e-6.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.models import fit_a_line as jfit

import paddle_tpu_torch as tfl
from paddle_tpu_torch import datasets
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import fit_a_line

TOL_OP = 1e-6
TOL_LOSS = 1e-5
TOL_STATE = 1e-5


def _state(rng, positive=False):
    x = rng.randn(4, 3).astype('float32')
    return np.abs(x) if positive else x


def _case(op, rng):
    """(inputs, attrs) of tests/test_optim_ops.py's case of ``op``."""
    p = rng.randn(4, 3).astype('float32')
    g = rng.randn(4, 3).astype('float32')
    lr = np.array([0.1], dtype='float32')
    ins = {'Param': p, 'Grad': g}
    if op == 'adamax':
        ins.update(Moment=_state(rng), InfNorm=_state(rng, True),
                   LearningRate=lr, Beta1Pow=np.array([0.9], 'float32'))
        return ins, {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}
    if op == 'decayed_adagrad':
        ins.update(Moment=_state(rng, True), LearningRate=lr)
        return ins, {'decay': 0.95, 'epsilon': 1e-6}
    if op == 'adadelta':
        ins.update(AvgSquaredGrad=_state(rng, True),
                   AvgSquaredUpdate=_state(rng, True))
        return ins, {'rho': 0.95, 'epsilon': 1e-6}
    if op == 'rmsprop':
        ins.update(MeanSquare=_state(rng, True), Moment=_state(rng),
                   LearningRate=lr)
        return ins, {'decay': 0.9, 'momentum': 0.5, 'epsilon': 1e-10}
    if op == 'ftrl':
        ins.update(SquaredAccumulator=_state(rng, True),
                   LinearAccumulator=_state(rng), LearningRate=lr)
        return ins, {'l1': 0.1, 'l2': 0.2, 'lr_power': -0.5}
    if op == 'proximal_gd':
        ins.update(LearningRate=lr)
        return ins, {'l1': 0.05, 'l2': 0.1}
    ins.update(Moment=_state(rng, True), LearningRate=lr)
    return ins, {'l1': 0.05, 'l2': 0.1}


OPS = ['adamax', 'decayed_adagrad', 'adadelta', 'rmsprop', 'ftrl',
       'proximal_gd', 'proximal_adagrad']


@pytest.mark.parametrize('sparse', [False, True])
@pytest.mark.parametrize('op', OPS)
def test_update_op_matches_the_reference(op, sparse):
    rng = np.random.RandomState(11)
    ins, attrs = _case(op, rng)
    if sparse:   # rows 2 and 0 of the gradient, row 2 twice
        ins['Grad'] = (np.array([2, 0, 2], 'int32'),
                       rng.randn(3, 3).astype('float32'))

    def stage(v, conv):
        return tuple(conv(e) for e in v) if isinstance(v, tuple) \
            else conv(v)
    want = jget_op(op).compute(
        None, {k: [stage(v, np.asarray)] for k, v in ins.items()},
        dict(attrs))
    port_ins = {k: [stage(v, lambda a: torch.from_numpy(np.array(a)))]
                for k, v in ins.items()}
    got = tget_op(op).compute(None, port_ins, dict(attrs))
    assert sorted(got) == sorted(want)
    for slot, (w,) in want.items():
        g, = got[slot]
        w = np.asarray(w)
        assert g.shape == w.shape and g.numpy().dtype == w.dtype, slot
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL_OP, atol=TOL_OP,
                                   err_msg=slot)
        # the state tensor it was given, updated in place
        src = slot[:-len('Out')] if slot != 'SquaredAccumOut' and \
            slot != 'LinearAccumOut' else slot.replace('AccumOut',
                                                       'Accumulator')
        assert g is port_ins[src][0], slot


OPTIMIZERS = {
    'adamax': lambda p: p.optimizer.AdamaxOptimizer(learning_rate=0.01),
    'decayed_adagrad': lambda p: p.optimizer.DecayedAdagradOptimizer(
        learning_rate=0.05),
    'adadelta': lambda p: p.optimizer.AdadeltaOptimizer(learning_rate=1.0),
    'rmsprop': lambda p: p.optimizer.RMSPropOptimizer(learning_rate=0.01,
                                                      momentum=0.5),
    'ftrl': lambda p: p.optimizer.FtrlOptimizer(learning_rate=0.05, l1=0.01,
                                                l2=0.01),
}


def _fit_program(pkg, name):
    m = fit_a_line if pkg is tfl else jfit
    prog = tprog if pkg is tfl else jprog
    with prog.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup):
            _, _, _, cost = m.build()
            OPTIMIZERS[name](pkg).minimize(cost)
    return main, startup, cost


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_trains_fit_a_line_as_the_reference(name):
    jmain, jstartup, jcost = _fit_program(fluid, name)
    tmain, tstartup, _ = _fit_program(tfl, name)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstartup.to_dict() == jstartup.to_dict()
    assert sum(op.type == name for op in tmain.global_block().ops) == 2
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.array(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    samples = list(datasets.uci_housing.train()())[:24]
    for i in (0, 8, 16):
        feed = {'x': np.stack([s[0] for s in samples[i:i + 8]]),
                'y': np.stack([s[1] for s in samples[i:i + 8]])}
        want, = jexe.run(jmain, feed=feed, fetch_list=[jcost.name],
                         scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[jcost.name],
                        scope=tscope)
        assert abs(float(got[0]) - float(want[0])) <= TOL_LOSS * abs(
            float(want[0]))
    for n in persist:
        a, b = tscope.get_numpy(n), np.asarray(jscope.get(n))
        assert a.shape == b.shape and a.dtype == b.dtype, n
        assert np.abs(a - b).max() <= TOL_STATE * max(
            1.0, float(np.abs(b).max())), n


INITIALIZERS = {
    'truncated_normal': lambda p: p.initializer.TruncatedNormal(
        loc=0.5, scale=2.0),
    'msra_uniform': lambda p: p.initializer.MSRAInitializer(),
    'msra_normal': lambda p: p.initializer.MSRAInitializer(uniform=False),
    'msra_fan_in': lambda p: p.initializer.MSRAInitializer(fan_in=16),
}


def _init_draws(pkg, name, seed):
    prog = tprog if pkg is tfl else jprog
    with prog.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = seed
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[256], dtype='float32')
            pkg.layers.fc(input=x, size=256, bias_attr=False,
                          param_attr=pkg.ParamAttr(
                              name='w', initializer=INITIALIZERS[name](pkg)))
    scope = pkg.Scope()
    pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
    w = scope.get_numpy('w') if pkg is tfl else np.asarray(scope.get('w'))
    return startup, w.ravel()


@pytest.mark.parametrize('name', sorted(INITIALIZERS))
def test_initializer_draws_the_reference_distribution(name):
    jstartup, want = _init_draws(fluid, name, 3)
    tstartup, got = _init_draws(tfl, name, 3)
    assert tstartup.to_dict() == jstartup.to_dict()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert stats.ks_2samp(got, want).pvalue > 1e-3
    if name == 'truncated_normal':
        # within two deviations of the mean; the standard normal cut at
        # +-2 has deviation 0.8796
        assert got.min() >= 0.5 - 4.0 and got.max() <= 0.5 + 4.0
        assert abs(got.mean() - 0.5) < 0.02
        assert abs(got.std() - 2.0 * 0.8796) < 0.02
    elif name == 'msra_uniform':
        limit = np.sqrt(6.0 / 256)
        assert got.min() >= -limit and got.max() <= limit
    elif name == 'msra_normal':
        assert abs(got.std() - np.sqrt(2.0 / 256)) < 0.003


def _glu_program(pkg):
    prog = tprog if pkg is tfl else jprog
    with prog.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[3, 8], dtype='float32')
            x.stop_gradient = False
            y = pkg.nets.glu(input=x, dim=-1)
            loss = pkg.layers.mean(x=pkg.layers.square(x=y))
            g, = pkg.backward.calc_gradient(loss, [x])
    return main, y, g


def test_glu_matches_the_reference():
    jmain, jy, jg = _glu_program(fluid)
    tmain, ty, tg = _glu_program(tfl)
    assert tmain.to_dict() == jmain.to_dict()
    feed = {'x': np.random.default_rng(2).standard_normal(
        (4, 3, 8)).astype(np.float32)}
    want = fluid.Executor(fluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[jy.name, jg.name], scope=fluid.Scope())
    got = tfl.Executor(tfl.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[ty.name, tg.name], scope=tfl.Scope())
    assert got[0].shape == (4, 3, 4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)

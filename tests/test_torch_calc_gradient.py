"""``calc_gradient`` through the port (paddle_tpu_torch/core/backward.py
and the executor's gradient pass), against the reference, on the CPU.

- The cases of tests/test_backward.py: the gradient with respect to a fed
  input (``stop_gradient`` off), with respect to an intermediate, and
  through an ``ErrorClipByValue`` on an intermediate; each built by both
  packages (the programs equal as data), run on the same input, and held
  to the reference's result and to the closed form.
- An intermediate deep in an fc net and the fed input together, from the
  reference's initial state; fetched beside the intermediate's forward
  value, which the gradient pass publishes.  The intermediate is a leaf,
  so the input's gradient through it is zero, in both packages.
- What stays out: a second autodiff op in one program raises, and a
  gradient with respect to a name nothing computes raises.

Tolerance: 1e-5 relative to the largest entry (float32, a few dozen O(1)
products in other orders); the closed forms to 1e-5 as the reference
tests hold them.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy

TOL = 1e-5


def _wrt_input(pkg):
    x = pkg.layers.data(name='x', shape=[3], dtype='float32')
    x.stop_gradient = False
    loss = pkg.layers.reduce_sum(input=pkg.layers.square(x=x))
    return pkg.backward.calc_gradient(loss, x), lambda xv: 2 * xv


def _wrt_intermediate(pkg):
    x = pkg.layers.data(name='x', shape=[3], dtype='float32')
    h = pkg.layers.scale(x=x, scale=3.0)
    loss = pkg.layers.reduce_sum(input=pkg.layers.square(x=h))
    return pkg.backward.calc_gradient(loss, h), lambda xv: 2 * 3 * xv


def _error_clip(pkg):
    x = pkg.layers.data(name='x', shape=[3], dtype='float32')
    x.stop_gradient = False
    h = pkg.layers.scale(x=x, scale=100.0)
    h.error_clip = pkg.clip.ErrorClipByValue(max=0.01)
    loss = pkg.layers.reduce_sum(input=h)
    # dloss/dh = 1 clipped to 0.01, then through scale: 0.01 * 100
    return pkg.backward.calc_gradient(loss, x), lambda xv: np.ones_like(xv)


def _build(pkg, case):
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 9
        with pkg.program_guard(main, startup):
            out = case(pkg)
    return main, startup, out


@pytest.mark.parametrize('case', [_wrt_input, _wrt_intermediate,
                                  _error_clip],
                         ids=['input', 'intermediate', 'error_clip'])
@pytest.mark.parametrize('xv', [[[1., 2., 3.]],
                                [[-0.5, 0., 4.], [2., 1., 1.]]],
                         ids=['one_row', 'two_rows'])
def test_the_reference_cases(case, xv):
    xv = np.asarray(xv, np.float32)
    jmain, _, ((jg,), closed) = _build(fluid, case)
    tmain, _, ((tg,), _) = _build(tfl, case)
    assert tmain.to_dict() == jmain.to_dict()
    want, = fluid.Executor(fluid.CPUPlace()).run(
        jmain, feed={'x': xv}, fetch_list=[jg], scope=fluid.Scope())
    got, = tfl.Executor(tfl.CPUPlace()).run(
        tmain, feed={'x': xv}, fetch_list=[tg], scope=tfl.Scope())
    assert got.shape == np.asarray(want).shape == xv.shape
    assert np.abs(got - np.asarray(want)).max() <= TOL
    np.testing.assert_allclose(got, closed(xv), rtol=1e-5)


def _deep(pkg):
    x = pkg.layers.data(name='x', shape=[6], dtype='float32')
    x.stop_gradient = False
    h1 = pkg.layers.fc(input=x, size=8, act='tanh')
    h2 = pkg.layers.fc(input=h1, size=5, act='relu')
    loss = pkg.layers.mean(x=pkg.layers.square(
        x=pkg.layers.fc(input=h2, size=2)))
    grads = pkg.backward.calc_gradient(loss, [h1, x])
    return grads, [h1, loss]


def test_an_intermediate_and_an_input_together_match_the_reference():
    jmain, jstartup, (jgrads, jfetch) = _build(fluid, _deep)
    tmain, _, (tgrads, tfetch) = _build(tfl, _deep)
    assert tmain.to_dict() == jmain.to_dict()
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.array(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tscope = scope_from_numpy(persist, 'cpu')
    xv = np.random.default_rng(4).standard_normal((7, 6)).astype(np.float32)
    names = [v.name for v in jgrads + jfetch]
    want = jexe.run(jmain, feed={'x': xv}, fetch_list=names, scope=jscope)
    got = tfl.Executor(tfl.CPUPlace()).run(
        tfl.Program.from_dict(jmain.to_dict()), feed={'x': xv},
        fetch_list=names, scope=tscope)
    for n, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, n
        assert np.abs(a - b).max() <= TOL * max(1.0, np.abs(b).max()), n
    # every path from x to the loss passes h1, a leaf from the moment
    # its op writes it (the reference's frozen rule): x's gradient is 0
    assert np.abs(got[0]).max() > 0 and not got[1].any()
    for n in persist:   # calc_gradient updates nothing
        assert np.array_equal(tscope.get_numpy(n), persist[n]), n


def test_what_calc_gradient_does_not_bring_raises():
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[3], dtype='float32')
        x.stop_gradient = False
        h = tfl.layers.scale(x=x, scale=2.0)
        loss = tfl.layers.reduce_sum(input=h)
        gx, = tfl.backward.calc_gradient(loss, x)
        gh, = tfl.backward.calc_gradient(loss, h)
    exe = tfl.Executor(tfl.CPUPlace())
    feed = {'x': np.ones((1, 3), np.float32)}
    # two autodiff ops in one program run (the second takes h, the first
    # pass's value, as its leaf): the reference's values
    got_x, got_h = exe.run(main, feed=feed, fetch_list=[gx, gh],
                           scope=tfl.Scope())
    assert np.array_equal(got_x, np.full((1, 3), 2.0, np.float32))
    assert np.array_equal(got_h, np.ones((1, 3), np.float32))
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[3], dtype='float32')
        loss = tfl.layers.reduce_sum(input=x)
        ghost = main.global_block().create_var(name='ghost', shape=[3],
                                               dtype='float32')
        gg, = tfl.calc_gradient(loss, ghost)
    with pytest.raises(KeyError, match='ghost'):
        exe.run(main, feed=feed, fetch_list=[gg], scope=tfl.Scope())

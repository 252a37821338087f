"""``Executor.compile`` / ``compile_raw`` (paddle_tpu_torch/core/
executor.py) on the CPU: the plan of a run as a pure function
``fn(feed, state_rw, state_ro, seed) -> (fetches, new_state)``.

- Its fetches and new state equal ``Executor.run`` on the same program,
  state and feeds bitwise (an fc net; a conv net with batch norm in test
  mode; an fc net with an SGD step, whose new state is the scope after
  the run; a dropout program, whose masks come from the same seed).
- It writes nothing to the scope and counts no step.
- ``compile_raw`` gives the same function; ``reset_cache`` drops plans.
- Against the reference (programs built by ``paddle_tpu`` and handed
  over, tests/torch_serving_cases.py): the function's fetches equal the
  reference's compiled function's within 1e-5 absolute (float32 sums in
  other orders, O(1) softmax outputs).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as tfl

import torch_serving_cases as cases

TOL = 1e-5


def _fc():
    jmain, jexe, jscope, out = cases.reference(cases.fc_net)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    feed = {'x': np.random.default_rng(0).standard_normal(
        (4, 6)).astype(np.float32)}
    return jmain, jexe, jscope, tmain, texe, tscope, out.name, feed


def _conv_bn():
    jmain, jexe, jscope, out = cases.reference(cases.conv_bn_net)
    jtest = jmain.clone(for_test=True)
    tmain, texe, tscope = cases.handover(jtest, jscope)
    feed = {'img': np.random.default_rng(1).standard_normal(
        (2, 3, 8, 8)).astype(np.float32)}
    return jtest, jexe, jscope, tmain, texe, tscope, out.name, feed


@pytest.mark.parametrize('make', [_fc, _conv_bn], ids=['fc', 'conv_bn'])
def test_compiled_function_is_run_bitwise(make):
    _, _, _, tmain, texe, tscope, fetch, feed = make()
    fn, (f, rw, ro, seed) = texe.compile(tmain, feed=feed,
                                         fetch_list=[fetch], scope=tscope)
    assert set(rw) | set(ro) == {
        v.name for v in tmain.list_vars() if v.persistable}
    (got,), new_state = fn(f, rw, ro, seed)
    want, = texe.run(tmain, feed=feed, fetch_list=[fetch], scope=tscope)
    np.testing.assert_array_equal(got.numpy(), want)
    # batch norm in test mode writes its running statistics back as
    # they were
    assert set(new_state) == set(rw) == {
        n for n in rw if n.startswith('batch_norm')}
    for n, t in new_state.items():
        np.testing.assert_array_equal(t.numpy(), tscope.get_numpy(n))


def test_compile_raw_is_the_same_function():
    _, _, _, tmain, texe, tscope, fetch, feed = _fc()
    fn, args = texe.compile(tmain, feed=feed, fetch_list=[fetch],
                            scope=tscope)
    raw, raw_args = texe.compile_raw(tmain, feed=feed, fetch_list=[fetch],
                                     scope=tscope)
    np.testing.assert_array_equal(fn(*args)[0][0].numpy(),
                                  raw(*raw_args)[0][0].numpy())
    assert raw_args[3] == args[3]


def test_a_training_step_gives_run_state_and_leaves_the_scope():
    """fc + SGD: the function's new state is the scope after ``run``,
    bitwise, and compiling and calling it leaves the scope and the
    step counter as they were."""
    def net():
        pred = cases.fc_net()
        y = fluid.layers.data(name='y', shape=[3], dtype='float32')
        cost = fluid.layers.mean(x=fluid.layers.square_error_cost(
            input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
        return cost
    jmain, _, jscope, cost = cases.reference(net)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    rng = np.random.default_rng(2)
    feed = {'x': rng.standard_normal((4, 6)).astype(np.float32),
            'y': rng.standard_normal((4, 3)).astype(np.float32)}
    before = {n: tscope.get_numpy(n).copy()
              for n in tscope.local_var_names()}
    fn, (f, rw, ro, seed) = texe.compile(tmain, feed=feed,
                                         fetch_list=[cost.name],
                                         scope=tscope)
    params = [p.name for p in tmain.all_parameters()]
    assert set(params) <= set(rw)
    (loss,), new_state = fn(f, rw, ro, seed)
    assert texe._step_count == 0
    for n, a in before.items():
        np.testing.assert_array_equal(tscope.get_numpy(n), a)
    want, = texe.run(tmain, feed=feed, fetch_list=[cost.name],
                     scope=tscope)
    np.testing.assert_array_equal(loss.numpy(), want)
    for n in params:
        np.testing.assert_array_equal(new_state[n].numpy(),
                                      tscope.get_numpy(n))
        assert not np.array_equal(before[n], tscope.get_numpy(n)), n


def test_the_seed_keys_the_random_ops_as_run_does():
    """A dropout program (not in test mode): the function at the seed
    ``compile`` hands out draws ``run``'s masks at that step; another
    step's seed draws others."""
    def net():
        x = fluid.layers.data(name='x', shape=[64], dtype='float32')
        return fluid.layers.dropout(x=x, dropout_prob=0.5)
    jmain, _, jscope, out = cases.reference(net)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    feed = {'x': np.ones((8, 64), np.float32)}
    fn, (f, rw, ro, seed) = texe.compile(tmain, feed=feed,
                                         fetch_list=[out.name],
                                         scope=tscope)
    got = fn(f, rw, ro, seed)[0][0].numpy()
    other = fn(f, rw, ro, (seed[0], seed[1] + 1))[0][0].numpy()
    want, = texe.run(tmain, feed=feed, fetch_list=[out.name], scope=tscope)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, other)


def test_example_args_are_staged_as_run_stages_them():
    """int64 ids stage as int32, float64 as float32; the state lies on
    the executor's device."""
    jmain, _, jscope, out = cases.reference(cases.ctr_tower, n_sparse=2)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    rng = np.random.default_rng(3)
    feed = {'C0': rng.integers(0, 1000, (4, 1)),
            'C1': rng.integers(0, 1000, (4, 1)),
            'I': rng.standard_normal((4, 13))}
    _, (f, rw, ro, seed) = texe.compile(tmain, feed=feed,
                                        fetch_list=[out.name],
                                        scope=tscope)
    assert {n: t.dtype for n, t in f.items()} == {
        'C0': torch.int32, 'C1': torch.int32, 'I': torch.float32}
    assert all(t.device.type == 'cpu' for t in ro.values())
    assert seed == (texe._base_seed(tmain), 0)


@pytest.mark.parametrize('make', [_fc, _conv_bn], ids=['fc', 'conv_bn'])
def test_compiled_function_matches_the_reference(make):
    jmain, jexe, jscope, tmain, texe, tscope, fetch, feed = make()
    jfn, jargs = jexe.compile(jmain, feed=feed, fetch_list=[fetch],
                              scope=jscope)
    want = np.asarray(jfn(*jargs)[0][0])
    fn, args = texe.compile(tmain, feed=feed, fetch_list=[fetch],
                            scope=tscope)
    got = fn(*args)[0][0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def test_reset_cache_drops_the_plans():
    _, _, _, tmain, texe, tscope, fetch, feed = _fc()
    texe.compile(tmain, feed=feed, fetch_list=[fetch], scope=tscope)
    assert texe._plans
    texe.reset_cache()
    assert not texe._plans

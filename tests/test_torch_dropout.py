"""The port's ``dropout`` op and layer (paddle_tpu_torch/ops/random.py,
layers/nn.py) against the reference's (paddle_tpu/ops/random.py), on the
CPU.  Fluid's non-inverted dropout, as the reference keeps it:

- p = 0: Out = X and a Mask of ones; ``is_test``: Out = X * (1 - p),
  bitwise equal to the reference's, and a Mask of ones;
- training: Out = X * Mask bitwise, the Mask 0 or 1, no 1 / (1 - p)
  rescale, and the gradient of X the Mask;
- the keep rate within 5 binomial deviations of 1 - p at p = 0.3, 0.4
  and 0.5 (on 2^18 draws), for the port and for the reference;
- a replay of one (program seed, step, op) draws the same Mask; another
  step, another op or another ``seed`` attr draws another;
- through the Executor: a training program's fetched Out equals X times
  its fetched Mask, and ``Program.clone(for_test=True)`` turns the op
  into X * (1 - p), as the reference's clone does.

The draws are not the reference's (Philox against Threefry): the modes
are held bitwise, the masks by distribution.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.core.executor import ExecutionContext as JContext
from paddle_tpu.core.registry import get_op_impl as jget_op

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.executor import ExecutionContext
from paddle_tpu_torch.core.registry import get_op_impl as tget_op

N = 1 << 18


def _x(seed=0, shape=(64, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ctx(step=0, op_index=3, seed=11):
    prog = tfl.Program()
    ctx = ExecutionContext(prog, prog.global_block(), torch.device('cpu'),
                           seed, step)
    ctx.op_index = op_index
    return ctx


def _port(x, attrs, ctx=None):
    outs = tget_op('dropout').compute(ctx or _ctx(),
                                      {'X': [torch.from_numpy(x)]}, attrs)
    return outs['Out'][0].numpy(), outs['Mask'][0].numpy()


@pytest.mark.parametrize('p,is_test', [(0.0, False), (0.0, True),
                                       (0.3, True), (0.5, True)])
def test_deterministic_modes_match_the_reference_bitwise(p, is_test):
    x = _x()
    attrs = {'dropout_prob': p, 'is_test': is_test, 'seed': 0}
    got, mask = _port(x, attrs)
    ref = jget_op('dropout').compute(None, {'X': [x]}, dict(attrs))
    assert np.array_equal(got, np.asarray(ref['Out'][0]))
    assert np.array_equal(mask, np.ones_like(x))
    assert np.array_equal(got, x if p == 0.0 else x * np.float32(1 - p))


@pytest.mark.parametrize('p', [0.3, 0.4, 0.5])
def test_training_mode_is_x_times_a_bernoulli_mask(p):
    x = _x(1, (N,))
    attrs = {'dropout_prob': p, 'is_test': False, 'seed': 0}
    got, mask = _port(x, attrs)
    assert set(np.unique(mask).tolist()) == {0.0, 1.0}
    assert np.array_equal(got, x * mask)
    sigma = np.sqrt(p * (1 - p) / N)
    assert abs(mask.mean() - (1 - p)) <= 5 * sigma
    # the reference's draws obey the same law
    jprog = fluid.Program()
    jctx = JContext(jprog, jprog.global_block(), jax.random.PRNGKey(11))
    ref = jget_op('dropout').compute(jctx, {'X': [x]}, dict(attrs))
    assert abs(np.asarray(ref['Mask'][0]).mean() - (1 - p)) <= 5 * sigma


def test_gradient_of_x_is_the_mask():
    x = torch.from_numpy(_x(2)).requires_grad_(True)
    outs = tget_op('dropout').compute(
        _ctx(), {'X': [x]}, {'dropout_prob': 0.4, 'is_test': False,
                             'seed': 0})
    g, = torch.autograd.grad(outs['Out'][0].sum(), [x])
    assert torch.equal(g, outs['Mask'][0])


def test_replays_draw_the_same_mask_and_other_keys_another():
    x = _x(3)
    attrs = {'dropout_prob': 0.5, 'is_test': False, 'seed': 0}
    m0 = _port(x, attrs, _ctx())[1]
    assert np.array_equal(m0, _port(x, attrs, _ctx())[1])
    for other in (_port(x, attrs, _ctx(step=1))[1],
                  _port(x, attrs, _ctx(op_index=4))[1],
                  _port(x, dict(attrs, seed=5), _ctx())[1]):
        assert not np.array_equal(m0, other)


def _program(pkg, p):
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = 9
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[32], dtype='float32')
            out = pkg.layers.dropout(x=x, dropout_prob=p)
    mask = next(op for op in main.global_block().ops
                if op.type == 'dropout').output('Mask')[0]
    return main, out, mask


@pytest.mark.parametrize('p', [0.0, 0.35])
def test_executor_training_and_test_clone(p):
    feed = {'x': _x(4, (16, 32))}
    main, out, mask = _program(tfl, p)
    jmain, jout, _ = _program(fluid, p)
    assert main.to_dict() == jmain.to_dict()
    exe = tfl.Executor(tfl.CPUPlace())
    o, m = exe.run(main, feed=feed, fetch_list=[out, mask],
                   scope=tfl.Scope())
    assert np.array_equal(o, feed['x'] * m)
    test = main.clone(for_test=True)
    assert all(op.attrs['is_test'] for op in test.global_block().ops
               if op.type == 'dropout')
    got, = exe.run(test, feed=feed, fetch_list=[out], scope=tfl.Scope())
    want, = fluid.Executor(fluid.CPUPlace()).run(
        jmain.clone(for_test=True), feed=feed, fetch_list=[jout],
        scope=fluid.Scope())
    assert np.array_equal(got, np.asarray(want))

"""The ops the port adds for gradient clip, the regularizers and the
learning-rate schedules (paddle_tpu_torch/ops/math.py, activations.py,
tensor_ops.py, loss.py) against the reference's (paddle_tpu/ops/...), on
the CPU: the same seeded numpy inputs through both compute functions,
the outputs' shapes, dtypes and values compared.

Cases: elementwise_{add,sub,mul,div,pow,max,min} with Y of X's shape and
broadcast from an axis (fluid's rule) and from the end; exp, sqrt,
floor, ceil, square, sign (zeros included) and pow with its ``factor``;
reduce_{sum,mean,max,min,prod} over every axis, one axis, a negative
axis, two axes, with ``keep_dim``, and an int32 sum (which keeps its
width); clip; clip_by_norm above, below and at a zero norm; increment
on float32 and int32; the six comparisons; select; square_error_cost.

Tolerance: 1e-6 relative and absolute.  Both sides compute in float32;
exact ops (add, max, floor, sign, comparisons, select...) agree bitwise,
and exp, pow, sqrt, the means and the sums of at most 60 terms differ
by a float32 ulp or two of libm and summation order.
"""
import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (registers the reference's ops)
from paddle_tpu.core.registry import get_op_impl as jget_op

import torch

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core.registry import get_op_impl as tget_op

TOL = 1e-6


def _inputs(seed, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    if positive:
        x = np.abs(x) + 0.5
    return rng, x


def _both(op, ins, attrs, slot='Out'):
    """(port output, reference output) as numpy arrays."""
    want = jget_op(op).compute(None, {k: [v] for k, v in ins.items()},
                               dict(attrs))[slot][0]
    got = tget_op(op).compute(
        None, {k: [torch.from_numpy(np.array(v))] for k, v in ins.items()},
        dict(attrs))[slot][0]
    return got.numpy(), np.asarray(want)


def _check(got, want):
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


BINARY = ['add', 'sub', 'mul', 'div', 'pow', 'max', 'min']
# (Y's shape, axis): X's shape; [3] from axis 1 (fluid's rule); [4]
# from the end
BROADCASTS = [((2, 3, 4), -1), ((3,), 1), ((4,), -1), ((3, 4), 1)]


@pytest.mark.parametrize('y_shape,axis', BROADCASTS)
@pytest.mark.parametrize('name', BINARY)
def test_elementwise_family_matches_the_reference(name, y_shape, axis):
    rng, x = _inputs(1, positive=name == 'pow')
    y = rng.standard_normal(y_shape).astype(np.float32)
    if name == 'div':
        y = np.where(np.abs(y) < 0.1, 0.5, y).astype(np.float32)
    _check(*_both('elementwise_' + name, {'X': x, 'Y': y}, {'axis': axis}))


@pytest.mark.parametrize('op,attrs', [
    ('exp', {}), ('sqrt', {}), ('floor', {}), ('ceil', {}),
    ('square', {}), ('sign', {}), ('pow', {'factor': 2.0}),
    ('pow', {'factor': 0.5}), ('pow', {'factor': -1.5})])
def test_unary_ops_match_the_reference(op, attrs):
    positive = op == 'sqrt' or (op == 'pow' and attrs['factor'] % 1)
    _, x = _inputs(2, positive=positive)
    if op == 'sign':
        x[0, 0] = 0.0
    _check(*_both(op, {'X': x}, attrs))


@pytest.mark.parametrize('dim,keep', [(None, False), (1, False), (-1, True),
                                      ([0, 2], False), ([0, 2], True)])
@pytest.mark.parametrize('name', ['sum', 'mean', 'max', 'min', 'prod'])
def test_reductions_match_the_reference(name, dim, keep):
    _, x = _inputs(3)
    if name == 'prod':
        x = (1.0 + 0.1 * x).astype(np.float32)
    attrs = {'dim': dim, 'keep_dim': keep, 'reduce_all': dim is None}
    _check(*_both('reduce_' + name, {'X': x}, attrs))


def test_integer_sum_keeps_its_width():
    x = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    got, want = _both('reduce_sum', {'X': x},
                      {'dim': None, 'keep_dim': False, 'reduce_all': True})
    assert got.dtype == want.dtype == np.int32 and got.shape == (1,)
    assert np.array_equal(got, want)


def test_clip_matches_the_reference():
    _, x = _inputs(4)
    _check(*_both('clip', {'X': x}, {'min': -0.3, 'max': 0.7}))


@pytest.mark.parametrize('scale,max_norm', [(1.0, 0.5), (1.0, 100.0),
                                            (0.0, 1.0)])
def test_clip_by_norm_matches_the_reference(scale, max_norm):
    _, x = _inputs(5)
    x = (x * scale).astype(np.float32)
    got, want = _both('clip_by_norm', {'X': x}, {'max_norm': max_norm})
    _check(got, want)
    assert np.linalg.norm(got) <= max_norm * (1 + TOL)


@pytest.mark.parametrize('dtype,step', [(np.float32, 1.0), (np.float32, 2.5),
                                        (np.int32, 1.0)])
def test_increment_matches_the_reference(dtype, step):
    x = np.array([3], dtype=dtype)
    got, want = _both('increment', {'X': x}, {'step': step})
    assert got.dtype == want.dtype == dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize('op', ['less_than', 'less_equal', 'greater_than',
                                'greater_equal', 'equal', 'not_equal'])
def test_comparisons_match_the_reference(op):
    rng = np.random.default_rng(6)
    x = rng.integers(0, 3, (4, 5)).astype(np.float32)
    y = rng.integers(0, 3, (4, 5)).astype(np.float32)
    got, want = _both(op, {'X': x, 'Y': y}, {})
    assert got.dtype == want.dtype == np.bool_
    assert np.array_equal(got, want) and got.any() and not got.all()


def test_select_matches_the_reference():
    rng, x = _inputs(7)
    y = rng.standard_normal(x.shape).astype(np.float32)
    cond = rng.integers(0, 2, x.shape).astype(np.bool_)
    got, want = _both('select', {'Condition': cond, 'X': x, 'Y': y}, {})
    assert np.array_equal(got, want)


def test_square_error_cost_matches_the_reference():
    rng, x = _inputs(8)
    y = rng.standard_normal(x.shape).astype(np.float32)
    _check(*_both('square_error_cost', {'X': x, 'Y': y}, {}))

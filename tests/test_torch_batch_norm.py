"""The port's ``batch_norm`` op (paddle_tpu_torch/ops/norm.py) against the
reference's (paddle_tpu/ops/norm.py), on the CPU.

- The op in training and ``is_test`` mode, NCHW and NHWC, from a nonzero
  running mean and a non-unit running variance: all five outputs (Y,
  MeanOut, VarianceOut, SavedMean, SavedVariance) against the
  reference's op on the same seeded inputs (its two-pass statistics,
  ``use_shift=False``, which the reference takes off the TPU).
- ``BatchNormTrain``'s gradients (x, scale, bias) against ``jax.vjp`` of
  the reference's ``_bn_train`` under seeded cotangents of all three
  outputs (y, batch mean, batch variance) and of y alone (the loss path,
  where the statistics' cotangents are None in the port).
- ``torch.autograd.gradcheck`` of the Function in float64.
- The running statistics reach the op's outputs detached.

Tolerances: outputs 1e-5 absolute (float32 statistics of O(1) inputs
over at most 2 * 6 * 7 = 84 elements; y is O(3)); gradients 1e-5 of
max(1, the largest entry): dscale and dbias sum 84 products of O(1)
terms in other orders.  gradcheck at its float64 defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401
from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.ops import norm as jnorm

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.ops.norm import BatchNormTrain

TOL = 1e-5
SLOTS = ('Y', 'MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance')


def _inputs(layout, seed, c=5):
    rng = np.random.default_rng(seed)
    shape = (2, c, 6, 7) if layout == 'NCHW' else (2, 6, 7, c)
    return {
        'X': [(rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)],
        'Scale': [rng.uniform(0.5, 1.5, c).astype(np.float32)],
        'Bias': [rng.standard_normal(c).astype(np.float32)],
        'Mean': [rng.standard_normal(c).astype(np.float32)],
        'Variance': [rng.uniform(0.5, 2.0, c).astype(np.float32)],
    }


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('is_test', [False, True])
def test_batch_norm_op_matches_the_reference(layout, is_test):
    ins = _inputs(layout, 3)
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': is_test,
             'data_layout': layout}
    want = jget_op('batch_norm').compute(
        None, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    got = tget_op('batch_norm').compute(
        None, {k: [torch.tensor(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    for slot in SLOTS:
        a, b = got[slot][0].detach().numpy(), np.asarray(want[slot][0])
        assert a.shape == b.shape and a.dtype == b.dtype, slot
        assert np.abs(a - b).max() <= TOL, slot
    if not is_test:
        # the running statistics moved from the nonzero start
        assert np.abs(got['MeanOut'][0].numpy() - ins['Mean'][0]).max() > 0


def test_running_statistics_leave_the_op_detached():
    ins = _inputs('NCHW', 4)
    tins = {k: [torch.tensor(v, requires_grad=k in ('X', 'Scale', 'Bias'))
                for v in vs] for k, vs in ins.items()}
    got = tget_op('batch_norm').compute(None, tins, {'momentum': 0.9})
    assert got['Y'][0].requires_grad
    assert not got['MeanOut'][0].requires_grad
    assert not got['VarianceOut'][0].requires_grad


def _bn_case(layout, seed):
    ins = _inputs(layout, seed)
    x, scale, bias = ins['X'][0], ins['Scale'][0], ins['Bias'][0]
    ch = 1 if layout == 'NCHW' else 3
    axes = tuple(i for i in range(4) if i != ch)
    return x, scale, bias, ins['Mean'][0], axes


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('stat_cotangents', [True, False])
def test_function_gradients_match_the_reference_vjp(layout,
                                                    stat_cotangents):
    x, scale, bias, shift, axes = _bn_case(layout, 5)
    eps = 1e-5
    outs, vjp = jax.vjp(
        lambda a, s, b, sh: jnorm._bn_train(a, s, b, sh, axes, eps, False),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(shift))
    rng = np.random.default_rng(6)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    if not stat_cotangents:
        cts[1][:] = 0.0
        cts[2][:] = 0.0
    jgrads = vjp(tuple(jnp.asarray(c) for c in cts))[:3]

    targs = [torch.tensor(a, requires_grad=True) for a in (x, scale, bias)]
    touts = BatchNormTrain.apply(*targs, axes, eps)
    for a, b in zip(touts, outs):
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= TOL
    if stat_cotangents:
        tgrads = torch.autograd.grad(touts, targs,
                                     [torch.tensor(c) for c in cts])
    else:   # the loss path: only y is differentiated
        tgrads = torch.autograd.grad(touts[0], targs, torch.tensor(cts[0]))
    for a, b in zip(tgrads, jgrads):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= TOL * max(1.0,
                                                        np.abs(b).max())


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
def test_function_passes_gradcheck_in_float64(layout):
    rng = np.random.default_rng(7)
    c = 3
    shape = (2, c, 4, 3) if layout == 'NCHW' else (2, 4, 3, c)
    axes = (0, 2, 3) if layout == 'NCHW' else (0, 1, 2)
    x = torch.tensor(rng.standard_normal(shape), requires_grad=True)
    s = torch.tensor(rng.uniform(0.5, 1.5, c), requires_grad=True)
    b = torch.tensor(rng.standard_normal(c), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *a: BatchNormTrain.apply(*a, axes, 1e-5), (x, s, b))
    assert torch.autograd.gradcheck(
        lambda *a: BatchNormTrain.apply(*a, axes, 1e-5)[0], (x, s, b))

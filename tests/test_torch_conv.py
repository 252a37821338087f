"""The port's ``conv2d`` and ``pool2d`` ops (paddle_tpu_torch/ops/conv.py,
ops/pool.py) against the reference's (paddle_tpu/ops/conv.py, pool.py),
on the CPU: the same seeded numpy inputs through both compute functions,
the outputs compared, and the gradients of input and filter by
``jax.vjp`` against ``torch.autograd`` under one seeded cotangent.

conv2d cases: NCHW and NHWC, strides 1 and 2, paddings 0, 1 and 3,
dilation 2, groups 2, 1x1, 3x3 and 7x7 filters.  pool2d cases: max and
avg, ``exclusive`` on and off with and without padding, a padding wider
than half the window (the port pads it itself), global pooling, both
layouts.

Tolerance: 1e-5 of max(1, the largest entry) on outputs and gradients.
Both sides compute in float32 on O(1) inputs and sum at most
C_in * kh * kw = 8 * 49 = 392 products (a filter gradient sums
B * H_out * W_out <= 2 * 16 * 16 = 512, reaching ~25) in other orders:
a few float32 ulps of the sum (the largest gap measured was 1.1e-5 on a
filter gradient entry of 22.6, 5e-7 of it).  Pooling outputs and their
gradients are a max or a float32 mean of at most 16 inputs; max pooling
and its gradient are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference's ops)
from paddle_tpu.core.registry import get_op_impl as jget_op

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core.registry import get_op_impl as tget_op

TOL = 1e-5


def _vjp_both(op, x, w, attrs, in_slot, w_slot, out_slot, seed):
    """(port out, grads), (reference out, grads) of ``op`` at x (and w)
    under one seeded cotangent."""
    def jfn(*args):
        ins = {in_slot: [args[0]]}
        if w_slot:
            ins[w_slot] = [args[1]]
        return jget_op(op).compute(None, ins, dict(attrs))[out_slot][0]

    args = (x,) if w is None else (x, w)
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    ct = np.random.default_rng(seed).standard_normal(
        jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))

    targs = [torch.tensor(a, requires_grad=True) for a in args]
    ins = {in_slot: [targs[0]]}
    if w_slot:
        ins[w_slot] = [targs[1]]
    tout = tget_op(op).compute(None, ins, dict(attrs))[out_slot][0]
    tgrads = torch.autograd.grad(tout, targs, torch.tensor(ct))
    return (tout.detach().numpy(), [g.numpy() for g in tgrads]), \
        (np.asarray(jout), [np.asarray(g) for g in jgrads])


def _assert_close(got, want):
    (tout, tgrads), (jout, jgrads) = got, want
    assert tout.shape == jout.shape and tout.dtype == jout.dtype
    for a, b in zip([tout] + tgrads, [jout] + jgrads):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * max(1.0, np.abs(b).max())


CONV_CASES = [
    # fmt, B, C_in, H, W, C_out, k, stride, pad, dilation, groups
    ('NCHW', 2, 3, 9, 9, 4, 3, 1, 1, 1, 1),
    ('NCHW', 2, 3, 16, 16, 8, 7, 2, 3, 1, 1),     # the ResNet stem
    ('NCHW', 2, 8, 8, 8, 6, 1, 2, 0, 1, 1),       # 1x1 / 2 shortcut
    ('NCHW', 2, 4, 10, 10, 4, 3, 1, 2, 2, 1),     # dilation 2
    ('NCHW', 2, 4, 8, 8, 6, 3, 1, 1, 1, 2),       # groups 2
    ('NCHW', 1, 2, 7, 11, 3, 3, 2, 0, 1, 1),
    ('NHWC', 2, 3, 9, 9, 4, 3, 1, 1, 1, 1),
    ('NHWC', 2, 3, 16, 16, 8, 7, 2, 3, 1, 1),
    ('NHWC', 2, 8, 8, 8, 6, 1, 1, 0, 1, 1),
    ('NHWC', 2, 4, 8, 8, 6, 3, 2, 1, 1, 2),
]


@pytest.mark.parametrize('case', CONV_CASES, ids=lambda c: '-'.join(
    map(str, c)))
def test_conv2d_matches_the_reference(case):
    fmt, b, ci, h, w, co, k, s, p, d, g = case
    rng = np.random.default_rng(sum(case[1:]))
    shape = (b, ci, h, w) if fmt == 'NCHW' else (b, h, w, ci)
    x = rng.standard_normal(shape).astype(np.float32)
    f = (rng.standard_normal((co, ci // g, k, k)) /
         np.sqrt(ci * k * k)).astype(np.float32)
    attrs = {'strides': [s, s], 'paddings': [p, p], 'dilations': [d, d],
             'groups': g, 'data_format': fmt}
    _assert_close(*_vjp_both('conv2d', x, f, attrs, 'Input', 'Filter',
                             'Output', seed=1))


POOL_CASES = [
    # fmt, type, ksize, stride, pad, global, exclusive
    ('NCHW', 'max', 3, 2, 1, False, True),        # the ResNet stem's
    ('NCHW', 'max', 2, 2, 0, False, True),        # the MNIST nets'
    ('NCHW', 'max', 3, 1, 0, False, True),
    ('NCHW', 'avg', 3, 2, 1, False, True),        # valid-cell divisor
    ('NCHW', 'avg', 3, 2, 1, False, False),       # prod(ksize) divisor
    ('NCHW', 'avg', 2, 2, 0, False, True),
    ('NCHW', 'avg', 2, 1, 0, False, False),
    ('NCHW', 'avg', 3, 1, 2, False, True),        # padding past k // 2
    ('NCHW', 'avg', 3, 1, 2, False, False),
    ('NCHW', 'max', 3, 1, 2, False, True),
    ('NCHW', 'avg', 7, 1, 0, True, True),         # ResNet's global pool
    ('NCHW', 'max', 2, 1, 0, True, True),
    ('NHWC', 'max', 3, 2, 1, False, True),
    ('NHWC', 'avg', 3, 2, 1, False, True),
    ('NHWC', 'avg', 3, 2, 1, False, False),
    ('NHWC', 'avg', 7, 1, 0, True, True),
]


@pytest.mark.parametrize('case', POOL_CASES, ids=lambda c: '-'.join(
    map(str, c)))
def test_pool2d_matches_the_reference(case):
    fmt, ptype, k, s, p, glob, excl = case
    rng = np.random.default_rng(k * 10 + s + p)
    shape = (2, 3, 9, 8) if fmt == 'NCHW' else (2, 9, 8, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    attrs = {'pooling_type': ptype, 'ksize': [k, k], 'strides': [s, s],
             'paddings': [p, p], 'global_pooling': glob,
             'exclusive': excl, 'data_format': fmt}
    _assert_close(*_vjp_both('pool2d', x, None, attrs, 'X', None, 'Out',
                             seed=2))


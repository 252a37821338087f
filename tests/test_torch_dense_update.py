"""The port's dense optimizer applies (paddle_tpu_torch/ops/kernels/
dense_update.py: ``plain_sgd`` / ``plain_momentum`` / ``plain_adam``
behind ``dense_apply_*``) against the reference's two lowerings on the
same numpy inputs:

- the XLA branch of paddle_tpu/ops/optim_ops.py (``_sgd`` :143-157,
  ``_momentum`` :174-178, ``_adam`` :233-235), called eagerly: bitwise
  equal, since both round each product and sum separately in the same
  order;
- the fused Pallas kernel ``dense_apply_*(..., interpret=True)``:
  within 1e-6 absolute, about four float32 ulps at the O(1) to O(4)
  magnitudes here.  The reference kernel does not match its own XLA
  branch bitwise off the TPU (XLA contracts its fused body into FMAs;
  ROADMAP "Reference caveats"), so neither can the port.

On the card the CUDA kernel is held bitwise to the plain versions
(chip_smoke.py); here the wrappers take the plain versions.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import optim_ops as jopt
from paddle_tpu.ops.pallas import dense_update as jdu
from paddle_tpu_torch.ops.kernels import dense_update as tdu
from paddle_tpu_torch.ops import optim_ops as topt

TOL_KERNEL = 1e-6
SHAPES = [(1,), (37, 129), (3, 5, 7)]


def _state(shape, seed=0):
    rng = np.random.default_rng(seed)
    p, m, g = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    v = rng.random(shape).astype(np.float32)
    lr = np.array([1e-3], np.float32)
    return p, m, v, g, lr


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _same(got, want):
    assert np.array_equal(got.numpy(), np.asarray(want))


def _near(got, want):
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= TOL_KERNEL


@pytest.mark.parametrize('shape', SHAPES)
def test_adam_matches_reference(shape):
    p, m, v, g, lr = _state(shape)
    b1p = np.array([0.9 ** 3], np.float32)
    b2p = np.array([0.999 ** 3], np.float32)
    ins = {'Param': [p], 'Grad': [g], 'Moment1': [m], 'Moment2': [v],
           'LearningRate': [lr], 'Beta1Pow': [b1p], 'Beta2Pow': [b2p]}
    attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}
    want = jopt._adam(None, {k: [jnp.asarray(x) for x in vs]
                             for k, vs in ins.items()}, attrs)
    got = topt._adam(None, {k: [_t(x) for x in vs]
                            for k, vs in ins.items()}, attrs)
    for slot in ('ParamOut', 'Moment1Out', 'Moment2Out'):
        _same(got[slot][0], want[slot][0])
    lr_t = jnp.asarray(lr) * jnp.sqrt(1 - jnp.asarray(b2p)) / (
        1 - jnp.asarray(b1p))
    kern = jdu.dense_apply_adam(jnp.asarray(p), jnp.asarray(m),
                                jnp.asarray(v), jnp.asarray(g),
                                lr_t.reshape(()), 0.9, 0.999, 1e-8,
                                interpret=True)
    for slot, k in zip(('ParamOut', 'Moment1Out', 'Moment2Out'), kern):
        _near(got[slot][0], k)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('wd', [0.0, 0.01])
def test_sgd_matches_reference(shape, wd):
    p, _, _, g, lr = _state(shape, 1)
    attrs = {'weight_decay': wd} if wd else {}
    want = jopt._sgd(None, {'Param': [jnp.asarray(p)],
                            'Grad': [jnp.asarray(g)],
                            'LearningRate': [jnp.asarray(lr)]}, attrs)
    got = topt._sgd(None, {'Param': [_t(p)], 'Grad': [_t(g)],
                           'LearningRate': [_t(lr)]}, attrs)
    _same(got['ParamOut'][0], want['ParamOut'][0])
    kern = jdu.dense_apply_sgd(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(lr).reshape(()),
        weight_decay=jnp.float32(wd) if wd else None, interpret=True)
    _near(got['ParamOut'][0], kern)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('nesterov', [False, True])
def test_momentum_matches_reference(shape, nesterov):
    p, vel, _, g, lr = _state(shape, 2)
    attrs = {'mu': 0.9, 'use_nesterov': nesterov}
    want = jopt._momentum(None, {'Param': [jnp.asarray(p)],
                                 'Grad': [jnp.asarray(g)],
                                 'Velocity': [jnp.asarray(vel)],
                                 'LearningRate': [jnp.asarray(lr)]}, attrs)
    got = topt._momentum(None, {'Param': [_t(p)], 'Grad': [_t(g)],
                                'Velocity': [_t(vel)],
                                'LearningRate': [_t(lr)]}, attrs)
    for slot in ('ParamOut', 'VelocityOut'):
        _same(got[slot][0], want[slot][0])
    kern = jdu.dense_apply_momentum(
        jnp.asarray(p), jnp.asarray(vel), jnp.asarray(g),
        jnp.asarray(lr).reshape(()), 0.9, use_nesterov=nesterov,
        interpret=True)
    for slot, k in zip(('ParamOut', 'VelocityOut'), kern):
        _near(got[slot][0], k)


def test_apply_updates_in_place_and_counts_no_launch_on_cpu():
    p, m, v, g, lr = (_t(x) for x in _state((4, 6), 3))
    ids = [x.data_ptr() for x in (p, m, v)]
    want = tdu.plain_adam(p, m, v, g, _t(lr), 0.9, 0.999, 1e-8)
    out = tdu.dense_apply_adam(p, m, v, g, _t(lr), 0.9, 0.999, 1e-8)
    assert [x.data_ptr() for x in out] == ids
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    empty = torch.zeros((0, 3))
    assert tdu.dense_apply_sgd(empty, empty, _t(lr)).numel() == 0
    assert tdu.launches == 0


@pytest.mark.parametrize('bad', [
    lambda p, g, lr: (p.double(), g.double(), lr),      # dtype
    lambda p, g, lr: (p, g[:2], lr),                    # shape
    lambda p, g, lr: (p.t(), g.t(), lr),                # not contiguous
    lambda p, g, lr: (p, g, lr.repeat(2)),              # lr not a scalar
    lambda p, g, lr: (p.to('meta'), g.to('meta'),       # device
                      lr.to('meta')),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p, _, _, g, lr = (_t(x) for x in _state((4, 6), 4))
    with pytest.raises((TypeError, ValueError)):
        tdu.dense_apply_sgd(*bad(p, g, lr))


def test_sparse_gradient_raises_naming_the_slice():
    """Row-sparse gradients came with the seq2seq slice
    (tests/test_torch_sparse.py); one for a row-sharded table still
    raises, naming the multi-chip slice."""
    p, _, _, g, lr = (_t(x) for x in _state((4, 6), 5))
    rows = torch.tensor([0, 2, 2, 3])
    with pytest.raises(NotImplementedError, match='multi-chip'):
        topt._sgd(None, {'Param': [p], 'Grad': [(rows, g)],
                         'LearningRate': [lr]}, {'embed_ways': 2})

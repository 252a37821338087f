"""The ops the CTR family brings to the port (``sigmoid``, ``auc``,
``cos_sim``, ``sequence_conv``), against the reference's ops on the same
seeded numpy inputs, on the CPU.

- ``sigmoid`` elementwise; ``auc`` on two-column probabilities and on a
  flat score, with both classes present, with one class only, and with
  scores on the thresholds themselves; ``cos_sim`` with a full Y and a
  one-row Y (broadcast), its norms too; ``sequence_conv`` at ragged
  lengths (a row of length 1, a full row, a row of length 0), at windows
  of 1 to 5 steps, centred and shifted (all frames before the first step
  or past the row), so the edge frames are exercised.
- The gradients of ``cos_sim`` (X and Y, the broadcast Y summed over
  rows) and ``sequence_conv`` (X and Filter) from ``torch.autograd``
  against ``jax.vjp`` of the reference's op, for one seeded cotangent.

Tolerances: 1e-6 absolute on values (float32, O(1) outputs); the AUC is
a sum of 199 trapezoids of count ratios, held to 1e-6 too; gradients
1e-5 absolute (sums of up to a few dozen O(1) products in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_impl as jget_op

import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.core.registry import get_op_impl as tget_op

TOL = 1e-6
TOL_GRAD = 1e-5


def _ref(op, ins, attrs):
    return jget_op(op).compute(
        None, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))


def _port(op, ins, attrs):
    return tget_op(op).compute(
        None, {k: [torch.tensor(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))


def _close(got, want, slots, tol=TOL):
    for slot in slots:
        a, b = got[slot][0].numpy(), np.asarray(want[slot][0])
        assert a.shape == b.shape and a.dtype == b.dtype, slot
        assert np.abs(a - b).max() <= tol, (slot, np.abs(a - b).max())


def test_sigmoid_matches_the_reference():
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    x[0, :3] = [-30.0, 0.0, 30.0]
    _close(_port('sigmoid', {'X': [x]}, {}), _ref('sigmoid', {'X': [x]}, {}),
           ['Out'])


def _auc_case(kind, rng):
    n = 64
    if kind == 'on_thresholds':
        score = (rng.integers(0, 200, n) + 0.5) / 200.0
    else:
        score = rng.random(n)
    label = rng.integers(0, 2, (n, 1))
    if kind == 'one_class':
        label[:] = 1
    probs = np.stack([1 - score, score], axis=1).astype(np.float32)
    if kind == 'flat':
        probs = score.astype(np.float32).reshape(n, 1)
    return {'Out': [probs], 'Label': [label.astype(np.int64)]}


@pytest.mark.parametrize('kind', ['two_column', 'flat', 'one_class',
                                  'on_thresholds'])
@pytest.mark.parametrize('num_thresholds', [200, 7])
def test_auc_matches_the_reference(kind, num_thresholds):
    ins = _auc_case(kind, np.random.default_rng(len(kind)))
    attrs = {'curve': 'ROC', 'num_thresholds': num_thresholds}
    got = _port('auc', ins, attrs)
    _close(got, _ref('auc', ins, attrs), ['AUC'])
    assert got['AUC'][0].shape == (1,)


def test_auc_of_a_perfect_ranking_is_one():
    score = np.linspace(0.01, 0.99, 40).astype(np.float32)
    label = (score > 0.5).astype(np.int64).reshape(-1, 1)
    probs = np.stack([1 - score, score], axis=1)
    got = _port('auc', {'Out': [probs], 'Label': [label]}, {})
    assert abs(float(got['AUC'][0][0]) - 1.0) <= TOL


@pytest.mark.parametrize('y_rows', [6, 1])
def test_cos_sim_and_its_gradients_match_the_reference(y_rows):
    rng = np.random.default_rng(y_rows)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    y = rng.standard_normal((y_rows, 9)).astype(np.float32)
    x[2] = 0.0   # a zero row: the 1e-12 keeps it finite
    ins = {'X': [x], 'Y': [y]}
    got = _port('cos_sim', ins, {})
    _close(got, _ref('cos_sim', ins, {}), ['Out', 'XNorm', 'YNorm'])
    ct = rng.standard_normal((6, 1)).astype(np.float32)

    def ref_out(a, b):
        return jget_op('cos_sim').compute(None, {'X': [a], 'Y': [b]},
                                          {})['Out'][0]
    _, vjp = jax.vjp(ref_out, jnp.asarray(x), jnp.asarray(y))
    want = vjp(jnp.asarray(ct))
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    o = tget_op('cos_sim').compute(None, {'X': [tx], 'Y': [ty]},
                                   {})['Out'][0]
    gx, gy = torch.autograd.grad(o, [tx, ty], torch.tensor(ct))
    for a, b in zip((gx, gy), want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        # the zero row's norm has no derivative: NaN on both sides alike
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        assert ok.any() and np.abs(a[ok] - b[ok]).max() <= TOL_GRAD


SEQ_CONV_CASES = [   # (contextLength, contextStart)
    (3, None), (1, None), (4, None), (5, None), (3, 0), (2, -3), (3, 6),
]


@pytest.mark.parametrize('ctx_len,ctx_start', SEQ_CONV_CASES)
def test_sequence_conv_and_its_gradients_match_the_reference(ctx_len,
                                                             ctx_start):
    rng = np.random.default_rng(ctx_len * 10 + (ctx_start or 0) + 50)
    b, t, d, m = 4, 6, 5, 3
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w = rng.standard_normal((ctx_len * d, m)).astype(np.float32)
    lengths = np.array([6, 1, 4, 0], np.int32)
    attrs = {'contextLength': ctx_len, 'contextStride': 1}
    if ctx_start is not None:
        attrs['contextStart'] = ctx_start
    ins = {'X': [x], 'Filter': [w], 'XLen': [lengths]}
    got = _port('sequence_conv', ins, attrs)
    _close(got, _ref('sequence_conv', ins, attrs), ['Out'])
    out = got['Out'][0].numpy()
    assert not out[1, 1:].any() and not out[3].any()   # past each length
    ct = rng.standard_normal((b, t, m)).astype(np.float32)

    def ref_out(a, f):
        return jget_op('sequence_conv').compute(
            None, {'X': [a], 'Filter': [f], 'XLen': [jnp.asarray(lengths)]},
            dict(attrs))['Out'][0]
    _, vjp = jax.vjp(ref_out, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(ct))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    o = tget_op('sequence_conv').compute(
        None, {'X': [tx], 'Filter': [tw], 'XLen': [torch.tensor(lengths)]},
        dict(attrs))['Out'][0]
    gx, gw = torch.autograd.grad(o, [tx, tw], torch.tensor(ct))
    for a, b2 in zip((gx, gw), want):
        assert a.shape == b2.shape
        assert np.abs(a.numpy() - np.asarray(b2)).max() <= TOL_GRAD


def test_sequence_conv_without_lengths_takes_every_row_full():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 2)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    ins = {'X': [x], 'Filter': [w]}
    attrs = {'contextLength': 3, 'contextStart': -1}
    _close(_port('sequence_conv', ins, attrs),
           _ref('sequence_conv', ins, attrs), ['Out'])

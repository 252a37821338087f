"""The port's CTC loss (paddle_tpu_torch/ops/ctc.py ``warpctc``) against
the reference's (paddle_tpu/ops/ctc.py) on the same seeded numpy inputs,
on the CPU, and against tests/test_ctc_op.py's brute force.

- The loss with ``norm_by_times`` off and on, with ragged logits and
  labels (a row of one label, a row whose labels repeat, so the skip
  transition is barred, a row with no label), with the label lengths
  given and counted from the labels (ids above 0), with [B, L] and [B, L,
  1] labels, and with a blank other than 0; WarpCTCGrad, the
  log-softmax, too.
- The gradient with respect to the logits from ``torch.autograd``
  against ``jax.grad`` of the reference op's loss for one seeded
  cotangent, ``norm_by_times`` off and on.

Tolerances: the loss 1e-5 absolute (O(10) values, log-sum-exps over 9
steps in float32); the gradient 1e-5 absolute (differences of softmax
probabilities and alignment posteriors, O(1)); the enumeration 1e-4
relative (float64 against float32).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_impl as jget_op

import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.core.registry import get_op_impl as tget_op

from torch_seqlab_cases import CTC_B as B, CTC_CASES, ctc_case

TOL = 1e-5
TOL_GRAD = 1e-5


def _ref(ins, attrs):
    return jget_op('warpctc').compute(
        None, {k: [jnp.asarray(v[0])] for k, v in ins.items()}, attrs)


def _port(ins, attrs, logits=None):
    t = {k: [torch.tensor(v[0])] for k, v in ins.items()}
    if logits is not None:
        t['Logits'] = [logits]
    return tget_op('warpctc').compute(None, t, attrs)


@pytest.mark.parametrize('name', list(CTC_CASES))
def test_warpctc_matches_the_reference(name):
    kwargs, attrs = CTC_CASES[name]
    ins = ctc_case(**kwargs)
    got = _port(ins, attrs)
    want = _ref(ins, attrs)
    loss = got['Loss'][0].numpy()
    assert loss.shape == (B, 1) and np.isfinite(loss).all()
    assert np.abs(loss - np.asarray(want['Loss'][0])).max() <= TOL
    assert np.abs(got['WarpCTCGrad'][0].numpy() -
                  np.asarray(want['WarpCTCGrad'][0])).max() <= TOL


@pytest.mark.parametrize('norm', [False, True])
def test_warpctc_gradient_matches_jax_grad(norm):
    ins = ctc_case(5)
    attrs = {'norm_by_times': norm}
    ct = np.random.default_rng(6).standard_normal((B, 1)).astype(np.float32)

    def ref_loss(x):
        r = jget_op('warpctc').compute(
            None, dict({k: [jnp.asarray(v[0])] for k, v in ins.items()},
                       Logits=[x]), attrs)
        return jnp.sum(r['Loss'][0] * ct)
    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(ins['Logits'][0])))
    x = torch.tensor(ins['Logits'][0], requires_grad=True)
    loss = _port(ins, attrs, logits=x)['Loss'][0]
    got, = torch.autograd.grad(loss, [x], torch.tensor(ct))
    assert np.abs(got.numpy() - want).max() <= TOL_GRAD


def _collapse(path, blank=0):
    out, prev = [], None
    for p in path:
        if p != prev and p != blank:
            out.append(p)
        prev = p
    return tuple(out)


def test_warpctc_matches_the_enumeration():
    """tests/test_ctc_op.py's brute force over every alignment."""
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((3, 4, 3)).astype(np.float32)
    labels = np.asarray([[1, 2], [2, 2], [1, 0]], np.int64)
    label_len = np.asarray([2, 2, 1], np.int64)
    logit_len = np.asarray([4, 4, 3], np.int64)
    got = _port({'Logits': [logits], 'Label': [labels],
                 'LogitsLen': [logit_len], 'LabelLen': [label_len]},
                {})['Loss'][0].numpy()[:, 0]
    x = logits.astype(np.float64)
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    for b in range(3):
        total = -np.inf
        for path in itertools.product(range(3), repeat=int(logit_len[b])):
            if _collapse(path) == tuple(labels[b, :label_len[b]]):
                total = np.logaddexp(total, sum(lp[b, i, p]
                                                for i, p in enumerate(path)))
        assert abs(got[b] + total) <= 1e-4 * abs(total)

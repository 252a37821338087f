"""The port's linear-chain CRF ops (paddle_tpu_torch/ops/crf.py) against
the reference's (paddle_tpu/ops/crf.py) on the same seeded numpy inputs,
on the CPU, and both against a brute-force enumeration of every tag path
(tests/test_crf_op.py's).

- ``linear_chain_crf`` at every length 1 (one step: no transition, start
  and end on one tag), every length T, and mixed lengths with a length-1
  row; labels on the padding are drawn too, as a feeder's zeros would
  be.
- Its gradients with respect to the emission and the transition from
  ``torch.autograd`` against ``jax.grad`` of the reference's ``crf_nll``
  for one seeded cotangent.
- ``crf_decoding`` paths, with and without ``Label``, equal to the
  reference's, zeros on the padding; on near-tied scores (emissions
  rounded to a coarse grid) too, where the first-index tie rule decides.
- Neither package's CRF has a Pallas kernel, so there is no interpret
  mode to reach: the reference op is called directly.

Tolerances: the NLL 1e-5 absolute (O(10) values from log-sum-exps over
at most 7 steps in float32); gradients 1e-5 absolute (softmax
marginals and label counts, O(1)); the enumeration 1e-4 (numpy's float64
against float32).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.ops.crf import crf_nll as jcrf_nll

import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.ops.crf import crf_nll, crf_viterbi
from torch_seqlab_cases import CRF_B as B, CRF_LENGTHS as LENGTHS
from torch_seqlab_cases import CRF_N as N, CRF_T as T, crf_case

TOL = 1e-5
TOL_GRAD = 1e-5
TOL_ENUM = 1e-4


def _ref(op, ins, attrs=None):
    return jget_op(op).compute(
        None, {k: [jnp.asarray(v[0])] for k, v in ins.items()}, attrs or {})


def _port(op, ins, attrs=None):
    return tget_op(op).compute(
        None, {k: [torch.tensor(v[0])] for k, v in ins.items()}, attrs or {})


def _case(kind, seed=0, coarse=False):
    return {k: v[0] for k, v in crf_case(kind, seed, coarse).items()}


@pytest.mark.parametrize('kind', list(LENGTHS))
def test_linear_chain_crf_matches_the_reference(kind):
    ins = crf_case(kind)
    got = _port('linear_chain_crf', ins)['LogLikelihood'][0]
    want = np.asarray(_ref('linear_chain_crf', ins)['LogLikelihood'][0])
    assert got.shape == want.shape == (B, 1)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize('kind', list(LENGTHS))
def test_linear_chain_crf_gradients_match_jax_grad(kind):
    ins = _case(kind, seed=1)
    lengths = ins['EmissionLen']
    labels = ins['Label'][..., 0]
    ct = np.random.default_rng(2).standard_normal(B).astype(np.float32)

    def ref_loss(e, tr):
        return jnp.sum(jcrf_nll(e, jnp.asarray(lengths, jnp.int32), tr,
                                jnp.asarray(labels, jnp.int32)) * ct)
    want = jax.grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(ins['Emission']), jnp.asarray(ins['Transition']))
    e = torch.tensor(ins['Emission'], requires_grad=True)
    tr = torch.tensor(ins['Transition'], requires_grad=True)
    nll = crf_nll(e, torch.tensor(lengths), tr, torch.tensor(labels))
    got = torch.autograd.grad(nll, [e, tr], torch.tensor(ct))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL_GRAD


@pytest.mark.parametrize('kind', list(LENGTHS))
@pytest.mark.parametrize('coarse', [False, True])
@pytest.mark.parametrize('with_label', [False, True])
def test_crf_decoding_matches_the_reference(kind, coarse, with_label):
    ins = crf_case(kind, seed=3, coarse=coarse)
    if not with_label:
        del ins['Label']
    got = _port('crf_decoding', ins)['ViterbiPath'][0]
    want = np.asarray(_ref('crf_decoding', ins)['ViterbiPath'][0])
    assert got.dtype == torch.int32 and got.shape == (B, T, 1)
    assert np.array_equal(got.numpy(), want)
    pad = np.arange(T)[None, :] >= ins['EmissionLen'][0][:, None]
    assert (got.numpy()[..., 0][pad] == 0).all()


def _paths_scores(emission, transition, length):
    start, end, trans = transition[0], transition[1], transition[2:]
    for path in itertools.product(range(N), repeat=length):
        s = start[path[0]] + end[path[-1]]
        s += sum(float(emission[t, path[t]]) for t in range(length))
        s += sum(float(trans[path[t], path[t + 1]])
                 for t in range(length - 1))
        yield path, s


def test_both_packages_match_the_enumeration():
    """tests/test_crf_op.py's brute force, at B=4 N=5 and lengths up to
    5: the NLL and the best path of each row."""
    rng = np.random.default_rng(5)
    emission = rng.standard_normal((B, 5, N)).astype(np.float32)
    transition = rng.standard_normal((N + 2, N)).astype(np.float32)
    labels = rng.integers(0, N, (B, 5)).astype(np.int64)
    lengths = np.asarray([5, 1, 3, 4], np.int64)
    nll = crf_nll(torch.tensor(emission), torch.tensor(lengths),
                  torch.tensor(transition), torch.tensor(labels)).numpy()
    path = crf_viterbi(torch.tensor(emission), torch.tensor(lengths),
                       torch.tensor(transition)).numpy()
    jnll = np.asarray(jcrf_nll(jnp.asarray(emission), jnp.asarray(lengths),
                               jnp.asarray(transition),
                               jnp.asarray(labels)))
    for b in range(B):
        ln = int(lengths[b])
        scores = dict(_paths_scores(emission[b].astype(np.float64),
                                    transition.astype(np.float64), ln))
        log_z = np.log(sum(np.exp(s) for s in scores.values()))
        want = log_z - scores[tuple(labels[b, :ln])]
        assert abs(nll[b] - want) <= TOL_ENUM * max(1.0, abs(want))
        assert abs(jnll[b] - want) <= TOL_ENUM * max(1.0, abs(want))
        best = max(scores.items(), key=lambda kv: kv[1])[0]
        assert tuple(path[b, :ln]) == best
        assert (path[b, ln:] == 0).all()

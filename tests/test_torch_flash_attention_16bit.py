"""The port's flash attention on bfloat16 and float16 q/k/v
(paddle_tpu_torch/ops/kernels/flash_attention.py: ``_plain_forward``,
``_plain_backward`` and the split pair ``_plain_backward_dkv`` /
``_plain_backward_dq``) against the reference's Pallas kernels in
interpret mode (``_fa_forward_sliced``, ``_fa_backward_pallas`` fused and
split), on the same seeded inputs; and the float32 plain versions
bitwise against the float32 expressions they had before the 16-bit
roundings.

On the CPU the port's wrappers take their plain versions, so this pins
the functions the card's 16-bit kernels are held to (chip_smoke.py).
Both sides round where the reference's kernels round: q times the scale
in the storage type, p before p.v, p and ds before dv, dk and dq.

Bounds, read on the CPU at these cases (16-key reference tiles):
- o within one 16-bit ulp of its largest value (read: at most one).
- lse within 1e-5 at D = 128 (read up to 7.2e-7).  Elsewhere the
  reference sums its rounded p through a ones column (the D % 128 != 0
  lane device), each p rounded at its tile's running max, where the port
  sums the float32 p: bfloat16 within 2e-3 (read up to 1.17e-3), float16
  within 2.5e-4 (read up to 1.5e-4).
- dq, dk, dv within one 16-bit ulp of the largest value (read up to half
  of one: 2.1e-3 of the largest value in bfloat16, 2.6e-4 in float16),
  with at least 97% of the elements bitwise equal (read from 98.2%).
  Both sides round the same float32 p and ds and the same float32 sums,
  whose last bits differ where the two accumulate in other orders: a
  flipped rounding moves a term or an output by one 16-bit ulp.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

jfa = importlib.import_module('paddle_tpu.ops.pallas.flash_attention')

DTYPES = {'bfloat16': (torch.bfloat16, jnp.bfloat16, 2.0 ** -7),
          'float16': (torch.float16, jnp.float16, 2.0 ** -10)}
TOL_LSE = {'bfloat16': 2e-3, 'float16': 2.5e-4}
TOL_LSE_D128 = 1e-5
MIN_EQUAL_SHARE = 0.97
BLOCK = 16

CASES = [
    # name, d, tq, tk, causal, q_offset, k_offset, with a dlse
    ('causal_d32', 32, 40, 40, True, 0, 0, False),
    ('noncausal_ragged_dlse_d50', 50, 37, 45, False, 0, 0, True),
    ('masked_rows_dlse_d128', 128, 24, 24, True, 0, 8, True),
    ('offsets_d64', 64, 16, 32, True, 16, 0, False),
    ('causal_ragged_d128', 128, 40, 40, True, 0, 0, False),
]
PARAMS = [(c, dt) for c in CASES for dt in DTYPES]
IDS = ['%s-%s' % (c[0], dt) for c, dt in PARAMS]


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    """The reference's (o, lse), fused and split (dq, dk, dv) in interpret
    mode, and the port's arguments, on the same seeded inputs."""
    name, d, tq, tk, causal, qo, ko, with_dlse = case
    tdtype, jdtype, _ = DTYPES[dtype]
    rng = np.random.default_rng(len(name) + d)
    q, do = (jnp.asarray(rng.standard_normal((2, tq, d)), jdtype)
             for _ in range(2))
    k, v = (jnp.asarray(rng.standard_normal((2, tk, d)), jdtype)
            for _ in range(2))
    dlse = rng.standard_normal((2, tq)).astype(np.float32)
    scale = d ** -0.5
    o, lse = jfa._fa_forward_sliced(q, k, v, causal, scale, BLOCK, BLOCK,
                                    True, jnp.int32(qo), jnp.int32(ko))
    res = (q, k, v, jnp.int32(qo), jnp.int32(ko), o, lse)
    grads = {}
    for route, fused in (('fused', True), ('split', False)):
        grads[route] = [np.asarray(g, np.float32) for g in
                        jfa._fa_backward_pallas(
                            causal, scale, ((BLOCK, BLOCK),) * 2, res, do,
                            jnp.asarray(dlse) if with_dlse else None,
                            interpret=True, allow_fused=fused)]
    f32 = [np.asarray(x, np.float32) for x in (q, k, v, do, o)]
    di = (f32[3] * f32[4]).sum(-1) - (dlse if with_dlse else 0.0)
    qt, kt, vt, dot = (torch.from_numpy(x).to(tdtype)
                       for x in f32[:4])
    args = [qt, kt, vt, torch.from_numpy(np.array(lse)), dot,
            torch.from_numpy(di.astype(np.float32)), causal, scale, qo, ko]
    return f32[4], np.array(lse), grads, args


def _ulp_of_largest(x, dtype):
    return 2.0 ** np.floor(np.log2(np.abs(x).max())) * DTYPES[dtype][2]


def _grads_close(got, want, dtype):
    for g, w, name in zip(got, want, ('dq', 'dk', 'dv')):
        assert g.dtype == DTYPES[dtype][0], name
        g = g.float().numpy()
        assert g.shape == w.shape and np.all(np.isfinite(g)), name
        gap = np.max(np.abs(g - w))
        share = np.mean(g == w)
        assert gap <= _ulp_of_largest(w, dtype), (name, gap)
        assert share >= MIN_EQUAL_SHARE, (name, share)


@pytest.mark.parametrize('case,dtype', PARAMS, ids=IDS)
def test_forward_matches_pallas_interpret(case, dtype):
    want_o, want_lse, _, args = _reference(case, dtype)
    q, k, v, causal, scale, qo, ko = args[:3] + args[6:]
    o, lse = tfa._fa_forward(q, k, v, causal, scale, qo, ko)
    assert o.dtype == DTYPES[dtype][0] and lse.dtype == torch.float32
    assert np.max(np.abs(o.float().numpy() - want_o)) <= _ulp_of_largest(
        want_o, dtype)
    tol = TOL_LSE_D128 if case[1] == 128 else TOL_LSE[dtype]
    assert np.max(np.abs(lse.numpy() - want_lse)) <= tol
    if ko > qo:
        # rows before the first key: o = 0, lse = -1e30 on both
        assert np.all(o[:, :ko - qo].float().numpy() == 0.0)
        assert np.all(want_lse[:, :ko - qo] == lse[:, :ko - qo].numpy())


@pytest.mark.parametrize('case,dtype', PARAMS, ids=IDS)
def test_fused_backward_matches_pallas_interpret(case, dtype):
    _, _, grads, args = _reference(case, dtype)
    _grads_close(tfa._fa_backward_fused(*args), grads['fused'], dtype)


@pytest.mark.parametrize('case,dtype', PARAMS, ids=IDS)
def test_split_pair_matches_pallas_interpret(case, dtype):
    _, _, grads, args = _reference(case, dtype)
    dk, dv = tfa._fa_backward_dkv(*args)
    _grads_close((tfa._fa_backward_dq(*args), dk, dv), grads['split'],
                 dtype)


# the float32 plain versions as they stood before the 16-bit roundings

def _old_forward(q, k, v, causal, scale, q_offset, k_offset):
    s = torch.einsum('btd,bsd->bts', q.float() * scale, k.float())
    valid = None
    if causal:
        tq, tk = s.shape[1], s.shape[2]
        valid = ((q_offset + torch.arange(tq))[:, None]
                 >= (k_offset + torch.arange(tk))[None, :])
        s = s.masked_fill(~valid, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum('bts,bsd->btd', p, v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _old_backward(q, k, v, lse, do, di, causal, scale, q_offset,
                  k_offset):
    qf = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    s = torch.einsum('btd,bsd->bts', qf, kf)
    p = torch.exp(s - lse[..., None])
    if causal:
        tq, tk = s.shape[1], s.shape[2]
        valid = ((q_offset + torch.arange(tq))[:, None]
                 >= (k_offset + torch.arange(tk))[None, :])
        p = torch.where(valid, p, torch.zeros_like(p))
    dp = torch.einsum('btd,bsd->bts', dof, vf)
    ds = p * (dp - di[..., None])
    dv = torch.einsum('bts,btd->bsd', p, dof)
    dq = torch.einsum('bts,bsd->btd', ds, kf) * scale
    dk = torch.einsum('bts,btd->bsd', ds, qf)
    return dq, dk, dv


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_float32_plain_versions_are_bitwise_unchanged(case):
    """Every 16-bit rounding is the identity on float32 inputs."""
    name, d, tq, tk, causal, qo, ko, _ = case
    rng = np.random.default_rng(d + tq)
    q, do = (torch.from_numpy(rng.standard_normal((2, tq, d))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, tk, d))
                             .astype(np.float32)) for _ in range(2))
    scale = d ** -0.5
    o, lse = tfa._plain_forward(q, k, v, causal, scale, qo, ko)
    old_o, old_lse = _old_forward(q, k, v, causal, scale, qo, ko)
    assert torch.equal(o, old_o) and torch.equal(lse, old_lse)
    di = torch.from_numpy(rng.standard_normal((2, tq)).astype(np.float32))
    args = (q, k, v, lse, do, di, causal, scale, qo, ko)
    old = _old_backward(*args)
    for got, want in zip(tfa._plain_backward(*args), old):
        assert torch.equal(got, want)
    dk, dv = tfa._plain_backward_dkv(*args)
    assert torch.equal(dk, old[1]) and torch.equal(dv, old[2])
    assert torch.equal(tfa._plain_backward_dq(*args), old[0])

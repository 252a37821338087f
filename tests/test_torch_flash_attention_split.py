"""The port's split flash-attention backward (paddle_tpu_torch/ops/kernels/
flash_attention.py ``_plain_backward_dkv`` / ``_plain_backward_dq``, and
``_fa_backward`` with the fused kernel's cap lowered to 0) against the reference's split Pallas
pair (``_fa_bwd_dkv_kernel``, ``_fa_bwd_dq_kernel``) run in interpret mode
with mixed tiles, as tests/test_pallas_flash_attention.py runs it; the
route between the fused backward and the split pair against the
reference's size rule; and the 128K-context transformer program against
the reference's.

On the CPU the port's wrappers take their plain versions, so this pins
the functions the CUDA kernels are held to on the card (chip_smoke.py).
Tolerance: 1e-5 absolute on dq, dk, dv (the reference's own split test
allows rtol 1e-4 on top); bfloat16 outputs one bfloat16 ulp of the
largest value.  Both sides accumulate in float32 in different
orders (the reference walks 32- and 64-row tiles of a padded copy); the
gradients here are O(1) to O(4), where that reordering costs a few
float32 ulps.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

jfa = importlib.import_module('paddle_tpu.ops.pallas.flash_attention')

TOL = 1e-5
BH, T, D = 3, 160, 32            # T a multiple of no tile
TILES = ((64, 32), (32, 64))     # (dkv, dq) tiles, as the reference test

CASES = [
    # causal, q_offset, k_offset, with a dlse cotangent
    (False, 0, 0, False),
    (True, 0, 0, False),
    (True, 0, 0, True),
    (True, 64, 0, True),    # ring: this q block lies past the k block
    (True, 0, 64, False),   # k lies past q: rows and keys fully masked
]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BH, T, D)).astype(np.float32)
            for _ in range(4)] + [rng.standard_normal((BH, T))
                                  .astype(np.float32)]


def _reference(causal, qo, ko, with_dlse, seed):
    """The reference's forward (o, lse) and split backward on the same
    numpy inputs."""
    q, k, v, do, dlse = _inputs(seed)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o, lse = jfa._fa_forward_sliced(jq, jk, jv, causal, scale, 64, 64, True,
                                    jnp.int32(qo), jnp.int32(ko))
    res = (jq, jk, jv, jnp.int32(qo), jnp.int32(ko), o, lse)
    grads = jfa._fa_backward_pallas(
        causal, scale, TILES, res, jnp.asarray(do),
        jnp.asarray(dlse) if with_dlse else None, interpret=True,
        allow_fused=False)
    o, lse = np.asarray(o), np.asarray(lse)
    di = (do * o).sum(-1) - (dlse if with_dlse else 0.0)
    port_args = [torch.from_numpy(np.array(x))
                 for x in (q, k, v, lse, do, di.astype(np.float32))]
    return port_args + [causal, scale, qo, ko], [np.asarray(g)
                                                 for g in grads]


def _close(got, want, names):
    for g, w, name in zip(got, want, names):
        g = g.numpy()
        assert g.shape == w.shape, name
        assert np.all(np.isfinite(g)), name
        assert np.max(np.abs(g - w)) <= TOL, (name, np.max(np.abs(g - w)))


@pytest.mark.parametrize('causal,qo,ko,with_dlse', CASES)
def test_split_plain_versions_match_reference_split_kernels(
        causal, qo, ko, with_dlse, monkeypatch):
    args, (dq, dk, dv) = _reference(causal, qo, ko, with_dlse,
                                    7 + qo + 3 * ko + with_dlse)
    _close(tfa._plain_backward_dkv(*args), (dk, dv), ('dk', 'dv'))
    _close([tfa._plain_backward_dq(*args)], (dq,), ('dq',))
    monkeypatch.setattr(tfa, '_FUSED_DQ_BYTES', 0)   # route: split pair
    _close(tfa._fa_backward(*args), (dq, dk, dv), ('dq', 'dk', 'dv'))
    if ko > qo and causal:
        # queries before the first key, and keys after the last query,
        # take no gradient: zeros, not NaN or stale memory
        got_dq, got_dk, got_dv = tfa._fa_backward(*args)
        dead_q = ko - qo
        dead_k = T - (ko - qo)
        assert np.all(got_dq[:, :dead_q].numpy() == 0.0)
        assert np.all(got_dk[:, dead_k:].numpy() == 0.0)
        assert np.all(got_dv[:, dead_k:].numpy() == 0.0)


# The cases the card's dk/dv kernel treats apart (csrc/flash_bwd_dkv.cuh):
# its head-dim tiers 32 and 128 beside 64, a length that is no multiple of
# its 64-row tiles, offsets that mask whole 64-row tiles (queries 0-127
# see no key; keys 32 on are seen by no query), and bfloat16 inputs.
EDGE_CASES = [
    # name, bh, t, d, dtype, causal, q_offset, k_offset, with a dlse
    ('d128', 2, 160, 128, np.float32, True, 0, 0, True),
    ('ragged_T100', 2, 100, 64, np.float32, True, 0, 0, False),
    ('masked_tiles_d32', 2, 160, 32, np.float32, True, 0, 128, False),
    ('bf16', 2, 128, 64, jnp.bfloat16, True, 0, 0, False),
]
# bfloat16 outputs: both sides round float32 sums taken in other orders to
# bfloat16, which may land one bfloat16 ulp apart (2^-7 of the largest
# value)
TOL_BF16_REL = 2.0 ** -7


@pytest.mark.parametrize('name,bh,t,d,dtype,causal,qo,ko,with_dlse',
                         EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_split_dkv_plain_version_at_the_kernels_edge_cases(
        name, bh, t, d, dtype, causal, qo, ko, with_dlse):
    rng = np.random.default_rng(len(name) + d)
    q, k, v, do = (jnp.asarray(rng.standard_normal((bh, t, d))
                               .astype(np.float32), dtype) for _ in range(4))
    dlse = rng.standard_normal((bh, t)).astype(np.float32)
    scale = d ** -0.5
    o, lse = jfa._fa_forward_sliced(q, k, v, causal, scale, 64, 64, True,
                                    jnp.int32(qo), jnp.int32(ko))
    res = (q, k, v, jnp.int32(qo), jnp.int32(ko), o, lse)
    _, dk, dv = jfa._fa_backward_pallas(
        causal, scale, TILES, res, do,
        jnp.asarray(dlse) if with_dlse else None, interpret=True,
        allow_fused=False)
    f32 = [np.array(x, np.float32) for x in (q, k, v, do, o)]
    di = (f32[3] * f32[4]).sum(-1) - (dlse if with_dlse else 0.0)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    args = [torch.from_numpy(x).to(tdtype) for x in f32[:3]] + [
        torch.from_numpy(np.array(lse)), torch.from_numpy(f32[3]).to(tdtype),
        torch.from_numpy(di.astype(np.float32))]
    got = tfa._plain_backward_dkv(*args, causal, scale, qo, ko)
    for g, w, grad in zip(got, (dk, dv), ('dk', 'dv')):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, grad
        assert np.all(np.isfinite(g)), grad
        tol = (TOL_BF16_REL * np.abs(w).max() if dtype == jnp.bfloat16
               else TOL)
        assert np.max(np.abs(g - w)) <= tol, (grad, np.max(np.abs(g - w)))
    if ko >= 128:
        # dead tiles take no gradient: zeros, not NaN or stale memory
        assert np.all(got[0][:, t - (ko - qo):].numpy() == 0.0)
        assert np.all(got[1][:, t - (ko - qo):].numpy() == 0.0)


def test_plain_backward_is_the_split_pair_bitwise():
    args, _ = _reference(True, 0, 0, True, 3)
    fused = tfa._plain_backward(*args)
    dk, dv = tfa._plain_backward_dkv(*args)
    dq = tfa._plain_backward_dq(*args)
    for a, b in zip(fused, (dq, dk, dv)):
        assert torch.equal(a, b)


def _reference_split(t, d):
    """The reference's rule (flash_attention.py :612-613): its default
    backward tiles (attention_with_lse :813-815), the padding both split
    kernels share (``_shared_padding``), then the fused kernel's dq
    accumulator against ``_FUSED_DQ_BYTES``."""
    tiles = (((2048, 2048), (1024, 2048), (1024, 1024)) if d <= 64
             else ((512, 512),) * 3)
    tq_p = jfa._shared_padding(t, t, tiles[1:])[2]
    return tq_p * d * 4 > jfa._FUSED_DQ_BYTES


ROUTE_CASES = (
    [(d, t) for d in (32, 48, 64, 96, 128)
     for t in (1, 100, 511, 512, 513, 1023, 1024, 1025, 4096, 32768)]
    + [(64, 65536), (64, 65537), (128, 32768), (128, 32769),
       (96, 43520), (96, 43521), (48, 87040), (48, 87041),
       (32, 131072), (32, 131073), (64, 131072)])


@pytest.mark.parametrize('d,t', ROUTE_CASES)
def test_route_follows_the_reference_rule(d, t):
    assert tfa._FUSED_DQ_BYTES == jfa._FUSED_DQ_BYTES
    assert tfa._split_backward(t, d) == _reference_split(t, d)


def test_autograd_takes_the_route_the_rule_picks(monkeypatch):
    """The attention's backward asks the size rule: with the cap lowered
    to 0 the split pair runs, with it as shipped the fused backward."""
    calls = []
    for name in ('_plain_backward', '_plain_backward_dkv',
                 '_plain_backward_dq'):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    q, k, v, do, _ = _inputs(11)
    q, k, v, do = (torch.from_numpy(x[None]).transpose(1, 2)
                   .requires_grad_(True) for x in (q, k, v, do))
    for cap, want in ((tfa._FUSED_DQ_BYTES, ['_plain_backward']),
                      (0, ['_plain_backward_dkv', '_plain_backward_dq'])):
        monkeypatch.setattr(tfa, '_FUSED_DQ_BYTES', cap)
        del calls[:]
        o, _ = tfa.attention_with_lse(q, k, v, causal=True)
        torch.autograd.grad(o, (q, k, v), do.detach())
        assert calls == want


def test_cpu_split_counts_no_launch(monkeypatch):
    monkeypatch.setattr(tfa, '_FUSED_DQ_BYTES', 0)
    before = (tfa.dkv_launches, tfa.dq_launches, tfa.bwd_launches)
    args, _ = _reference(True, 0, 0, False, 5)
    tfa._fa_backward(*args)
    tfa._fa_backward_fused(*args)
    tfa._fa_backward_dkv(*args)
    tfa._fa_backward_dq(*args)
    q = args[0][None].transpose(1, 2).requires_grad_(True)
    o, _ = tfa.attention_with_lse(q, q.detach(), q.detach(), causal=True)
    o.sum().backward()
    assert (tfa.dkv_launches, tfa.dq_launches, tfa.bwd_launches) == before


def test_split_wrappers_reject_mismatched_inputs():
    x = torch.zeros((2, 8, 4))
    lse = torch.zeros((2, 8))
    for fn in (tfa._fa_backward_dkv, tfa._fa_backward_dq,
               tfa._fa_backward_fused):
        with pytest.raises(ValueError):
            fn(x, x, x, lse, x[:, :4].contiguous(), lse, True, 1.0)
        with pytest.raises(ValueError):
            fn(x, x, x, lse.double(), x, lse, True, 1.0)
        with pytest.raises(ValueError):
            m = x.to('meta')
            fn(m, m, m, lse.to('meta'), m, lse.to('meta'), True, 1.0)


LONG = dict(vocab_size=30000, seq_len=131072, n_layers=6, d_model=512,
            n_heads=8)


def _build_long(pkg, prog_mod, tr_mod):
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            _, _, cost = tr_mod.build(**LONG)
            pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(cost)
    return main, startup


def test_long_context_program_serialises_to_the_reference_program():
    """chip_smoke.py's 128K-context training config: built, not run."""
    jm, js = _build_long(fluid, jprog, jtr)
    tm, ts = _build_long(tfl, tprog, ttr)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()

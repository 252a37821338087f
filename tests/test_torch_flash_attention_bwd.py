"""The port's flash-attention backward (paddle_tpu_torch/ops/kernels/
flash_attention.py ``_plain_backward`` behind the ``_FlashAttention``
autograd function) against the reference's fused Pallas backward
(``_fa_bwd_fused_kernel``) run in interpret mode, as
tests/test_pallas_flash_attention.py runs it, and against autograd of the
port's plain forward.

On the CPU the port's wrapper takes its plain version, so this pins the
function the CUDA kernel is held to on the card (chip_smoke.py).
Tolerance: 1e-5 absolute on dq, dk, dv.  Both sides accumulate in
float32 in different orders (the reference walks padded 16-row tiles);
the gradients here are O(1) to O(4), where that reordering costs a few
float32 ulps (under 1e-6 at these seeds).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

jfa = importlib.import_module('paddle_tpu.ops.pallas.flash_attention')

TOL = 1e-5


def _inputs(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    do = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    dlse = rng.standard_normal((b, h, tq)).astype(np.float32)
    return q, k, v, do, dlse


def _port_grads(q, k, v, do, dlse, causal, q_offset, k_offset):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o, lse = tfa.attention_with_lse(qt, kt, vt, causal=causal,
                                    q_offset=q_offset, k_offset=k_offset)
    outs, cts = [o], [torch.from_numpy(do)]
    if dlse is not None:
        outs.append(lse)
        cts.append(torch.from_numpy(dlse))
    return [g.numpy() for g in torch.autograd.grad(outs, (qt, kt, vt), cts)]


def _close(got, want):
    for g, w, name in zip(got, want, ('dq', 'dk', 'dv')):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.all(np.isfinite(g)), name
        assert np.max(np.abs(g - w)) <= TOL, (name, np.max(np.abs(g - w)))


CASES = [
    # causal, tq, tk, q_offset, k_offset, with a dlse cotangent
    (True, 32, 32, 0, 0, False),     # several causal tiles, dead tiles
    (False, 32, 32, 0, 0, False),
    (True, 40, 40, 0, 0, True),      # ragged T, dlse != 0
    (False, 20, 45, 0, 0, True),     # Tq != Tk, ragged
    (True, 16, 32, 16, 0, False),    # q offset: Tq 16 over Tk 32
    (True, 24, 24, 0, 8, True),      # k offset: fully masked rows
]


@pytest.mark.parametrize('causal,tq,tk,qo,ko,with_dlse', CASES)
def test_backward_matches_fused_pallas_interpret(causal, tq, tk, qo, ko,
                                                 with_dlse, monkeypatch):
    q, k, v, do, dlse = _inputs(3 + tq + tk + qo + ko, 1, tq, tk, 2, 16)
    dlse = dlse if with_dlse else None
    # the reference picks its fused Pallas backward off the TPU only
    # under this switch (read when attention_with_lse is called)
    monkeypatch.setenv('PADDLE_TPU_FLASH_BWD_PALLAS', '1')
    jax.clear_caches()

    def f(q_, k_, v_):
        return jfa.attention_with_lse(q_, k_, v_, causal=causal,
                                      block_q=16, block_k=16, q_offset=qo,
                                      k_offset=ko, interpret=True)

    (jo, jlse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v))
    want = vjp((jnp.asarray(do),
                jnp.asarray(dlse) if dlse is not None
                else jnp.zeros_like(jlse)))
    jax.clear_caches()
    _close(_port_grads(q, k, v, do, dlse, causal, qo, ko), want)


@pytest.mark.parametrize('causal,tq,tk,qo,ko,with_dlse', CASES)
def test_plain_backward_matches_autograd_of_plain_forward(causal, tq, tk,
                                                          qo, ko,
                                                          with_dlse):
    q, k, v, do, dlse = _inputs(5 + tq, 2, tq, tk, 1, 8)
    bh = lambda x: torch.from_numpy(x[:, :, 0]).contiguous()  # noqa: E731
    qt, kt, vt, dot = (bh(x) for x in (q, k, v, do))
    dl = torch.from_numpy(dlse[:, 0]) if with_dlse else None
    scale = 8 ** -0.5
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    o, lse = tfa._plain_forward(*leaves, causal, scale, qo, ko)
    outs, cts = [o], [dot]
    if dl is not None:
        outs.append(lse)
        cts.append(dl)
    want = torch.autograd.grad(outs, leaves, cts)
    o, lse = tfa._plain_forward(qt, kt, vt, causal, scale, qo, ko)
    di = (dot * o).sum(-1) - (dl if dl is not None else 0.0)
    got = tfa._plain_backward(qt, kt, vt, lse, dot, di.contiguous(), causal,
                              scale, qo, ko)
    _close([g.numpy() for g in got], [w.numpy() for w in want])


def test_fully_masked_rows_have_zero_gradient_and_no_nan():
    """k offset past every query of the first rows: lse = -1e30 there,
    and the select keeps exp(s - lse) = inf out of the gradients."""
    q, k, v, do, dlse = _inputs(9, 1, 16, 16, 1, 8)
    dq, dk, dv = _port_grads(q, k, v, do, dlse, True, 0, 8)
    assert np.all(np.isfinite(dq)) and np.all(np.isfinite(dk)) and \
        np.all(np.isfinite(dv))
    assert np.all(dq[0, :8] == 0.0)


def test_cpu_runs_plain_versions_and_counts_no_launch():
    q, k, v, do, _ = _inputs(11, 1, 16, 16, 2, 8)
    _port_grads(q, k, v, do, None, True, 0, 0)
    assert tfa.launches == 0 and tfa.bwd_launches == 0


def test_backward_wrapper_rejects_mismatched_inputs():
    x = torch.zeros((2, 8, 4))
    lse = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        tfa._fa_backward(x, x, x, lse, x[:, :4].contiguous(), lse, True,
                         1.0)
    with pytest.raises(ValueError):
        tfa._fa_backward(x, x, x, lse.double(), x, lse, True, 1.0)
    with pytest.raises(ValueError):
        m = x.to('meta')
        tfa._fa_backward(m, m, m, lse.to('meta'), m, lse.to('meta'), True,
                         1.0)

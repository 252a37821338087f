"""The port's flash-attention forward (paddle_tpu_torch/ops/kernels/
flash_attention.py) against the reference's Pallas kernel run in
interpret mode, as tests/test_pallas_flash_attention.py runs it.

On the CPU the port's wrapper takes its plain version, so this pins the
function the CUDA kernel is held to on the card (chip_smoke.py).
Tolerance: 1e-5 absolute on o and lse.  Both sides fold the scale into
q and accumulate in float32, in different orders; at these sizes o and
lse are O(1) to O(10), so reassociation costs a few float32 ulps.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

# the package re-exports the function under the module's name
jfa = importlib.import_module('paddle_tpu.ops.pallas.flash_attention')

TOL = 1e-5


def _inputs(seed, shape_q, shape_k):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal(shape_k).astype(np.float32)
    v = rng.standard_normal(shape_k).astype(np.float32)
    return q, k, v


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == np.shape(want)
    assert np.max(np.abs(got - np.asarray(want))) <= TOL


@pytest.mark.parametrize('causal,tq,tk,block', [
    (True, 32, 32, 16),      # several causal tiles, dead-tile skip
    (False, 32, 32, 16),
    (True, 37, 37, 16),      # ragged T: the last tile is partial
    (False, 20, 45, 16),     # Tq != Tk, ragged
])
def test_attention_with_lse_matches_pallas_interpret(causal, tq, tk,
                                                     block):
    q, k, v = _inputs(1 + tq + tk, (2, tq, 3, 16), (2, tk, 3, 16))
    jo, jlse = jfa.attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block, block_k=block, interpret=True)
    to, tlse = tfa.attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    _close(to, jo)     # [B, T, H, D]
    _close(tlse, jlse)  # [B, H, T]


@pytest.mark.parametrize('q_offset,k_offset', [(16, 0), (0, 8), (5, 21)])
def test_offsets_match_pallas_interpret(q_offset, k_offset):
    """Global positions for the causal mask, rows that every key masks
    included (q_offset < k_offset): o = 0 and lse = -1e30 on both."""
    q, k, v = _inputs(7 + q_offset, (1, 24, 2, 8), (1, 32, 2, 8))
    jo, jlse = jfa.attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=8, block_k=8, q_offset=q_offset, k_offset=k_offset,
        interpret=True)
    to, tlse = tfa.attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_offset=q_offset, k_offset=k_offset)
    _close(to, jo)
    _close(tlse, jlse)


def test_three_d_input_is_one_head():
    q, k, v = _inputs(3, (4, 19, 16), (4, 19, 16))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, block_q=8,
                               block_k=8, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    _close(got, want)


def test_bf16_inputs_give_bf16_output_float32_lse():
    """bf16 q/k/v give bf16 o and float32 lse: the expressions of the
    reference's kernels (q times the scale in bf16, the scale rounded to
    bf16 first; p rounded to bf16 before p.v; l summing the float32 p),
    bitwise, and the reference's Pallas forward in interpret mode within
    one bf16 ulp of the largest |o| on o and 2e-3 on lse (its ones-column
    l-sum adds the rounded p, each rounded at its tile's running max:
    tests/test_torch_flash_attention_16bit.py)."""
    q, k, v = _inputs(5, (2, 16, 8), (2, 16, 8))
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    scale = 8 ** -0.5
    o, lse = tfa._fa_forward(qt, kt, vt, True, scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    qs = (qt * torch.tensor(scale, dtype=torch.bfloat16)).float()
    s = torch.einsum('btd,bsd->bts', qs, kt.float())
    valid = torch.ones(16, 16, dtype=torch.bool).tril()
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    l = p.sum(-1, keepdim=True)
    want_o = torch.einsum('bts,bsd->btd', p.to(torch.bfloat16).float(),
                          vt.float()) / l
    assert torch.equal(o, want_o.to(torch.bfloat16))
    assert torch.equal(lse, (m + torch.log(l))[..., 0])
    jo, jlse = jfa._fa_forward_sliced(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), True, scale, 8,
        8, True)
    jo = np.asarray(jo, np.float32)
    ulp = 2.0 ** np.floor(np.log2(np.abs(jo).max())) * 2.0 ** -7
    assert np.max(np.abs(o.float().numpy() - jo)) <= ulp
    assert np.max(np.abs(lse.numpy() - np.asarray(jlse))) <= 2e-3


def test_cpu_runs_plain_version_and_counts_no_launch():
    before = tfa.launches
    q, k, v = (torch.from_numpy(x) for x in _inputs(9, (2, 8, 4),
                                                    (2, 8, 4)))
    tfa._fa_forward(q, k, v, True, 0.5)
    tfa.flash_attention(q, k, v, causal=False)
    assert tfa.launches == before == 0


@pytest.mark.parametrize('bad,err', [
    (lambda q: q.double(), TypeError),                  # dtype
    (lambda q: q.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),                                       # not contiguous
    (lambda q: q[..., :0], ValueError),                 # D = 0
    (lambda q: q[:, :0], ValueError),                   # T = 0
    (lambda q: q[None], ValueError),                    # 4-D
    (lambda q: q.to('meta'), ValueError),               # device mismatch
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    q, k, v = (torch.from_numpy(x) for x in _inputs(11, (2, 8, 4),
                                                    (2, 8, 4)))
    with pytest.raises(err):
        tfa._fa_forward(bad(q), k, v, True, 0.5)


def test_head_dim_above_kernel_limit_raises():
    x = torch.zeros((1, 4, tfa.MAX_HEAD_DIM + 1))
    with pytest.raises(ValueError):
        tfa._fa_forward(x, x, x, False, 1.0)


def test_non_cpu_non_cuda_device_raises():
    x = torch.zeros((1, 4, 8), device='meta')
    with pytest.raises(ValueError):
        tfa._fa_forward(x, x, x, False, 1.0)

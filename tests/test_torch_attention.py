"""The port's attention ops (paddle_tpu_torch/ops/attention.py) against
paddle_tpu/ops/attention.py on the same numpy inputs.

Tolerance: 1e-6 absolute.  Both sides gather the same pages and
softmax in float32 over O(1) scores; only the summation order of the
einsums differs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import attention as jatt
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 1e-6


def _pools(rng, n, p, h, d):
    k = rng.standard_normal((n + 1, p, h, d)).astype(np.float32)
    v = rng.standard_normal((n + 1, p, h, d)).astype(np.float32)
    return k, v


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL


def test_paged_attention_matches_reference():
    """Shuffled page tables, trash entries (id n) and ids past the pool
    (clipped), ragged context lengths."""
    rng = np.random.default_rng(11)
    s, h, d, p, n, mpp = 3, 2, 8, 4, 16, 4
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k_pool, v_pool = _pools(rng, n, p, h, d)
    pt = np.asarray([[7, 2, 9, 16], [0, 5, 16, 16], [3, 1, 4, 40]],
                    np.int32)
    ctx = np.asarray([13, 6, 16], np.int32)
    want = jatt.paged_attention_math(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt), jnp.asarray(ctx))
    got = tatt.paged_attention_math(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(pt.astype(np.int64)),
        torch.from_numpy(ctx.astype(np.int64)))
    _close(got, want)


@pytest.mark.parametrize('pos0,c', [(0, 8), (8, 8), (12, 5)])
def test_chunked_prefill_attention_matches_reference(pos0, c):
    rng = np.random.default_rng(13 + pos0)
    h, d, p, n, mpp = 2, 8, 4, 10, 6
    q = rng.standard_normal((c, h, d)).astype(np.float32)
    k_pool, v_pool = _pools(rng, n, p, h, d)
    pt = np.asarray([4, 9, 0, 7, 10, 10], np.int32)
    want = jatt.chunked_prefill_attention_math(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt), jnp.int32(pos0))
    got = tatt.chunked_prefill_attention_math(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(pt.astype(np.int64)),
        pos0)
    _close(got, want)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape', [(2, 9, 3, 8), (2, 9, 8)])
def test_dense_and_flash_op_match_reference(causal, shape):
    """The op body on CPU tensors runs ``_dense_attention``, as the
    reference's op does off the accelerator; no kernel launches."""
    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    want = jatt._dense_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, None)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _close(tatt._dense_attention(tq, tk, tv, causal, None), want)
    before = tfa.launches
    _close(tatt.flash_attention(tq, tk, tv, causal=causal), want)
    assert tfa.launches == before

"""Attention ops of the decode and training paths.

Reference parity: paddle_tpu/ops/attention.py.  ``flash_attention`` is
the body of the ``flash_attention`` op, through ops/kernels/
flash_attention.py: CUDA tensors run the hand-written forward and
backward kernels, CPU tensors their plain versions (``_plain_forward`` /
``_plain_backward``), so a CPU run computes exactly what the kernels are
held to.  ``_dense_attention`` is the reference op's off-accelerator
math; here it serves build-time shape inference on meta tensors.  The
paged and chunked-prefill attention (the ``paged_attention`` and
``chunked_prefill_attention`` ops, which the decode engine reaches
through the registry as the reference's does) are plain PyTorch, because
the reference computes them outside any Pallas kernel.
"""
import torch

from ..core.registry import register_op
from .common import first, out
from .kernels import flash_attention as _fa

__all__ = ['flash_attention', 'paged_attention_math',
           'chunked_prefill_attention_math']

_NEG_INF = -1e30


def _dense_attention(q, k, v, causal, scale):
    """[B, T, H, D] (or [B, T, D]) attention in float32, materializing
    the [Tq, Tk] scores."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = (x[:, :, None, :] for x in (q, k, v))
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[2], s.shape[3]
        mask = (torch.arange(tq, device=s.device)[:, None]
                >= torch.arange(tk, device=s.device)[None, :])
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return o[:, :, 0, :] if squeeze else o


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention over [B, T, H, D] (or [B, T, D]) tensors,
    dispatched by the tensors' device: CUDA launches the kernels, the CPU
    runs their plain versions.  The result has q's dtype; it is
    differentiable either way."""
    if q.device.type == 'meta':
        y = _dense_attention(q, k, v, causal, scale)
    else:
        y = _fa.flash_attention(q, k, v, causal=causal, scale=scale)
    return y.to(q.dtype)


def paged_attention_math(q, k_pool, v_pool, page_table, ctx_len,
                         scale=None):
    """Decode-step attention against a paged KV cache.

    ``q`` [S, H, D], one new token per stream slot; ``k_pool``/``v_pool``
    [N, P, H, D] page pools; ``page_table`` [S, MPP] integer page ids per
    stream (unused entries may point anywhere, typically the trash page:
    their keys are masked); ``ctx_len`` [S] valid key count per stream,
    current token included.  Returns [S, H, D].  Masks positions >=
    ctx_len to -1e30 and softmaxes in float32, as ``_dense_attention``.
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    n, p = k_pool.shape[0], k_pool.shape[1]
    s, h, d = q.shape
    mpp = page_table.shape[1]
    idx = page_table.long().clamp(0, n - 1)
    k = k_pool[idx].reshape(s, mpp * p, h, d)   # [S, T, H, D]
    v = v_pool[idx].reshape(s, mpp * p, h, d)
    scores = torch.einsum('shd,sthd->sht', q.float(), k.float()) * scale
    valid = (torch.arange(mpp * p, device=q.device)[None, :]
             < ctx_len.long()[:, None])              # [S, T]
    scores = scores.masked_fill(~valid[:, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum('sht,sthd->shd', probs, v.float())
    return o.to(q.dtype)


def chunked_prefill_attention_math(q, k_pool, v_pool, page_table, pos0,
                                   scale=None):
    """Chunked-prefill attention for one stream against its page table.

    ``q`` [C, H, D]: query ``i`` sits at absolute position ``pos0 + i``;
    ``k_pool``/``v_pool`` [N, P, H, D]; ``page_table`` [MPP] page ids
    (entries past the claimed span may point anywhere: they are causally
    masked); ``pos0`` an int or a 0-d integer tensor.  Returns [C, H, D].
    The key at absolute position ``j`` is valid for query ``i`` iff
    ``j <= pos0 + i``.
    float32 scores and softmax, the accumulation order of
    ``paged_attention_math``.
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    n, p = k_pool.shape[0], k_pool.shape[1]
    c, h, d = q.shape
    mpp = page_table.shape[0]
    idx = page_table.long().clamp(0, n - 1)
    k = k_pool[idx].reshape(mpp * p, h, d)      # [T, H, D]
    v = v_pool[idx].reshape(mpp * p, h, d)
    scores = torch.einsum('chd,thd->cht', q.float(), k.float()) * scale
    qpos = pos0 + torch.arange(c, device=q.device)
    valid = (torch.arange(mpp * p, device=q.device)[None, :]
             <= qpos[:, None])                       # [C, T]
    scores = scores.masked_fill(~valid[:, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum('cht,thd->chd', probs, v.float())
    return o.to(q.dtype)


@register_op('flash_attention')
def _flash_attention_op(ctx, ins, attrs):
    # the reference's tile attrs (block_q, block_k, pallas_interpret)
    # have no meaning here: the kernels' tiles are fixed in their sources
    return out(flash_attention(first(ins, 'Q'), first(ins, 'K'),
                               first(ins, 'V'),
                               causal=attrs.get('causal', False),
                               scale=attrs.get('scale', None)))


@register_op('chunked_prefill_attention')
def _chunked_prefill_attention(ctx, ins, attrs):
    q = first(ins, 'Q')              # [C, H, D]
    k_pool = first(ins, 'KPool')     # [N, P, H, D]
    v_pool = first(ins, 'VPool')
    page_table = first(ins, 'PT')    # [MPP] integer page ids
    pos0 = first(ins, 'Pos0')        # scalar
    if torch.is_tensor(pos0):
        pos0 = pos0.reshape(()).long()
    return out(chunked_prefill_attention_math(
        q, k_pool, v_pool, page_table, pos0, scale=attrs.get('scale', None)))


@register_op('paged_attention')
def _paged_attention(ctx, ins, attrs):
    q = first(ins, 'Q')              # [S, H, D]
    k_pool = first(ins, 'KPool')     # [N, P, H, D]
    v_pool = first(ins, 'VPool')
    page_table = first(ins, 'PT')    # [S, MPP] integer page ids
    ctx_len = first(ins, 'CtxLen')   # [S]
    return out(paged_attention_math(
        q, k_pool, v_pool, page_table, ctx_len,
        scale=attrs.get('scale', None)))

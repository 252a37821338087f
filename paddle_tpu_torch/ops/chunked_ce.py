"""Fused vocab projection + softmax cross-entropy.

Reference parity: paddle_tpu/ops/chunked_ce.py ``fused_linear_softmax_ce``
with its two custom VJPs, here ``torch.autograd.Function``s:

- dense (reference :131): one logits matmul; the [N, V] logits are kept
  in the activation dtype for the backward softmax.
- chunked (reference :46): logits are computed per vocab chunk with a
  running (max, sumexp, label logit); the backward recomputes each
  chunk's logits, so [N, V] never exists.

``mode='auto'`` takes dense while its [N, V] residual fits 1/8 of the
device's memory (the card's ``total_memory``; the host's physical memory
for CPU tensors), else chunked.  The matmuls are ``torch.matmul``: the
reference leaves them to XLA, outside any Pallas kernel.
"""
import os

import torch

from ..core.registry import register_op
from .common import first, prod

_DEF_CHUNK = 4096


def _logits(x, w, b):
    return torch.matmul(x, w.to(x.dtype)).float() + b.float()


def _onehot_sub_scale(p, lab, g, c0=0):
    """p [N, C] softmax slice of columns [c0, c0 + C) -> (p - onehot(lab))
    * g, in place."""
    c = p.shape[1]
    local = lab - c0
    hit = (local >= 0) & (local < c)
    # a scatter of -1 (or -0 where the label lies in another chunk):
    # no boolean indexing, so no device-to-host sync
    p.scatter_add_(1, local.clamp(0, c - 1)[:, None],
                   -hit.to(p.dtype)[:, None])
    return p.mul_(g.float()[:, None])


class _DenseLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, lab):
        logits = _logits(x, w, b)
        m = logits.amax(dim=1)
        lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=1))
        ll = logits.gather(1, lab[:, None])[:, 0]
        ctx.save_for_backward(x, w, b, lab, lse, logits.to(x.dtype))
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        x, w, b, lab, lse, logits = ctx.saved_tensors
        dl = _onehot_sub_scale(torch.exp(logits.float() - lse[:, None]),
                               lab, g)
        dlc = dl.to(x.dtype)
        dx = torch.matmul(dlc, w.to(x.dtype).t())
        dw = torch.matmul(x.t(), dlc)
        db = dl.sum(dim=0)
        return dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype), None


class _ChunkedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, lab, chunk):
        n, v = x.shape[0], w.shape[1]
        m = torch.full((n,), -float('inf'), device=x.device)
        s = torch.zeros((n,), device=x.device)
        ll = torch.zeros((n,), device=x.device)
        for c0 in range(0, v, chunk):
            logits = _logits(x, w[:, c0:c0 + chunk], b[c0:c0 + chunk])
            m2 = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m2) + torch.exp(
                logits - m2[:, None]).sum(dim=1)
            m = m2
            local = lab - c0
            hit = (local >= 0) & (local < logits.shape[1])
            lg = logits.gather(
                1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
            ll = torch.where(hit, lg, ll)
        lse = m + torch.log(s)
        ctx.chunk = chunk
        ctx.save_for_backward(x, w, b, lab, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        x, w, b, lab, lse = ctx.saved_tensors
        v = w.shape[1]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
        db = torch.empty((v,), dtype=torch.float32, device=x.device)
        for c0 in range(0, v, ctx.chunk):
            wc = w[:, c0:c0 + ctx.chunk]
            logits = _logits(x, wc, b[c0:c0 + ctx.chunk])
            dl = _onehot_sub_scale(torch.exp(logits - lse[:, None]), lab, g,
                                   c0)
            dlc = dl.to(x.dtype)
            dx += torch.matmul(dlc, wc.to(x.dtype).t()).float()
            dw[:, c0:c0 + ctx.chunk] = torch.matmul(x.t(), dlc).float()
            db[c0:c0 + ctx.chunk] = dl.sum(dim=0)
        return (dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype), None,
                None)


def _dense_bytes_budget(device):
    """1/8 of the device's memory: the card's total memory, or the
    host's physical memory for CPU tensors."""
    if device.type == 'cuda':
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')
    return total // 8


@register_op('fused_linear_softmax_ce')
def _fused_linear_softmax_ce(ctx, ins, attrs):
    """X [.., D] -> per-position CE loss [.., 1] against Label [.., 1]
    through the W [D, V] / Bias [V] vocab head.  'dense' / 'chunked'
    force a path; 'auto' picks as the module says."""
    x = first(ins, 'X')
    w = first(ins, 'W')
    b = first(ins, 'Bias')
    label = first(ins, 'Label')
    chunk = int(attrs.get('chunk', _DEF_CHUNK))
    mode = attrs.get('mode', 'auto')
    flatten = int(attrs.get('flatten', x.dim() - 1))
    lead = tuple(x.shape[:flatten])
    d = prod(x.shape[flatten:])
    v = w.shape[1]
    if b is None:
        b = torch.zeros((v,), dtype=torch.float32, device=x.device)
    lab = label.reshape(-1).long()
    n = prod(lead)
    if mode == 'auto':
        mode = ('dense' if x.device.type == 'meta' or
                n * v * x.element_size() <= _dense_bytes_budget(x.device)
                else 'chunked')
    if mode == 'dense':
        loss = _DenseLinearCE.apply(x.reshape(-1, d), w, b, lab)
    elif mode == 'chunked':
        loss = _ChunkedLinearCE.apply(x.reshape(-1, d), w, b, lab, chunk)
    else:
        raise ValueError("fused_linear_softmax_ce mode %r (auto, dense or "
                         "chunked)" % (mode,))
    return {'Loss': [loss.reshape(lead + (1,))]}

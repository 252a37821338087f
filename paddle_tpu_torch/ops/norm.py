"""Normalisation ops (paddle_tpu/ops/norm.py): ``batch_norm`` and
``layer_norm``.  Plain torch ops: the reference leaves both to XLA,
outside any Pallas kernel.

``batch_norm`` (reference ``_batch_norm`` :100, paddle/operators/
batch_norm_op) keeps its statistics in float32 and, in training, computes
them in two passes (the mean, then the mean of squared deviations; the
reference's ``use_shift=False``, which it takes on every backend but the
TPU).  The training forward and its backward are one
``torch.autograd.Function`` with the reference's hand-written VJP
(``_bn_fwd`` / ``_bn_bwd`` :64-97): one reduction pass for
s1 = sum(dy) and s2 = sum(dy * xhat), then
dx = scale * inv * (dy - s1 / N - xhat * s2 / N), plus the terms of the
batch statistics' cotangents where an output reads them.  ``MeanOut`` /
``VarianceOut`` (the running statistics, which alias ``Mean`` /
``Variance``) are computed from the batch statistics detached: they are
state, not a differentiated path.

``layer_norm``: biased variance, epsilon 1e-5 by default, statistics in
float32, and the ``Mean`` / ``Variance`` outputs of shape
x.shape[:begin_norm_axis].
"""
import torch

from ..core.registry import register_op
from .common import first


def _bshape(x, axes):
    return tuple(1 if i in axes else x.shape[i] for i in range(x.dim()))


def _wide(t):
    """``t`` in float32, or wider: float64 stays (gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class BatchNormTrain(torch.autograd.Function):
    """(y, batch mean, biased batch variance) of ``x`` over ``axes``,
    with the reference's two-pass statistics and its VJP."""

    @staticmethod
    def forward(ctx, x, scale, bias, axes, eps):
        bshape = _bshape(x, axes)
        xf = _wide(x)
        m = xf.mean(dim=axes)
        v = (xf - m.reshape(bshape)).square().mean(dim=axes)
        inv = torch.rsqrt(v + eps)
        y = ((xf - m.reshape(bshape)) * inv.reshape(bshape) *
             scale.reshape(bshape) + bias.reshape(bshape))
        ctx.save_for_backward(x, scale, m, inv)
        ctx.axes = axes
        ctx.set_materialize_grads(False)
        return y.to(x.dtype), m, v

    @staticmethod
    def backward(ctx, dy, dm, dv):
        x, scale, m, inv = ctx.saved_tensors
        axes = ctx.axes
        bshape = _bshape(x, axes)
        n = float(x.numel() // m.numel())
        mb, invb = m.reshape(bshape), inv.reshape(bshape)
        xf = _wide(x)
        dyf = _wide(dy) if dy is not None else torch.zeros_like(xf)
        xhat = (xf - mb) * invb
        s1 = dyf.sum(dim=axes)                 # = dbias
        s2 = (dyf * xhat).sum(dim=axes)        # = dscale
        dx = (scale.reshape(bshape) * invb) * (
            dyf - (s1 / n).reshape(bshape) - xhat * (s2 / n).reshape(bshape))
        # the batch statistics' cotangents: None on the loss path
        if dm is not None:
            dx = dx + (dm / n).reshape(bshape)
        if dv is not None:
            dx = dx + (dv * 2.0 / n).reshape(bshape) * (xf - mb)
        return dx.to(x.dtype), s2, s1, None, None


@register_op('batch_norm')
def _batch_norm(ctx, ins, attrs):
    x = first(ins, 'X')
    scale = first(ins, 'Scale').float()
    bias = first(ins, 'Bias').float()
    mean = first(ins, 'Mean').float()
    var = first(ins, 'Variance').float()
    eps = attrs.get('epsilon', 1e-5)
    momentum = attrs.get('momentum', 0.9)
    ch_axis = 1 if attrs.get('data_layout', 'NCHW') == 'NCHW' \
        else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch_axis)
    if attrs.get('is_test', False):
        bshape = _bshape(x, axes)
        inv = 1.0 / torch.sqrt(var + eps)
        y = ((_wide(x) - mean.reshape(bshape)) * inv.reshape(bshape) *
             scale.reshape(bshape) + bias.reshape(bshape))
        return {'Y': [y.to(x.dtype)], 'MeanOut': [mean],
                'VarianceOut': [var], 'SavedMean': [mean],
                'SavedVariance': [var]}
    y, use_mean, use_var = BatchNormTrain.apply(x, scale, bias, axes,
                                                float(eps))
    return {'Y': [y],
            'MeanOut': [momentum * mean + (1 - momentum) * use_mean.detach()],
            'VarianceOut': [momentum * var +
                            (1 - momentum) * use_var.detach()],
            'SavedMean': [use_mean], 'SavedVariance': [use_var]}


@register_op('layer_norm')
def _layer_norm(ctx, ins, attrs):
    x = first(ins, 'X')
    scale = first(ins, 'Scale')
    bias = first(ins, 'Bias')
    eps = attrs.get('epsilon', 1e-5)
    begin = attrs.get('begin_norm_axis', 1)
    axes = tuple(range(begin, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, keepdim=True, unbiased=False)
    y = (xf - mean) / torch.sqrt(var + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.float().reshape(norm_shape)
    if bias is not None:
        y = y + bias.float().reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {'Y': [y.to(x.dtype)], 'Mean': [mean.reshape(lead)],
            'Variance': [var.reshape(lead)]}

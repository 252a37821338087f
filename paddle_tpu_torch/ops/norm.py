"""Layer normalisation (paddle_tpu/ops/norm.py ``layer_norm``).

Biased variance, epsilon 1e-5 by default, statistics in float32, and
the ``Mean`` / ``Variance`` outputs of shape x.shape[:begin_norm_axis].
Plain torch ops: the reference leaves layer norm to XLA.
"""
import torch

from ..core.registry import register_op
from .common import first


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

"""Convolution ops (paddle_tpu/ops/conv.py), cut to ``conv2d``.

Reference parity: ``_conv2d`` (paddle/operators/conv_op): an OIHW filter
cast to the input's dtype, strides, symmetric paddings, dilations and
groups; ``data_format`` 'NCHW' or 'NHWC' for the input and the output.
The reference leaves the convolution to XLA, outside any Pallas kernel,
so here it is ``F.conv2d`` (cuDNN on the card).  NHWC runs as a
channels-last view of the same memory, so no copy is made either way.
"""
import torch.nn.functional as F

from ..core.registry import register_op
from .common import first


def pair(v):
    return [int(x) for x in v] if isinstance(v, (list, tuple)) \
        else [int(v)] * 2


def to_nchw(x, fmt):
    """An NHWC tensor as an NCHW view (channels-last strides)."""
    return x.permute(0, 3, 1, 2) if fmt == 'NHWC' else x


def from_nchw(y, fmt):
    return y.permute(0, 2, 3, 1) if fmt == 'NHWC' else y


@register_op('conv2d')
def _conv2d(ctx, ins, attrs):
    x = first(ins, 'Input')
    w = first(ins, 'Filter')   # OIHW
    fmt = attrs.get('data_format', 'NCHW')
    y = F.conv2d(to_nchw(x, fmt), w.to(x.dtype),
                 stride=pair(attrs.get('strides', [1, 1])),
                 padding=pair(attrs.get('paddings', [0, 0])),
                 dilation=pair(attrs.get('dilations', [1, 1])),
                 groups=attrs.get('groups', 1) or 1)
    return {'Output': [from_nchw(y, fmt)]}

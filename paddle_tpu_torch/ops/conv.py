"""Convolution ops (paddle_tpu/ops/conv.py): ``conv2d``, ``conv3d``,
``conv2d_transpose``, ``conv3d_transpose``, ``conv_shift`` and
``row_conv``.

Reference parity: ``_conv2d`` (paddle/operators/conv_op): an OIHW filter
cast to the input's dtype, strides, symmetric paddings, dilations and
groups; ``data_format`` 'NCHW' or 'NHWC' for the input and the output.
``conv3d`` is the same in NCDHW.  The transposes (conv_transpose_op) take
the filter as (in_c, out_c, k...), with no groups and no output padding:
an output of (H - 1) * s - 2p + d (k - 1) + 1.  The reference leaves the
convolutions to XLA, outside any Pallas kernel, so here they are
``F.conv*`` (cuDNN on the card; 16-bit inputs accumulate in float32
there).  NHWC runs as a channels-last view of the same memory, so no copy
is made either way.  ``conv_shift`` (conv_shift_op) is a circular
correlation of each row of X with its row of Y, summed in float32.
"""
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import first, out


def pair(v, n=2):
    return [int(x) for x in v] if isinstance(v, (list, tuple)) \
        else [int(v)] * n


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


@register_op('conv3d')
def _conv3d(ctx, ins, attrs):
    x = first(ins, 'Input')
    w = first(ins, 'Filter')   # OIDHW
    y = F.conv3d(x, w.to(x.dtype),
                 stride=pair(attrs.get('strides', [1, 1, 1]), 3),
                 padding=pair(attrs.get('paddings', [0, 0, 0]), 3),
                 dilation=pair(attrs.get('dilations', [1, 1, 1]), 3),
                 groups=attrs.get('groups', 1) or 1)
    return {'Output': [y]}


@register_op('conv2d_transpose')
def _conv2d_transpose(ctx, ins, attrs):
    x = first(ins, 'Input')
    w = first(ins, 'Filter')   # (in_c, out_c, kh, kw)
    y = F.conv_transpose2d(x, w.to(x.dtype),
                           stride=pair(attrs.get('strides', [1, 1])),
                           padding=pair(attrs.get('paddings', [0, 0])),
                           dilation=pair(attrs.get('dilations', [1, 1])))
    return {'Output': [y]}


@register_op('conv3d_transpose')
def _conv3d_transpose(ctx, ins, attrs):
    x = first(ins, 'Input')
    w = first(ins, 'Filter')   # (in_c, out_c, kd, kh, kw)
    y = F.conv_transpose3d(x, w.to(x.dtype),
                           stride=pair(attrs.get('strides', [1, 1, 1]), 3),
                           padding=pair(attrs.get('paddings', [0, 0, 0]), 3),
                           dilation=pair(attrs.get('dilations', [1, 1, 1]),
                                         3))
    return {'Output': [y]}


@register_op('conv_shift')
def _conv_shift(ctx, ins, attrs):
    """Out[i, j] = sum_k X[i, (j + k - M // 2) mod N] * Y[i, k] for X
    [B, N] and Y [B, M]."""
    x = first(ins, 'X')
    y = first(ins, 'Y')
    n, m = x.shape[1], y.shape[1]
    idx = (torch.arange(n, device=x.device)[:, None] +
           torch.arange(m, device=x.device)[None, :] - m // 2) % n
    return out(torch.einsum('bnm,bm->bn', x[:, idx].float(),
                            y.float()).to(x.dtype))


@register_op('row_conv')
def _row_conv(ctx, ins, attrs):
    """The look-ahead row convolution (operators/row_conv_op) over padded
    sequences: Out[b, t] = sum_{k < K} X[b, t + k] * Filter[k], steps
    past T zeros, summed in k's order as the reference sums them."""
    x = first(ins, 'X')   # [B, T, D]
    w = first(ins, 'Filter')   # [K, D]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, 0, w.shape[0] - 1))
    acc = torch.zeros_like(x)
    for k in range(w.shape[0]):
        acc = acc + xp[:, k:k + t, :] * w[k]
    return out(acc)

"""Pooling ops (paddle_tpu/ops/pool.py): ``pool2d``, ``pool3d``,
``max_pool2d_with_index``, ``unpool`` and ``spp``.

Reference parity: ``_pool2d`` / ``_pool2d_op`` (paddle/operators/
pool_op), which reduce over windows with ``lax.reduce_window``:

- max pooling pads with -inf; average pooling sums in float32 over a
  zero-padded input;
- the average divides by the count of valid (unpadded) cells when
  ``exclusive`` is set and a padding is nonzero, and by prod(ksize)
  otherwise;
- ``global_pooling`` takes the whole plane with no padding;
- the output size rounds down.

``F.max_pool2d`` / ``F.avg_pool2d`` (cuDNN on the card) compute exactly
that: ``count_include_pad=False`` is the valid-cell divisor.  They take
a padding of at most half the window; a wider one is padded here
explicitly (-inf or 0), after which the window never leaves the padded
plane and the divisors are the same.

``pool3d``'s average always divides by prod(ksize), padding included.
``max_pool2d_with_index`` pads with -inf and returns, beside the maxima,
each one's flat H x W position in its plane (int32).  ``unpool`` adds
each value at its position in a zero plane, repeated positions summing.
``spp`` pools each level of its pyramid (2^l x 2^l bins) with the
reference's window, stride and pad, dividing an average by the window.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import first
from .conv import from_nchw, pair, to_nchw


def pool2d(x, pooling_type, ksize, strides, paddings, global_pooling,
           exclusive=True, fmt='NCHW'):
    x = to_nchw(x, fmt)
    if global_pooling:
        ksize, paddings = list(x.shape[2:]), [0, 0]
    if any(p > k // 2 for p, k in zip(paddings, ksize)):
        fill = float('-inf') if pooling_type == 'max' else 0.0
        ph, pw = paddings
        xp = F.pad(x, [pw, pw, ph, ph], value=fill)
        if pooling_type != 'max' and exclusive:
            ones = F.pad(torch.ones_like(x[:1, :1], dtype=torch.float32),
                         [pw, pw, ph, ph])
            s = F.avg_pool2d(xp.float(), ksize, strides, divisor_override=1)
            cnt = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
            return from_nchw((s / cnt).to(x.dtype), fmt)
        x, paddings = xp, [0, 0]
    if pooling_type == 'max':
        y = F.max_pool2d(x, ksize, strides, paddings)
    else:
        y = F.avg_pool2d(x.float(), ksize, strides, paddings,
                         count_include_pad=not exclusive).to(x.dtype)
    return from_nchw(y, fmt)


@register_op('pool2d')
def _pool2d_op(ctx, ins, attrs):
    y = pool2d(first(ins, 'X'), attrs.get('pooling_type', 'max'),
               pair(attrs.get('ksize', [2, 2])),
               pair(attrs.get('strides', [1, 1])),
               pair(attrs.get('paddings', [0, 0])),
               attrs.get('global_pooling', False),
               attrs.get('exclusive', True),
               attrs.get('data_format', 'NCHW'))
    return {'Out': [y]}


@register_op('pool3d')
def _pool3d_op(ctx, ins, attrs):
    x = first(ins, 'X')   # NCDHW
    ksize = pair(attrs.get('ksize', [2, 2, 2]), 3)
    strides = pair(attrs.get('strides', [1, 1, 1]), 3)
    paddings = pair(attrs.get('paddings', [0, 0, 0]), 3)
    if attrs.get('global_pooling', False):
        ksize, paddings = list(x.shape[2:]), [0, 0, 0]
    is_max = attrs.get('pooling_type', 'max') == 'max'
    if any(p > k // 2 for p, k in zip(paddings, ksize)):
        x = F.pad(x, [p for p in reversed(paddings) for _ in (0, 1)],
                  value=float('-inf') if is_max else 0.0)
        paddings = [0, 0, 0]
    if is_max:
        y = F.max_pool3d(x, ksize, strides, paddings)
    else:
        y = F.avg_pool3d(x.float(), ksize, strides, paddings,
                         divisor_override=int(np.prod(ksize))).to(x.dtype)
    return {'Out': [y]}


@register_op('max_pool2d_with_index')
def _max_pool_with_index(ctx, ins, attrs):
    x = first(ins, 'X')   # NCHW
    ksize = pair(attrs.get('ksize', [2, 2]))
    strides = pair(attrs.get('strides', ksize))
    ph, pw = pair(attrs.get('paddings', [0, 0]))
    if attrs.get('global_pooling', False):
        ksize, ph, pw = list(x.shape[2:]), 0, 0
    h, w = x.shape[2:]
    xp = F.pad(x.float(), [pw, pw, ph, ph], value=float('-inf'))
    vals, idx = F.max_pool2d(xp, ksize, strides, return_indices=True)
    if ph or pw:   # positions in the padded plane -> in X's plane
        idx = (idx // (w + 2 * pw) - ph) * w + idx % (w + 2 * pw) - pw
    return {'Out': [vals.to(x.dtype)], 'Mask': [idx.to(torch.int32)]}


@register_op('unpool')
def _unpool(ctx, ins, attrs):
    x = first(ins, 'X')   # [N, C, h, w]
    idx = first(ins, 'Indices').long()
    out_h, out_w = attrs['unpooled_height'], attrs['unpooled_width']
    n, c, _, _ = x.shape
    flat = x.new_zeros((n, c, out_h * out_w)).scatter_add(
        2, idx.reshape(n, c, -1), x.reshape(n, c, -1))
    return {'Out': [flat.reshape(n, c, out_h, out_w)]}


@register_op('spp')
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling (operators/spp_op) over NCHW X: level l
    pools into 2^l x 2^l bins, the levels' outputs flattened and
    concatenated."""
    x = first(ins, 'X')
    pool_type = attrs.get('pooling_type', 'max')
    n, _, h, w = x.shape
    outs = []
    for level in range(attrs.get('pyramid_height', 3)):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        y = pool2d(x, pool_type, [kh, kw], [kh, kw], [ph, pw], False,
                   exclusive=False)
        outs.append(y.reshape(n, -1))
    return {'Out': [torch.cat(outs, dim=1)]}

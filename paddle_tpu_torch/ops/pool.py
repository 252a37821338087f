"""Pooling ops (paddle_tpu/ops/pool.py), cut to ``pool2d``.

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
"""
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

"""Math ops: mul, elementwise_add, scale, mean.

Reference parity: paddle_tpu/ops/math.py (paddle/operators/{mul,
elementwise_add,scale,mean}_op).  The matmul is ``torch.matmul``: the
reference leaves it to XLA, outside any Pallas kernel.
"""
import torch

from ..core.registry import register_op
from .common import bcast_axis, first, out, prod


@register_op('mul')
def _mul(ctx, ins, attrs):
    """Fluid ``mul``: flatten X to 2-D at x_num_col_dims, Y at
    y_num_col_dims, then matmul (operators/mul_op.cc)."""
    x = first(ins, 'X')
    y = first(ins, 'Y')
    xnc = attrs.get('x_num_col_dims', 1)
    ync = attrs.get('y_num_col_dims', 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(prod(xs[:xnc]), prod(xs[xnc:]))
    y2 = y.reshape(prod(ys[:ync]), prod(ys[ync:])).to(x.dtype)
    return out(torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:]))


@register_op('elementwise_add')
def _elementwise_add(ctx, ins, attrs):
    x = first(ins, 'X')
    y = bcast_axis(x, first(ins, 'Y'), attrs.get('axis', -1))
    if y.dtype != x.dtype and x.dtype.is_floating_point and \
            y.dtype.is_floating_point:
        # float32 master params meeting low-precision activations stay
        # in the activation dtype
        y = y.to(x.dtype)
    return out(x + y)


@register_op('scale')
def _scale(ctx, ins, attrs):
    x = first(ins, 'X')
    scale = attrs.get('scale', 1.0)
    bias = attrs.get('bias', 0.0)
    if attrs.get('bias_after_scale', True):
        return out(x * scale + bias)
    return out((x + bias) * scale)


@register_op('mean')
def _mean(ctx, ins, attrs):
    x = first(ins, 'X')
    if first(ins, 'XLen') is not None:
        raise NotImplementedError(
            "mean over a ragged input (XLen) is not ported yet: ROADMAP.md "
            "Queue 1, the sequence slice")
    return out(x.float().mean().to(x.dtype).reshape(1))

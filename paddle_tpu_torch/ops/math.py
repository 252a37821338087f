"""Math ops: mul, matmul, elementwise_add, scale, sum, mean, softmax,
top_k.

Reference parity: paddle_tpu/ops/math.py (paddle/operators/{mul,matmul,
elementwise_add,scale,sum,mean,softmax,top_k}_op).  The products are
``torch.matmul``: the reference leaves them to XLA, outside any Pallas
kernel.
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


@register_op('matmul')
def _matmul(ctx, ins, attrs):
    """Batched X @ Y with ``transpose_X`` / ``transpose_Y`` (the last two
    axes) and ``alpha`` (operators/matmul_op)."""
    x = first(ins, 'X')
    y = first(ins, 'Y')
    if attrs.get('transpose_X', False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get('transpose_Y', False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    z = torch.matmul(x, y.to(x.dtype))
    if x.dim() == 1 and y.dim() == 1:
        return out(z)
    alpha = attrs.get('alpha', 1.0)
    return out(z * alpha if alpha != 1.0 else z)


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


@register_op('sum')
def _sum(ctx, ins, attrs):
    xs = ins.get('X', [])
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return out(acc)


@register_op('mean')
def _mean(ctx, ins, attrs):
    """The mean of X; over a ragged X (its lengths in XLen) the mean of the
    valid steps only, as the reference's LoDTensor holds only those."""
    x = first(ins, 'X')
    lengths = first(ins, 'XLen')
    xf = x.float()
    if lengths is None:
        m = xf.mean()
    else:
        ln = lengths.reshape(-1).long()
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < \
            ln[:, None]
        mask = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))
        # counted in float32, as the reference counts
        count = ln.float().sum() * float(prod(x.shape[2:]))
        m = torch.where(mask, xf, torch.zeros_like(xf)).sum() / \
            torch.clamp(count, min=1.0)
    return out(m.to(x.dtype).reshape(1))


@register_op('softmax')
def _softmax(ctx, ins, attrs):
    x = first(ins, 'X')
    return out(torch.softmax(x.float(), dim=-1).to(x.dtype))


@register_op('top_k')
def _top_k(ctx, ins, attrs):
    vals, idxs = torch.topk(first(ins, 'X'), attrs.get('k', 1), dim=-1)
    return {'Out': [vals], 'Indices': [idxs.to(torch.int32)]}

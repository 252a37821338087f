"""Tensor-manipulation ops: reshape, transpose, split, concat, pad, cast,
assign, fill_constant.

Reference parity: paddle_tpu/ops/tensor_ops.py (paddle/operators/
{reshape,transpose,split,concat,pad,cast,assign,fill_constant}_op).
Integer types keep their width; 64-bit feeds arrive narrowed to 32 bits
by the executor, as in the reference.
"""
import torch
import torch.nn.functional as F

from ..core import datatypes
from ..core.registry import register_op
from .common import first, out


@register_op('reshape')
def _reshape(ctx, ins, attrs):
    x = first(ins, 'X')
    shape = list(attrs['shape'])
    # fluid semantics: 0 copies this dim from x, -1 infers
    for i, d in enumerate(shape):
        if d == 0:
            shape[i] = x.shape[i]
    return out(x.reshape(shape))


@register_op('transpose')
def _transpose(ctx, ins, attrs):
    return out(first(ins, 'X').permute(*attrs['axis']))


@register_op('split')
def _split(ctx, ins, attrs):
    x = first(ins, 'X')
    axis = attrs.get('axis', 0)
    if attrs.get('sections'):
        pieces = torch.split(x, list(attrs['sections']), dim=axis)
    else:
        num = attrs['num']
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d not divisible into %d"
                             % (axis, x.shape[axis], num))
        pieces = torch.split(x, x.shape[axis] // num, dim=axis)
    return {'Out': list(pieces)}


@register_op('concat')
def _concat(ctx, ins, attrs):
    return out(torch.cat(ins['X'], dim=attrs.get('axis', 0)))


@register_op('pad')
def _pad(ctx, ins, attrs):
    """Constant padding; ``paddings`` holds (before, after) for each dim
    in order, as the reference's ``jnp.pad`` takes them."""
    x = first(ins, 'X')
    p = attrs['paddings']
    widths = []
    for d in reversed(range(x.dim())):   # F.pad starts at the last dim
        widths += [p[2 * d], p[2 * d + 1]]
    return out(F.pad(x, widths, value=attrs.get('pad_value', 0.0)))


@register_op('cast')
def _cast(ctx, ins, attrs):
    return out(first(ins, 'X').to(datatypes.as_torch_dtype(
        attrs['out_dtype'])))


@register_op('assign')
def _assign(ctx, ins, attrs):
    return out(first(ins, 'X'))


@register_op('fill_constant')
def _fill_constant(ctx, ins, attrs):
    dtype = datatypes.as_torch_dtype(attrs.get('dtype', 'float32'))
    return out(torch.full(tuple(attrs['shape']), attrs['value'], dtype=dtype,
                          device=ctx.device))

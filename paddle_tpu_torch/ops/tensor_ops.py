"""Tensor-manipulation ops: reshape, transpose, split, concat, expand, pad,
crop, cast, assign, assign_value, fill_constant, fill, fill_zeros_like,
fill_constant_batch_size_like, increment, gather, scatter, multiplex,
sign_of, the comparisons, the logical ops, select, and the
sequence-shaped one_hot, sequence_reshape and im2sequence.

Reference parity: paddle_tpu/ops/tensor_ops.py (paddle/operators/
{reshape,transpose,split,concat,expand,pad,crop,cast,assign,assign_value,
fill_constant,fill,fill_zeros_like,fill_constant_batch_size_like,
increment,gather,scatter,multiplex,sign,compare,logical,select,one_hot,
sequence_reshape,im2sequence}_op).
Integer types keep their width; 64-bit feeds arrive narrowed to 32 bits
by the executor, as in the reference.  ``scatter`` with repeated ids
keeps one of their rows, which one undefined, in both packages.
"""
import weakref

import numpy as np
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


@register_op('expand')
def _expand(ctx, ins, attrs):
    """Tile ``X`` ``expand_times`` times along each dim (``jnp.tile``:
    fewer times than dims tile the trailing dims)."""
    x = first(ins, 'X')
    times = [int(t) for t in attrs['expand_times']]
    times = [1] * (x.dim() - len(times)) + times
    return out(x.repeat(*times))


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


@register_op('crop')
def _crop(ctx, ins, attrs):
    """X[offsets[i] : offsets[i] + shape[i]] along each leading dim."""
    slices = tuple(slice(o, o + n) for o, n in zip(attrs['offsets'],
                                                    attrs['shape']))
    return out(first(ins, 'X')[slices])


@register_op('cast')
def _cast(ctx, ins, attrs):
    return out(first(ins, 'X').to(datatypes.as_torch_dtype(
        attrs['out_dtype'])))


@register_op('assign')
def _assign(ctx, ins, attrs):
    return out(first(ins, 'X'))


# assign_value's device tensors: id(values array) -> (a weakref to the
# array, {device: tensor}).  The constant-folding pass bakes folded values
# into the program as this op, and a step on the card then reads them
# with no host-to-device copy.
_CONSTANTS = {}


def _device_constant(values, attrs, device):
    key = id(values)
    entry = _CONSTANTS.get(key)
    if entry is None or entry[0]() is not values:
        entry = _CONSTANTS[key] = (weakref.ref(
            values, lambda _, key=key: _CONSTANTS.pop(key, None)), {})
    t = entry[1].get(device)
    if t is None:
        t = entry[1][device] = _to_tensor(values, attrs, device)
    return t


def _to_tensor(values, attrs, device):
    dtype = datatypes.as_torch_dtype(attrs.get('dtype', 'float32'))
    return torch.as_tensor(np.asarray(values), device=device).to(
        dtype).reshape(tuple(attrs['shape']))


@register_op('assign_value')
def _assign_value(ctx, ins, attrs):
    values = attrs['values']
    if isinstance(values, np.ndarray) and ctx.device.type != 'meta':
        return out(_device_constant(values, attrs, ctx.device))
    return out(_to_tensor(values, attrs, ctx.device))


_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


@register_op('fill_constant')
def _fill_constant(ctx, ins, attrs):
    """A constant; a 64-bit type narrows to 32 bits, as in the reference
    (its counters and limits are int32, as fed ids are)."""
    dtype = datatypes.as_torch_dtype(attrs.get('dtype', 'float32'))
    dtype = _NARROW.get(dtype, dtype)
    return out(torch.full(tuple(attrs['shape']), attrs['value'], dtype=dtype,
                          device=ctx.device))


@register_op('fill')
def _fill(ctx, ins, attrs):
    """``value`` (a flat list) as a tensor of ``shape`` and ``dtype``; a
    64-bit type narrows to 32 bits, as in the reference."""
    dtype = datatypes.as_torch_dtype(attrs.get('dtype', 'float32'))
    data = torch.as_tensor(np.asarray(attrs['value']), device=ctx.device)
    return out(data.to(_NARROW.get(dtype, dtype)).reshape(attrs['shape']))


@register_op('fill_zeros_like')
def _fill_zeros_like(ctx, ins, attrs):
    return out(torch.zeros_like(first(ins, 'X')))


@register_op('fill_constant_batch_size_like')
def _fill_cbsl(ctx, ins, attrs):
    """``shape`` with dim ``output_dim_idx`` taken from dim
    ``input_dim_idx`` of ``Input``; int64 narrows to int32, as in the
    reference."""
    ref = first(ins, 'Input')
    shape = list(attrs['shape'])
    in_idx = attrs.get('input_dim_idx', 0)
    out_idx = attrs.get('output_dim_idx', 0)
    shape[out_idx] = ref.shape[in_idx]
    dtype = datatypes.as_torch_dtype(attrs.get('dtype', 'float32'))
    if dtype == torch.int64:
        dtype = torch.int32
    return out(torch.full(tuple(shape), attrs.get('value', 0.0),
                          dtype=dtype, device=ref.device))


@register_op('increment')
def _increment(ctx, ins, attrs):
    """X + step in X's dtype; a Python scalar operand, so a step counter
    on the card adds no host-to-device copy."""
    x = first(ins, 'X')
    step = attrs.get('step', 1.0)
    return out(x + (float(step) if x.dtype.is_floating_point
                    else int(step)))


@register_op('gather')
def _gather(ctx, ins, attrs):
    """The rows of X at Index (flattened)."""
    index = first(ins, 'Index').reshape(-1).long()
    return out(torch.index_select(first(ins, 'X'), 0, index))


@register_op('scatter')
def _scatter(ctx, ins, attrs):
    """X with its rows at Ids overwritten by Updates (operators/
    scatter_op)."""
    ids = first(ins, 'Ids').reshape(-1).long()
    return out(first(ins, 'X').index_copy(0, ids, first(ins, 'Updates')))


@register_op('multiplex')
def _multiplex(ctx, ins, attrs):
    """Row b of the output is row b of candidate X[Ids[b]]."""
    ids = first(ins, 'Ids').reshape(-1).long()
    stack = torch.stack(ins['X'], dim=0)   # [candidates, batch, ...]
    return out(stack[ids, torch.arange(stack.shape[1], device=ids.device)])


@register_op('sign_of')
def _sign_of(ctx, ins, attrs):
    return out(torch.sign(first(ins, 'X')))


def _compare(name, fn):
    @register_op(name)
    def _impl(ctx, ins, attrs):
        return out(fn(first(ins, 'X'), first(ins, 'Y')))

    return _impl


for _name, _fn in (('less_than', torch.lt), ('less_equal', torch.le),
                   ('greater_than', torch.gt), ('greater_equal', torch.ge),
                   ('equal', torch.eq), ('not_equal', torch.ne)):
    _compare(_name, _fn)


def _logical(name, fn, binary=True):
    @register_op('logical_' + name)
    def _impl(ctx, ins, attrs):
        x = first(ins, 'X')
        if binary:
            return out(fn(x, first(ins, 'Y')))
        return out(fn(x))

    return _impl


_logical('and', torch.logical_and)
_logical('or', torch.logical_or)
_logical('xor', torch.logical_xor)
_logical('not', torch.logical_not, binary=False)


@register_op('select')
def _select(ctx, ins, attrs):
    """Elementwise where(Condition, X, Y)."""
    cond = first(ins, 'Condition')
    return out(torch.where(cond.bool(), first(ins, 'X'), first(ins, 'Y')))


@register_op('one_hot')
def _one_hot(ctx, ins, attrs):
    """Int X (a trailing unit dim dropped) -> float32 [..., depth]; an id
    outside [0, depth) gives a zero row, as ``jax.nn.one_hot``."""
    x = first(ins, 'X').to(torch.int32)
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    depth = torch.arange(attrs['depth'], dtype=torch.int32, device=x.device)
    return out((x[..., None] == depth).float())


@register_op('sequence_reshape')
def _sequence_reshape(ctx, ins, attrs):
    """X [B, T, D] -> [B, T * D / new_dim, new_dim]."""
    x = first(ins, 'X')
    return out(x.reshape(x.shape[0], -1, attrs['new_dim']))


@register_op('im2sequence')
def _im2sequence(ctx, ins, attrs):
    """NCHW X -> its conv patches as a sequence, [N, out_h * out_w, C *
    kh * kw], channel-major within a patch (operators/im2sequence_op, the
    padded form of its LoD output); ``paddings`` are (up, left, down,
    right), two values meaning up = down and left = right."""
    x = first(ins, 'X')
    kh, kw = attrs['kernels']
    sh, sw = attrs.get('strides', [1, 1])
    p = attrs.get('paddings', [0, 0, 0, 0])
    x = F.pad(x, (p[1], p[3] if len(p) > 3 else p[1],
                  p[0], p[2] if len(p) > 2 else p[0]))
    return out(F.unfold(x, (kh, kw), stride=(sh, sw)).transpose(1, 2))

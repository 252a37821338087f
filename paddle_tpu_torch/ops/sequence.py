"""Sequence (LoD) ops on the padded + lengths representation.

Reference parity: paddle_tpu/ops/sequence.py (paddle/operators/
sequence_pool_op, sequence_softmax_op, sequence_conv_op,
reorder_lod_tensor_by_rank_op), cut to ``sequence_pool``, its
``sequence_first_step`` / ``sequence_last_step`` forms,
``sequence_softmax``, ``sequence_conv`` and
``reorder_lod_tensor_by_rank``.  A ragged batch is a
dense [B, T, ...] tensor with int32 lengths [B] in slot ``XLen``; the
masks come from the lengths, and missing lengths mean every row is full.
"""
import torch

from ..core.registry import register_op
from .common import first, out


def _lengths(ins, x):
    ln = first(ins, 'XLen')
    if ln is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.long,
                          device=x.device)
    return ln.reshape(-1).long()


def _pool(x, lengths, ptype):
    tail = (1,) * (x.dim() - 2)
    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
            < lengths[:, None]).reshape(tuple(lengths.shape) + (-1,) + tail)
    xf = x.float()
    lf = torch.clamp(lengths.float(), min=1.0).reshape((-1,) + tail)
    if ptype in ('SUM', 'AVERAGE', 'SQRT'):
        y = torch.where(mask, xf, torch.zeros_like(xf)).sum(dim=1)
        if ptype == 'AVERAGE':
            y = y / lf
        elif ptype == 'SQRT':
            y = y / torch.sqrt(lf)
    elif ptype == 'MAX':
        y = torch.where(mask, xf, torch.full_like(xf, -float('inf')))
        y = y.amax(dim=1)
    elif ptype == 'LAST':
        idx = torch.clamp(lengths - 1, min=0).reshape((-1, 1) + tail)
        y = torch.gather(xf, 1, idx.expand((-1, 1) + tuple(x.shape[2:])))
        y = y.squeeze(1)
    elif ptype == 'FIRST':
        y = xf[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    return out(y.to(x.dtype))


@register_op('sequence_pool')
def _sequence_pool(ctx, ins, attrs):
    """X [B, T, ...] -> [B, ...] over each row's valid steps."""
    x = first(ins, 'X')
    ptype = attrs.get('pooltype', attrs.get('pool_type', 'AVERAGE')).upper()
    return _pool(x, _lengths(ins, x), ptype)


@register_op('sequence_first_step')
def _sequence_first_step(ctx, ins, attrs):
    x = first(ins, 'X')
    return _pool(x, _lengths(ins, x), 'FIRST')


@register_op('sequence_last_step')
def _sequence_last_step(ctx, ins, attrs):
    x = first(ins, 'X')
    return _pool(x, _lengths(ins, x), 'LAST')


@register_op('sequence_softmax')
def _sequence_softmax(ctx, ins, attrs):
    """Softmax over the valid steps of each row along ``axis``, the time
    axis the lengths (XLen) mask: masked entries are -inf before the
    softmax and 0 after it.  Takes [B, T] or [B, T, 1] (axis 1), and
    axis=2 on [B, Td, Ts] scores is attention over another sequence's
    steps."""
    x = first(ins, 'X')
    axis = int(attrs.get('axis', 1))
    squeeze = axis == 1 and x.dim() == 3 and x.shape[-1] == 1
    xs = x[..., 0] if squeeze else x
    t = xs.shape[axis]
    ln = first(ins, 'XLen')
    ln = (torch.full((xs.shape[0],), t, dtype=torch.long, device=x.device)
          if ln is None else ln.reshape(-1).long())
    mshape = [1] * xs.dim()
    mshape[0], mshape[axis] = xs.shape[0], t
    mask = (torch.arange(t, device=x.device)[None, :]
            < ln[:, None]).reshape(mshape)
    logits = torch.where(mask, xs.float(),
                         torch.full_like(xs, -float('inf'), dtype=torch.float32))
    y = torch.softmax(logits, dim=axis)
    y = torch.where(mask, y, torch.zeros_like(y)).to(x.dtype)
    return out(y[..., None] if squeeze else y)


@register_op('sequence_conv')
def _sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time (operators/sequence_conv_op):
    output step t sees steps [t + contextStart, t + contextStart +
    contextLength) of its row, flattened, times Filter [contextLength * D,
    M].  Frames before the first step, past the row's length or past T
    are zeros, and so is the output past the row's length.  The frames are
    gathered into [B, T, contextLength * D] and multiplied in one
    ``torch.matmul``, as the reference lowers it to one product."""
    x = first(ins, 'X')   # [B, T, D]
    w = first(ins, 'Filter')
    lengths = _lengths(ins, x)
    ctx_len = attrs.get('contextLength', attrs.get('context_length', 3))
    ctx_start = attrs.get('contextStart', attrs.get('context_start',
                                                    -(ctx_len // 2)))
    t = x.shape[1]
    steps = torch.arange(t, device=x.device)
    mask = (steps[None, :] < lengths[:, None])[..., None]
    xm = torch.where(mask, x.float(), torch.zeros((), device=x.device))
    frames = []
    for k in range(ctx_len):
        off = ctx_start + k
        idx = steps + off
        valid = ((idx >= 0) & (idx < t))[None, :, None] & \
            (idx[None, :, None] < lengths[:, None, None])
        frames.append(torch.where(valid, torch.roll(xm, -off, dims=1),
                                  torch.zeros((), device=x.device)))
    y = torch.matmul(torch.cat(frames, dim=-1), w.float())
    y = torch.where(mask, y, torch.zeros((), device=x.device))
    return out(y.to(x.dtype))


@register_op('reorder_lod_tensor_by_rank')
def _reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """The rows of ``X`` by descending rank-table length, ties in row
    order (a stable sort), with the reordered lengths and the order."""
    x = first(ins, 'X')
    table = first(ins, 'RankTable').to(torch.int32).reshape(-1)
    order = torch.argsort(-table, stable=True)
    return {'Out': [x.index_select(0, order)], 'OutLen': [table[order]],
            'OrderedIndex': [order.to(torch.int32)]}

"""Sequence (LoD) ops on the padded + lengths representation.

Reference parity: paddle_tpu/ops/sequence.py (paddle/operators/
sequence_{pool,softmax,conv,expand,concat,slice,erase}_op, lod_reset_op,
reorder_lod_tensor_by_rank_op): ``sequence_pool``, its
``sequence_first_step`` / ``sequence_last_step`` forms,
``sequence_softmax``, ``sequence_conv``, ``sequence_expand``,
``sequence_concat``, ``sequence_slice``, ``sequence_erase``, ``lod_reset``
and ``reorder_lod_tensor_by_rank``.  A ragged batch is a dense [B, T, ...]
tensor with int32 lengths [B] in slot ``XLen`` (``YLen`` for
``sequence_expand``'s Y); the masks come from the lengths, and missing
lengths mean every row is full.  An op that changes the lengths writes
them to ``OutLen``, which the layer names ``<out>@LEN``.
"""
import torch

from ..core.registry import register_op
from .common import first, out


def _lengths(ins, x, slot='XLen'):
    ln = first(ins, slot)
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


def _time_mask(lengths, t, ndim):
    """[B, t] step < length, with ``ndim - 2`` trailing unit dims."""
    mask = torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - 2))


def _gather_steps(x, idx):
    """x [B, T, ...] at steps idx [B, S] -> [B, S, ...]."""
    tail = tuple(x.shape[2:])
    idx = idx.reshape(tuple(idx.shape) + (1,) * len(tail))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2]) + tail))


@register_op('sequence_expand')
def _sequence_expand(ctx, ins, attrs):
    """X [B, ...], one row a sequence, repeated over Y's steps: [B, Ty,
    ...], zeros past Y's lengths (operators/sequence_expand_op)."""
    x = first(ins, 'X')
    y = first(ins, 'Y')
    ty = y.shape[1]
    expanded = x[:, None].expand((x.shape[0], ty) + tuple(x.shape[1:]))
    mask = _time_mask(_lengths(ins, y, 'YLen'), ty, expanded.dim())
    return out(torch.where(mask, expanded, torch.zeros_like(expanded)))


@register_op('sequence_concat')
def _sequence_concat(ctx, ins, attrs):
    """Each row's sequences joined along time (operators/
    sequence_concat_op, axis 0 at level 0): the k-th input's padded row
    starts at the sum of the earlier inputs' lengths, as the reference's
    ``dynamic_update_slice`` writes it; zeros past the summed length,
    which is ``OutLen``."""
    xs = ins['X']
    lens = ins.get('XLen')
    if lens is None or len(lens) != len(xs):
        lens = [None] * len(xs)
    x0 = xs[0]
    total_t = sum(x.shape[1] for x in xs)
    pos = torch.arange(total_t, device=x0.device)
    res = torch.zeros((x0.shape[0], total_t) + tuple(x0.shape[2:]),
                      dtype=x0.dtype, device=x0.device)
    start = torch.zeros((x0.shape[0],), dtype=torch.long, device=x0.device)
    for x, ln in zip(xs, lens):
        t = x.shape[1]
        rel = pos[None, :] - start[:, None]
        inside = ((rel >= 0) & (rel < t)).reshape(
            tuple(rel.shape) + (1,) * (x.dim() - 2))
        vals = _gather_steps(x, torch.clamp(rel, 0, t - 1)).to(x0.dtype)
        res = torch.where(inside, vals, res)
        start = start + (torch.full_like(start, t) if ln is None
                         else ln.reshape(-1).long())
    res = torch.where(_time_mask(start, total_t, res.dim()), res,
                      torch.zeros_like(res))
    return {'Out': [res], 'OutLen': [start.to(torch.int32)]}


@register_op('sequence_slice')
def _sequence_slice(ctx, ins, attrs):
    """Row b's steps [Offset[b], Offset[b] + Length[b]) in a [B,
    max_length, ...] batch (operators/sequence_slice_op), steps past T
    zeros; ``OutLen`` is Length.  An offset out of range is taken as the
    reference's ``dynamic_slice`` takes it on the row padded to T +
    max_length: a negative one counts from the end, then it is clamped
    into [0, T]."""
    x = first(ins, 'X')
    offset = first(ins, 'Offset').reshape(-1).long()
    length = first(ins, 'Length').reshape(-1).to(torch.int32)
    max_len = int(attrs.get('max_length', x.shape[1]))
    t = x.shape[1]
    padded = torch.cat([x, torch.zeros((x.shape[0], max_len) +
                                       tuple(x.shape[2:]), dtype=x.dtype,
                                       device=x.device)], dim=1)
    offset = torch.where(offset < 0, offset + t + max_len, offset)
    idx = torch.clamp(offset, 0, t)[:, None] + \
        torch.arange(max_len, device=x.device)[None, :]
    y = _gather_steps(padded, idx)
    y = torch.where(_time_mask(length, max_len, y.dim()), y,
                    torch.zeros_like(y))
    return {'Out': [y], 'OutLen': [length]}


@register_op('sequence_erase')
def _sequence_erase(ctx, ins, attrs):
    """X [B, T] int tokens without those in ``tokens``, the kept ones
    moved left in order, zeros after them; ``OutLen`` counts the kept
    ones (operators/sequence_erase_op)."""
    x = first(ins, 'X')
    t = x.shape[1]
    steps = torch.arange(t, device=x.device)
    valid = steps[None, :] < _lengths(ins, x)[:, None]
    erase = torch.zeros_like(valid)
    for tok in attrs.get('tokens', []):   # no host-to-device copy
        erase = erase | (x == tok)
    erase = erase & valid
    keep = valid & ~erase
    # a stable partition: kept steps by position, then the rest
    order = torch.argsort(
        torch.where(keep, steps[None, :], t + steps[None, :]), dim=1)
    y = torch.gather(x, 1, order)
    new_len = keep.sum(dim=1).to(torch.int32)
    y = torch.where(steps[None, :] < new_len[:, None], y, torch.zeros_like(y))
    return {'Out': [y], 'OutLen': [new_len]}


@register_op('lod_reset')
def _lod_reset(ctx, ins, attrs):
    """X unchanged, with new lengths: Y's values, or the ``target_lod``
    attr's (operators/lod_reset_op, in the lengths form)."""
    x = first(ins, 'X')
    target = first(ins, 'Y')
    if target is None:
        target = torch.tensor(list(attrs['target_lod']), dtype=torch.int32,
                              device=x.device)
    return {'Out': [x], 'OutLen': [target.to(torch.int32).reshape(-1)]}

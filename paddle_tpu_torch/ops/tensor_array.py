"""Tensor-array ops (LoDTensorArray).

Reference parity: paddle_tpu/ops/tensor_array.py (paddle/operators/
tensor_array_read_write_op.cc, lod_tensor_to_array /
array_to_lod_tensor, lod_rank_table, max_sequence_len,
shrink_rnn_memory).

An array is a ``TArray``: a preallocated stacked buffer ``data`` [N, ...]
and its ``size``, a 0-d int32 tensor on the buffer's device, so a write
inside a ``while`` body never reads the size or the index on the host.
Reads and writes clamp the index into [0, N - 1] (a negative one counts
from the end first), as the reference's ``dynamic_(update_)index_in_dim``
do: a masked ``while`` tick runs its
body after the condition went false, when the counter equals the bound,
and its result is then discarded by the loop's select.  The capacity
comes from the time axis or the writer's ``capacity`` attr
(``DEFAULT_CAPACITY`` without one); an array is never grown.
"""
import torch

from ..core.registry import register_op
from .common import first, out

__all__ = ['TArray', 'EmptyTArray', 'DEFAULT_CAPACITY']

DEFAULT_CAPACITY = 128


class TArray(object):
    """Stacked tensor array: ``data`` [N, ...], ``size`` (0-d int32)."""

    __slots__ = ('data', 'size')

    def __init__(self, data, size):
        self.data = data
        self.size = size

    @property
    def capacity(self):
        return self.data.shape[0]


class EmptyTArray(object):
    """A created, never written array: only its dtype.  The first
    ``write_to_array`` allocates the buffer."""

    __slots__ = ('dtype',)

    def __init__(self, dtype='float32'):
        self.dtype = dtype


def _as_index(i):
    return i.reshape(()).to(torch.int32)


def _slot(arr, i):
    """Index ``i`` as the reference's dynamic index takes it (a negative
    one counts from the end, then the index is clamped into the
    capacity), as a 1-element int64 tensor for ``index_copy`` /
    ``index_select``."""
    cap = arr.capacity
    i = torch.where(i < 0, i + cap, i)
    return i.clamp(0, cap - 1).to(torch.int64).reshape(1)


def _size(n, device):
    # a fill, not a host-to-device copy
    return torch.full((), n, dtype=torch.int32, device=device)


@register_op('create_array')
def _create_array(ctx, ins, attrs):
    """An array; with ``capacity`` and ``elem_shape`` attrs its buffer is
    allocated now, else by the first write."""
    from ..core import datatypes
    dtype = attrs.get('elem_dtype', 'float32')
    if 'capacity' in attrs and 'elem_shape' in attrs:
        cap = int(attrs['capacity'])
        shape = tuple(int(d) for d in attrs['elem_shape'])
        data = torch.zeros((cap,) + shape, device=ctx.device,
                           dtype=datatypes.as_torch_dtype(dtype))
        return out(TArray(data, _size(0, ctx.device)))
    return out(EmptyTArray(dtype))


@register_op('write_to_array')
def _write_to_array(ctx, ins, attrs):
    arr = first(ins, 'X' if 'X' in ins else 'Array')
    x = first(ins, 'V' if 'V' in ins else 'X')
    i = _as_index(first(ins, 'I'))
    if isinstance(arr, EmptyTArray):
        cap = int(attrs.get('capacity', DEFAULT_CAPACITY))
        arr = TArray(x.new_zeros((cap,) + tuple(x.shape)),
                     _size(0, x.device))
    elif not isinstance(arr, TArray):
        raise TypeError("write_to_array target is not a tensor array")
    if tuple(x.shape) != tuple(arr.data.shape[1:]):
        raise ValueError(
            "write_to_array shape %s != array element shape %s" %
            (tuple(x.shape), tuple(arr.data.shape[1:])))
    data = arr.data.index_copy(0, _slot(arr, i),
                               x.to(arr.data.dtype).unsqueeze(0))
    return out(TArray(data, torch.maximum(arr.size, i + 1)))


@register_op('read_from_array')
def _read_from_array(ctx, ins, attrs):
    arr = first(ins, 'X' if 'X' in ins else 'Array')
    i = _as_index(first(ins, 'I'))
    return out(arr.data.index_select(0, _slot(arr, i)).squeeze(0))


@register_op('array_length')
def _array_length(ctx, ins, attrs):
    arr = first(ins, 'X')
    return out(arr.size.reshape(1).to(torch.int32))


@register_op('lod_tensor_to_array')
def _lod_tensor_to_array(ctx, ins, attrs):
    """Padded [B, T, ...] as a T-entry array of [B, ...] steps.  The
    reference keeps the batch dense too (entry t is step t of every row;
    masks stand for the rank table's shrinking)."""
    x = first(ins, 'X')
    return out(TArray(x.movedim(1, 0), _size(x.shape[1], x.device)))


@register_op('array_to_lod_tensor')
def _array_to_lod_tensor(ctx, ins, attrs):
    arr = first(ins, 'X')
    if not isinstance(arr, TArray):
        raise TypeError("array_to_lod_tensor reads a tensor array")
    return out(arr.data.movedim(0, 1))   # [B, T, ...]


@register_op('lod_rank_table')
def _lod_rank_table(ctx, ins, attrs):
    """The lengths vector stands for the rank table (no reordering: masks
    replace the batch shrinking); full rows without lengths."""
    x = first(ins, 'X')
    ln = first(ins, 'XLen')
    if ln is None:
        ln = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                        device=x.device)
    return out(ln.to(torch.int32))


@register_op('max_sequence_len')
def _max_sequence_len(ctx, ins, attrs):
    table = first(ins, 'RankTable')
    return out(table.max().reshape(1).to(torch.int32))


@register_op('shrink_rnn_memory')
def _shrink_rnn_memory(ctx, ins, attrs):
    """The reference drops finished sequences' rows at step I; on the dense
    batch their memory rows are zeroed."""
    x = first(ins, 'X')
    table = first(ins, 'RankTable')
    i = _as_index(first(ins, 'I'))
    active = table > i
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return out(torch.where(active.reshape(shape), x, torch.zeros_like(x)))

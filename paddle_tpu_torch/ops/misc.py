"""Misc ops: print, is_empty, split_lod_tensor, merge_lod_tensor.

Reference parity: paddle_tpu/ops/misc.py (paddle/operators/print_op.cc,
is_empty_op.cc, split_lod_tensor_op.cc, merge_lod_tensor_op.cc).
``get_places`` comes with ``parallel_do`` (ROADMAP.md Queue 1 item 10).
"""
import torch

from ..core.registry import register_op
from .common import first, out

__all__ = []


@register_op('print')
def _print(ctx, ins, attrs):
    """Prints the message and the value (a host read: a debugging op);
    shape inference, on meta tensors, prints nothing."""
    x = first(ins, 'In')
    if x.device.type != 'meta':
        msg = attrs.get('message') or ''
        print(msg + str(x.detach().cpu().numpy()))
    return out(x)


@register_op('is_empty')
def _is_empty(ctx, ins, attrs):
    x = first(ins, 'X')
    return out(torch.tensor([x.numel() == 0], device=x.device))


def _row_mask(mask, x):
    m = mask.reshape(-1).bool()
    return m.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


@register_op('split_lod_tensor')
def _split_lod_tensor(ctx, ins, attrs):
    """Dense split: both outputs keep the whole batch, the rows outside
    each half zeroed; merge selects by row, so merge(split(x)) is x."""
    x = first(ins, 'X')
    m = _row_mask(first(ins, 'Mask'), x)
    zero = torch.zeros_like(x)
    return {'OutTrue': [torch.where(m, x, zero)],
            'OutFalse': [torch.where(m, zero, x)]}


@register_op('merge_lod_tensor')
def _merge_lod_tensor(ctx, ins, attrs):
    # X carries fluid's row layout; the dense merge selects by row from
    # the two halves, which keep X's shape
    x = first(ins, 'X')   # noqa: F841
    in_true = first(ins, 'InTrue')
    in_false = first(ins, 'InFalse')
    m = _row_mask(first(ins, 'Mask'), in_true)
    return out(torch.where(m, in_true, in_false))

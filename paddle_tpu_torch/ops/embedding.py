"""Embedding lookup and sparse-gradient assembly.

Reference parity: paddle_tpu/ops/embedding.py (paddle/operators/
lookup_table_op).  A dense lookup's gradient is autograd's scatter into a
table-sized gradient.  With ``is_sparse`` the backward differentiates with
respect to the lookup's output instead (core/backward.py), and
``sparse_grad_assemble`` packs the ids and the output's gradient into a
``SelectedRows``, which the optimizer ops apply row by row
(ops/optim_ops.py): the vocab-height dense gradient never exists.
"""
import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import first, out


def _flat_ids(ids):
    ids = ids.long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids


def _resolve_pad(pad, height):
    """fluid's padding_idx: a negative index counts from the declared
    table height."""
    return height + pad if pad < 0 else pad


@register_op('lookup_table')
def _lookup_table(ctx, ins, attrs):
    w = first(ins, 'W')
    if int(attrs.get('embed_ways') or 0) > 1:
        raise NotImplementedError(
            "row-sharded embedding tables (embed_ways > 1) come with the "
            "multi-chip slice: ROADMAP.md Queue 1 item 10")
    ids = _flat_ids(first(ins, 'Ids'))
    y = w[ids]
    pad = attrs.get('padding_idx', None)
    if pad is not None:
        pad = _resolve_pad(pad, int(attrs.get('height', w.shape[0])))
        y = torch.where((ids != pad)[..., None], y, torch.zeros_like(y))
    return out(y)


@register_op('sparse_grad_assemble')
def _sparse_grad_assemble(ctx, ins, attrs):
    """Pack every (Ids, OutGrad) pair of one table into a single
    SelectedRows of height ``height``.  Values at ``padding_idx`` rows are
    zeroed and the rows kept, so a lazy optimizer touches only the padding
    row, never a real vocabulary entry."""
    height = int(attrs['height'])
    pad = attrs.get('padding_idx', None)
    rows_list, vals_list = [], []
    for ids, g in zip(ins['Ids'], ins['OutGrad']):
        rows = _flat_ids(ids).reshape(-1)
        vals = g.float().reshape(-1, g.shape[-1])
        if pad is not None:
            vals = torch.where((rows != _resolve_pad(pad, height))[:, None],
                               vals, torch.zeros_like(vals))
        rows_list.append(rows)
        vals_list.append(vals)
    return out(SelectedRows(torch.cat(rows_list).int(),
                            torch.cat(vals_list), height))

"""Embedding lookup (paddle_tpu/ops/embedding.py ``lookup_table``).

The gradient is dense: autograd scatters the output cotangent into a
table-sized gradient.  The row-sparse gradient of ``is_sparse`` lookups
comes with the sparse CTR slice (core/backward.py raises for it).
"""
import torch

from ..core.registry import register_op
from .common import first, out


@register_op('lookup_table')
def _lookup_table(ctx, ins, attrs):
    w = first(ins, 'W')
    ids = first(ins, 'Ids').long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    y = w[ids]
    pad = attrs.get('padding_idx', None)
    if pad is not None:
        if pad < 0:   # fluid: -1 is row height - 1 of the declared table
            pad = int(attrs.get('height', w.shape[0])) + pad
        y = torch.where((ids != pad)[..., None], y, torch.zeros_like(y))
    return out(y)

"""Metric ops (paddle_tpu/ops/metrics.py), cut to ``accuracy``."""
import torch

from ..core.registry import register_op
from .common import first


@register_op('accuracy')
def _accuracy(ctx, ins, attrs):
    """Share of rows whose int label is among the top-k ``Indices`` (from
    a top_k op); also the counts Correct and Total."""
    idx = first(ins, 'Indices').to(torch.int32)
    label = first(ins, 'Label').to(torch.int32)
    if label.dim() == 2 and label.shape[1] == 1:
        label = label[:, 0]
    hit = (idx == label[:, None]).any(dim=1)
    total = torch.full((1,), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    correct = hit.sum().to(torch.int32).reshape(1)
    acc = correct.float() / total.float()
    return {'Accuracy': [acc], 'Correct': [correct], 'Total': [total]}

"""Metric ops (paddle_tpu/ops/metrics.py), cut to ``accuracy`` and
``auc``."""
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


@register_op('auc')
def _auc(ctx, ins, attrs):
    """The batch's ROC AUC over ``num_thresholds`` thresholds (auc_op.h's
    200), with no streaming state: the score is column 1 of a two-column
    probability input (else the input flattened), each threshold's true
    and false positive rates come from counts, and the area is the
    trapezoid over the thresholds in decreasing order.  Not
    differentiable."""
    probs = first(ins, 'Out').float()
    label = first(ins, 'Label').to(torch.int32).reshape(-1)
    if probs.dim() == 2 and probs.shape[1] == 2:
        score = probs[:, 1]
    else:
        score = probs.reshape(-1)
    num_t = int(attrs.get('num_thresholds', 200))
    thresholds = (torch.arange(num_t, dtype=torch.float32,
                               device=probs.device) + 0.5) / num_t
    pos = label == 1
    above = score[None, :] >= thresholds[:, None]
    tp = (above & pos[None, :]).sum(dim=1).float()
    fp = (above & ~pos[None, :]).sum(dim=1).float()
    npos = torch.clamp(pos.sum().float(), min=1e-6)
    nneg = torch.clamp((~pos).sum().float(), min=1e-6)
    auc = -torch.trapezoid(tp / npos, fp / nneg)
    return {'AUC': [auc.abs().reshape(1)]}

"""Loss ops (paddle_tpu/ops/loss.py), cut to ``cross_entropy``,
``softmax_with_cross_entropy``, ``square_error_cost`` and
``sigmoid_cross_entropy_with_logits``; computed in float32."""
import torch

from ..core.registry import register_op
from .common import first


def _label_idx(label):
    lab = label.long()
    if lab.dim() >= 2 and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    return lab


@register_op('cross_entropy')
def _cross_entropy(ctx, ins, attrs):
    """-log(p[label] + 1e-12) of probabilities X [N, D] against int labels
    [N, 1]; with ``soft_label`` the label rows are distributions."""
    x = first(ins, 'X').float()
    label = first(ins, 'Label')
    if attrs.get('soft_label', False):
        y = -(label.float() * torch.log(x + 1e-12)).sum(dim=-1,
                                                         keepdim=True)
    else:
        p = torch.gather(x, -1, _label_idx(label)[..., None])
        y = -torch.log(p + 1e-12)
    return {'Y': [y]}


@register_op('softmax_with_cross_entropy')
def _softmax_with_ce(ctx, ins, attrs):
    """-log_softmax(Logits)[label] per row, and the softmax itself
    (operators/softmax_with_cross_entropy_op); soft labels weigh every
    class."""
    logits = first(ins, 'Logits').float()
    label = first(ins, 'Label')
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get('soft_label', False):
        loss = -(label.float() * logp).sum(dim=-1, keepdim=True)
    else:
        loss = -torch.gather(logp, -1, _label_idx(label)[..., None])
    return {'Loss': [loss], 'Softmax': [torch.exp(logp)]}


@register_op('square_error_cost')
def _square_error_cost(ctx, ins, attrs):
    """(X - Y)^2 elementwise (operators/squared_l2_distance_op)."""
    x = first(ins, 'X').float()
    return {'Out': [torch.square(x - first(ins, 'Y').float())]}


@register_op('sigmoid_cross_entropy_with_logits')
def _sigmoid_ce(ctx, ins, attrs):
    """Elementwise max(x, 0) - x * label + log1p(exp(-|x|)) of logits X
    against labels of X's shape, in float32 (the reference's
    ``_sigmoid_ce``, paddle_tpu/ops/loss.py:50)."""
    x = first(ins, 'X').float()
    label = first(ins, 'Label').float()
    return {'Out': [torch.maximum(x, torch.zeros_like(x)) - x * label +
                    torch.log1p(torch.exp(-torch.abs(x)))]}

"""Loss ops (paddle_tpu/ops/loss.py): ``cross_entropy``,
``softmax_with_cross_entropy``, ``square_error_cost``,
``sigmoid_cross_entropy_with_logits``, ``smooth_l1`` (also registered as
``smooth_l1_loss``), ``hinge_loss``, ``huber_loss``, ``log_loss``,
``rank_loss``, ``margin_rank_loss``, ``modified_huber_loss`` and ``nce``;
computed in float32, every output slot of the reference's included.

The hinges are ``torch.maximum(0, .)``: at the hinge the cotangent splits
0.5 / 0.5, as ``jnp.maximum`` splits it; ``abs_`` has ``jnp.abs``'s
derivative of 1 at 0.  ``nce`` draws its negatives from the op's
generator (uniform over ``num_total_classes``); the cost given the
samples is ``nce_cost``, which tests feed the reference's draws.
"""
import math

import torch

from ..core.registry import register_op
from .activations import abs_
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
    ``_sigmoid_ce``, paddle_tpu/ops/loss.py:50), with its gradient at
    x = 0 too: the maximum's tie passes half, and |x| has slope 1."""
    x = first(ins, 'X').float()
    label = first(ins, 'Label').float()
    return {'Out': [torch.maximum(x, torch.zeros_like(x)) - x * label +
                    torch.log1p(torch.exp(-abs_(x)))]}


@register_op('smooth_l1')
def _smooth_l1(ctx, ins, attrs):
    """Per-sample sum of the smooth L1 of (X - Y) * InsideWeight (times
    OutsideWeight), quadratic below 1 / sigma^2; ``Diff`` is the
    weighted difference (operators/smooth_l1_loss_op)."""
    x = first(ins, 'X').float()
    y = first(ins, 'Y').float()
    sigma = attrs.get('sigma', 1.0)
    s2 = sigma * sigma
    diff = x - y
    iw = first(ins, 'InsideWeight')
    if iw is not None:
        diff = diff * iw
    ad = abs_(diff)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff,
                       ad - 0.5 / s2)
    ow = first(ins, 'OutsideWeight')
    if ow is not None:
        elem = elem * ow
    loss = elem.reshape(x.shape[0], -1).sum(dim=1, keepdim=True)
    return {'Out': [loss], 'Diff': [diff]}


register_op('smooth_l1_loss')(_smooth_l1)


def _hinge_at_zero(v):
    return torch.maximum(v.new_zeros(()), v)


@register_op('hinge_loss')
def _hinge(ctx, ins, attrs):
    logits = first(ins, 'Logits').float()
    labels = first(ins, 'Labels').float()
    return {'Loss': [_hinge_at_zero(1.0 - (2 * labels - 1) * logits)]}


@register_op('huber_loss')
def _huber(ctx, ins, attrs):
    """Huber loss of the residual Y - X, quadratic up to ``delta``."""
    x = first(ins, 'X').float()
    y = first(ins, 'Y').float()
    delta = attrs.get('delta', 1.0)
    r = y - x
    ar = abs_(r)
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {'Out': [loss], 'Residual': [r]}


@register_op('log_loss')
def _log_loss(ctx, ins, attrs):
    p = first(ins, 'Predicted').float()
    label = first(ins, 'Labels').float()
    eps = attrs.get('epsilon', 1e-4)
    return {'Loss': [-label * torch.log(p + eps) -
                     (1 - label) * torch.log(1 - p + eps)]}


@register_op('rank_loss')
def _rank_loss(ctx, ins, attrs):
    """log(1 + exp(Left - Right)) - Label * (Left - Right)."""
    label = first(ins, 'Label').float()
    d = first(ins, 'Left').float() - first(ins, 'Right').float()
    return {'Out': [torch.log1p(torch.exp(d)) - label * d]}


@register_op('margin_rank_loss')
def _margin_rank_loss(ctx, ins, attrs):
    """max(0, -Label * (X1 - X2) + margin), and ``Activated``, where it
    is above 0, as float32."""
    label = first(ins, 'Label').float()
    x1 = first(ins, 'X1').float()
    x2 = first(ins, 'X2').float()
    act = _hinge_at_zero(-label * (x1 - x2) + attrs.get('margin', 0.0))
    return {'Out': [act], 'Activated': [(act > 0).float()]}


@register_op('modified_huber_loss')
def _modified_huber(ctx, ins, attrs):
    """With a = (2Y - 1) X: -4a below -1, (1 - a)^2 below 1, else 0;
    ``IntermediateVal`` is a."""
    x = first(ins, 'X').float()
    y = first(ins, 'Y').float()
    a = (2 * y - 1) * x
    loss = torch.where(a < -1, -4 * a,
                       torch.where(a < 1, torch.square(1 - a),
                                   torch.zeros_like(a)))
    return {'Out': [loss], 'IntermediateVal': [a]}


def nce_cost(x, w, b, samples, num_true, num_neg, num_classes):
    """(Cost [N, 1], SampleLogits [N, T + S]) of ``nce`` given its samples
    [N, T + S]: the true labels first, then the negatives."""
    logits = torch.einsum('nd,nsd->ns', x, w[samples])
    if b is not None:
        logits = logits + b.float()[samples]
    log_p_noise = math.log(num_neg / float(num_classes))
    pos = torch.log1p(torch.exp(-(logits[:, :num_true] - log_p_noise)))
    neg = torch.log1p(torch.exp(logits[:, num_true:] - log_p_noise))
    cost = pos.sum(dim=1, keepdim=True) + neg.sum(dim=1, keepdim=True)
    return cost, logits


@register_op('nce')
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation (operators/nce_op) with uniform noise:
    ``num_neg_samples`` negatives a row, drawn on X's device from the
    op's generator, scored against Input [N, D] with Weight [classes, D]
    and Bias [classes]."""
    x = first(ins, 'Input').float()
    label = _label_idx(first(ins, 'Label'))
    w = first(ins, 'Weight').float()
    b = first(ins, 'Bias')
    num_neg = attrs.get('num_neg_samples', 10)
    num_classes = attrs.get('num_total_classes', w.shape[0])
    if label.dim() == 1:
        label = label[:, None]
    neg = torch.randint(0, num_classes, (x.shape[0], num_neg),
                        device=x.device, generator=ctx.generator())
    samples = torch.cat([label, neg], dim=1)
    cost, logits = nce_cost(x, w, b, samples, label.shape[1], num_neg,
                            num_classes)
    return {'Cost': [cost], 'SampleLogits': [logits],
            'SampleLabels': [samples.to(torch.int32)]}

"""Optimizer update ops: sgd, momentum, adam and adagrad, dense and
row-sparse; adamax, decayed_adagrad, adadelta, rmsprop, ftrl,
proximal_gd and proximal_adagrad, dense.

Reference parity: paddle_tpu/ops/optim_ops.py ``_sgd`` :120,
``_momentum`` :160, ``_adam`` :182, ``_adagrad`` :258 (paddle/operators/
{sgd,momentum,adam,adagrad}_op).  Dense gradients: sgd, momentum and adam
apply their rule through ops/kernels/dense_update.py, which updates param
and moments in place (the kernel on the card, the plain version on the
CPU); the reference has no Pallas rule for dense adagrad, so it stays torch
ops, in place, in the reference's order of operations.

Row-sparse gradients arrive as a ``SelectedRows`` (or a raw (rows, values)
pair).  sgd, adagrad and adam apply them row by row through
ops/kernels/table_update.py (the kernel on the card, its plain version on
the CPU); a table of rank other than 2 goes through it as a [height, -1]
view, so the update stays in place.  sgd accumulates duplicates; adagrad
and adam merge them first, and adam is lazy: its moments decay only on
touched rows.  momentum densifies the sparse gradient
(``_sparse_to_update``).  A row-sharded table (``embed_ways`` > 1) raises.

The other seven rules (paddle_tpu/ops/optim_ops.py ``_adamax`` :240,
``_decayed_adagrad`` :290, ``_adadelta`` :303, ``_rmsprop`` :320,
``_ftrl`` :336, ``_proximal_gd`` :355, ``_proximal_adagrad`` :368) are
torch ops in the reference's order of operations, as the reference
computes them in XLA with no Pallas rule; a sparse gradient is densified
first (``_sparse_to_update``), as the reference's are.  Each computes
its new values in float32 and writes them into the state tensors.

The outputs are the same tensors as the inputs, so the executor's scope
keeps its buffers.
"""
import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import first
from .kernels import dense_update, table_update


def _as_sparse(grad):
    """(rows, float32 values) of a sparse gradient, or None if dense."""
    if isinstance(grad, SelectedRows):
        return grad.rows.reshape(-1), grad.values.float()
    if isinstance(grad, tuple):
        rows, values = grad
        return rows.reshape(-1), values.float()
    return None


def _rows2d(op, attrs, values, *tables):
    """The tables as [height, -1] views (in place) and the values as
    [K, -1], the row-wise rule's operands."""
    if int(attrs.get('embed_ways') or 0) > 1:
        raise NotImplementedError(
            "%s on a row-sharded table (embed_ways > 1) comes with the "
            "multi-chip slice: ROADMAP.md Queue 1 item 10" % op)
    return ([t.view(t.shape[0], -1) for t in tables] +
            [values.reshape(values.shape[0], -1)])


def _sparse_to_update(param, grad):
    """A sparse gradient densified by scatter-add (optimizers without a
    row-wise rule), or the dense gradient as float32."""
    sp = _as_sparse(grad)
    if sp is None:
        return grad.float().contiguous()
    rows, values = sp
    return SelectedRows(rows, values, param.shape[0]).to_dense().reshape(
        param.shape).contiguous()


def _lr(ins, slot='LearningRate'):
    return first(ins, slot).float().reshape(1)


@register_op('sgd')
def _sgd(ctx, ins, attrs):
    p = first(ins, 'Param')
    grad = first(ins, 'Grad')
    lr = _lr(ins)
    sp = _as_sparse(grad)
    if sp is not None:
        rows, values = sp
        p2, v2 = _rows2d('sgd', attrs, values, p)
        table_update.sparse_apply_sgd(p2, rows, v2, lr)
        return {'ParamOut': [p]}
    wd = attrs.get('weight_decay', 0.0)
    return {'ParamOut': [dense_update.dense_apply_sgd(
        p, grad.float().contiguous(), lr, weight_decay=wd or None)]}


@register_op('momentum')
def _momentum(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _sparse_to_update(p, first(ins, 'Grad'))
    p, v = dense_update.dense_apply_momentum(
        p, first(ins, 'Velocity'), g, _lr(ins), attrs.get('mu', 0.9),
        use_nesterov=attrs.get('use_nesterov', False))
    return {'ParamOut': [p], 'VelocityOut': [v]}


@register_op('adam')
def _adam(ctx, ins, attrs):
    p = first(ins, 'Param')
    m, v = first(ins, 'Moment1'), first(ins, 'Moment2')
    grad = first(ins, 'Grad')
    lr = _lr(ins)
    b1p = first(ins, 'Beta1Pow').float().reshape(1)
    b2p = first(ins, 'Beta2Pow').float().reshape(1)
    b1 = attrs.get('beta1', 0.9)
    b2 = attrs.get('beta2', 0.999)
    eps = attrs.get('epsilon', 1e-8)
    # the bias-corrected rate stays on the device: no host sync
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    sp = _as_sparse(grad)
    if sp is None:
        p, m, v = dense_update.dense_apply_adam(
            p, m, v, grad.float().contiguous(), lr_t, b1, b2, eps)
    else:
        p2, m2, v2, g2 = _rows2d('adam', attrs, sp[1], p, m, v)
        table_update.sparse_apply_adam(p2, m2, v2, sp[0], g2, lr_t, b1, b2,
                                       eps)
    return {'ParamOut': [p], 'Moment1Out': [m], 'Moment2Out': [v]}


@register_op('adagrad')
def _adagrad(ctx, ins, attrs):
    """moment += g^2; param -= lr * g / (sqrt(moment) + epsilon), on every
    element (dense) or on the merged touched rows (sparse)."""
    p = first(ins, 'Param')
    grad = first(ins, 'Grad')
    mom = first(ins, 'Moment')
    eps = attrs.get('epsilon', 1e-6)
    lr = _lr(ins)
    sp = _as_sparse(grad)
    if sp is None:
        g = grad.float().contiguous()
        mom.add_(torch.square(g))
        p.sub_(lr * g / (torch.sqrt(mom) + eps))
    else:
        p2, mom2, g2 = _rows2d('adagrad', attrs, sp[1], p, mom)
        table_update.sparse_apply_adagrad(p2, mom2, sp[0], g2, lr, eps)
    return {'ParamOut': [p], 'MomentOut': [mom]}


def _write(dst, value):
    """``value`` into the state tensor ``dst`` in place (cast to its
    dtype; a 0-d state from the [1] its rate broadcast to, as the [1]
    rates broadcast where the reference reshapes them to 0-d); returns
    ``dst``."""
    return dst.copy_(value.reshape(dst.shape))


@register_op('adamax')
def _adamax(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _sparse_to_update(p, first(ins, 'Grad'))
    m, u = first(ins, 'Moment'), first(ins, 'InfNorm')
    lr = first(ins, 'LearningRate').float()
    b1p = first(ins, 'Beta1Pow').float()
    b1 = attrs.get('beta1', 0.9)
    b2 = attrs.get('beta2', 0.999)
    eps = attrs.get('epsilon', 1e-8)
    m_new = b1 * m.float() + (1 - b1) * g
    u_new = torch.maximum(b2 * u.float(), torch.abs(g))
    p_new = p.float() - (lr / (1 - b1p)) * m_new / (u_new + eps)
    return {'ParamOut': [_write(p, p_new)], 'MomentOut': [_write(m, m_new)],
            'InfNormOut': [_write(u, u_new)]}


@register_op('decayed_adagrad')
def _decayed_adagrad(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _sparse_to_update(p, first(ins, 'Grad'))
    mom = first(ins, 'Moment')
    lr = first(ins, 'LearningRate').float()
    decay = attrs.get('decay', 0.95)
    eps = attrs.get('epsilon', 1e-6)
    mom_new = decay * mom.float() + (1 - decay) * torch.square(g)
    p_new = p.float() - lr * g / (torch.sqrt(mom_new) + eps)
    return {'ParamOut': [_write(p, p_new)],
            'MomentOut': [_write(mom, mom_new)]}


@register_op('adadelta')
def _adadelta(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _sparse_to_update(p, first(ins, 'Grad'))
    asg, asu = first(ins, 'AvgSquaredGrad'), first(ins, 'AvgSquaredUpdate')
    rho = attrs.get('rho', 0.95)
    eps = attrs.get('epsilon', 1e-6)
    asg_new = rho * asg.float() + (1 - rho) * torch.square(g)
    update = -torch.sqrt((asu.float() + eps) / (asg_new + eps)) * g
    asu_new = rho * asu.float() + (1 - rho) * torch.square(update)
    return {'ParamOut': [_write(p, p.float() + update)],
            'AvgSquaredGradOut': [_write(asg, asg_new)],
            'AvgSquaredUpdateOut': [_write(asu, asu_new)]}


@register_op('rmsprop')
def _rmsprop(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _sparse_to_update(p, first(ins, 'Grad'))
    ms, mom = first(ins, 'MeanSquare'), first(ins, 'Moment')
    lr = first(ins, 'LearningRate').float()
    decay = attrs.get('decay', 0.9)
    mu = attrs.get('momentum', 0.0)
    eps = attrs.get('epsilon', 1e-10)
    ms_new = decay * ms.float() + (1 - decay) * torch.square(g)
    mom_new = mu * mom.float() + lr * g / torch.sqrt(ms_new + eps)
    return {'ParamOut': [_write(p, p.float() - mom_new)],
            'MeanSquareOut': [_write(ms, ms_new)],
            'MomentOut': [_write(mom, mom_new)]}


@register_op('ftrl')
def _ftrl(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _sparse_to_update(p, first(ins, 'Grad'))
    sq = first(ins, 'SquaredAccumulator')
    lin = first(ins, 'LinearAccumulator')
    lr = first(ins, 'LearningRate').float()
    l1 = attrs.get('l1', 0.0)
    l2 = attrs.get('l2', 0.0)
    lr_power = attrs.get('lr_power', -0.5)
    sq32 = sq.float()
    new_sq = sq32 + torch.square(g)
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq32, -lr_power)) / lr
    new_lin = lin.float() + g - sigma * p.float()
    x = torch.clamp(new_lin, -l1, l1) - new_lin
    y = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    return {'ParamOut': [_write(p, x / y)],
            'SquaredAccumOut': [_write(sq, new_sq)],
            'LinearAccumOut': [_write(lin, new_lin)]}


def _proximal(prox, lr, l1, l2):
    """sign(prox) * max(|prox| - lr * l1, 0) / (1 + lr * l2)."""
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                          min=0.0) / (1.0 + lr * l2)


@register_op('proximal_gd')
def _proximal_gd(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _sparse_to_update(p, first(ins, 'Grad'))
    lr = first(ins, 'LearningRate').float()
    p_new = _proximal(p.float() - lr * g, lr, attrs.get('l1', 0.0),
                      attrs.get('l2', 0.0))
    return {'ParamOut': [_write(p, p_new)]}


@register_op('proximal_adagrad')
def _proximal_adagrad(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _sparse_to_update(p, first(ins, 'Grad'))
    mom = first(ins, 'Moment')
    lr = first(ins, 'LearningRate').float()
    mom_new = mom.float() + torch.square(g)
    lr_t = lr / torch.sqrt(mom_new)
    p_new = _proximal(p.float() - lr_t * g, lr_t, attrs.get('l1', 0.0),
                      attrs.get('l2', 0.0))
    return {'ParamOut': [_write(p, p_new)],
            'MomentOut': [_write(mom, mom_new)]}

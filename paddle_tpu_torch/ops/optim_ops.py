"""Optimizer update ops: sgd, momentum, adam and adagrad, dense and
row-sparse.

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

"""Optimizer update ops: the dense branches of sgd, momentum and adam.

Reference parity: paddle_tpu/ops/optim_ops.py ``_sgd`` :120,
``_momentum`` :160, ``_adam`` :182 (paddle/operators/{sgd,momentum,
adam}_op).  Each op applies its rule through ops/kernels/dense_update.py,
which updates param and moments in place: the kernel on the card, the
plain version on the CPU.  The outputs are the same tensors as the
inputs, so the executor's scope keeps its buffers.

Row-sparse (SelectedRows) gradients come with the sparse CTR slice.
"""
import torch

from ..core.registry import register_op
from .common import first
from .kernels import dense_update


def _dense_grad(op, grad):
    if not torch.is_tensor(grad):
        raise NotImplementedError(
            "%s with a row-sparse (SelectedRows) gradient is not ported "
            "yet: ROADMAP.md Queue 1, the sparse CTR slice" % op)
    return grad.float().contiguous()


def _lr(ins, slot='LearningRate'):
    return first(ins, slot).float().reshape(1)


@register_op('sgd')
def _sgd(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _dense_grad('sgd', first(ins, 'Grad'))
    wd = attrs.get('weight_decay', 0.0)
    return {'ParamOut': [dense_update.dense_apply_sgd(
        p, g, _lr(ins), weight_decay=wd or None)]}


@register_op('momentum')
def _momentum(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _dense_grad('momentum', first(ins, 'Grad'))
    p, v = dense_update.dense_apply_momentum(
        p, first(ins, 'Velocity'), g, _lr(ins), attrs.get('mu', 0.9),
        use_nesterov=attrs.get('use_nesterov', False))
    return {'ParamOut': [p], 'VelocityOut': [v]}


@register_op('adam')
def _adam(ctx, ins, attrs):
    p = first(ins, 'Param')
    g = _dense_grad('adam', first(ins, 'Grad'))
    lr = _lr(ins)
    b1p = first(ins, 'Beta1Pow').float().reshape(1)
    b2p = first(ins, 'Beta2Pow').float().reshape(1)
    # the bias-corrected rate stays on the device: no host sync
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p, m, v = dense_update.dense_apply_adam(
        p, first(ins, 'Moment1'), first(ins, 'Moment2'), g, lr_t,
        attrs.get('beta1', 0.9), attrs.get('beta2', 0.999),
        attrs.get('epsilon', 1e-8))
    return {'ParamOut': [p], 'Moment1Out': [m], 'Moment2Out': [v]}

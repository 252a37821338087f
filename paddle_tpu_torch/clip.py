"""Gradient and error clipping.

Reference parity: paddle_tpu/clip.py (fluid clip.py): GradientClipByValue,
ByNorm and ByGlobalNorm append ops over the gradients (after the
``autodiff`` op, before the regularizers); ErrorClipByValue weaves no op:
the executor clips the cotangent that reaches the variable it guards
(core/executor.py ``_ClipCotangent``), as the reference's executor does.
"""
import functools

from .core.program import grad_var_name

__all__ = [
    'BaseErrorClipAttr', 'ErrorClipByValue', 'error_clip_callback',
    'BaseGradientClipAttr', 'NullGradientClipAttr', 'GradientClipByValue',
    'GradientClipByNorm', 'GradientClipByGlobalNorm',
    'append_gradient_clip_ops', 'set_gradient_clip',
]


class BaseErrorClipAttr(object):
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clip the gradient reaching a variable to [min, max] (min defaults
    to -max); set as ``var.error_clip``."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def append_clip_op(self, block, grad_name):
        block.append_op(type='clip', inputs={'X': [grad_name]},
                        outputs={'Out': [grad_name]},
                        attrs={'min': self.min, 'max': self.max})


def error_clip_callback(block, context):
    """fluid's backward callback; ``append_backward`` takes it and leaves
    the clip to the executor."""
    for var_name, var in list(block.vars.items()):
        error_clip = getattr(var, 'error_clip', None)
        if error_clip is not None:
            error_clip.append_clip_op(block, grad_var_name(var_name))


class BaseGradientClipAttr(object):
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient entry clipped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def create_operators(self, param, grad):
        from .layers import ops as layer_ops
        return param, layer_ops.clip(x=grad, min=self.min, max=self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def create_operators(self, param, grad):
        from .layers import ops as layer_ops
        return param, layer_ops.clip_by_norm(x=grad,
                                             max_norm=self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient of a group scaled by clip / max(clip, global norm),
    the global norm the square root of the summed squares of all of them
    (``reduce_sum`` of ``square`` each, ``sums``, ``sqrt``)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name
        self.context = None

    def process_context(self, context, param, grad):
        from .layers import nn as layer_nn
        from .layers import ops as layer_ops
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        context[self.group_name].append(
            layer_nn.reduce_sum(input=layer_ops.square(x=grad)))
        self.context = context

    def create_operators(self, param, grad):
        from .layers import ops as layer_ops
        from .layers import tensor as layer_tensor
        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm = layer_tensor.sums(self.context[self.group_name])
            group_norm = layer_ops.sqrt(x=group_norm)
            clip_var = layer_tensor.fill_constant(
                shape=[1], dtype='float32', value=self.clip_norm)
            self.context[group_scale_name] = layer_ops.elementwise_div(
                x=clip_var,
                y=layer_ops.elementwise_max(x=clip_var, y=group_norm))
        return param, layer_ops.elementwise_mul(
            x=grad, y=self.context[group_scale_name])


_gradient_clip_attr = None


def set_gradient_clip(clip, param_list=None, program=None):
    """``clip`` for the parameters of ``param_list``, or for every
    parameter without one of its own (None clears it)."""
    global _gradient_clip_attr
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip
    else:
        _gradient_clip_attr = clip


def current_gradient_clip():
    """The program-wide clip set by ``set_gradient_clip``, or None."""
    return _gradient_clip_attr


def append_gradient_clip_ops(param_grad):
    """[(param, grad)] -> [(param, clipped grad)]: every clip sees every
    gradient of its group before any clipped one is built."""
    context = {}
    create_op_callbacks = []
    for p, g in param_grad:
        clip_attr = getattr(p, 'gradient_clip_attr', None) or \
            _gradient_clip_attr or NullGradientClipAttr()
        clip_attr.process_context(context=context, param=p, grad=g)
        create_op_callbacks.append(
            functools.partial(clip_attr.create_operators, param=p, grad=g))
    return [each_callback() for each_callback in create_op_callbacks]

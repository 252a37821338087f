"""Plain one-op layers (paddle_tpu/layers/ops.py), cut to relu, softmax,
mean, elementwise_add and scale."""
from .layer_helper import LayerHelper

__all__ = ['relu', 'softmax', 'mean', 'elementwise_add', 'scale']


def _unary(op_type, reduction=False):
    """An elementwise layer keeps a ragged input's lod and ``@LEN``; a
    reduction (mean) takes the lengths, to average the real elements
    only."""
    def _layer(x=None, **kwargs):
        if x is None:
            x = kwargs.pop('input', None) or kwargs.pop('X')
        helper = LayerHelper(op_type, **kwargs)
        out = helper.create_tmp_variable(
            dtype=x.dtype, lod_level=0 if reduction else x.lod_level)
        inputs = {'X': [x]}
        if reduction:
            from .sequence import _len_input
            inputs.update(_len_input(helper, x))
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={'Out': [out]},
                         attrs=kwargs.get('attrs', {}))
        if not reduction:
            helper.copy_len(x, out)
        return out

    _layer.__name__ = op_type
    return _layer


relu = _unary('relu')
softmax = _unary('softmax')
mean = _unary('mean', reduction=True)


def elementwise_add(x=None, y=None, axis=-1, act=None, **kwargs):
    if x is None:
        x = kwargs.pop('X')
    if y is None:
        y = kwargs.pop('Y')
    helper = LayerHelper('elementwise_add', **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    attrs = {'axis': axis}
    attrs.update(kwargs.get('attrs', {}))
    helper.append_op(type='elementwise_add', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs=attrs)
    if act is not None:
        helper.kwargs['act'] = act
        return helper.append_activation(out)
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, **kwargs):
    helper = LayerHelper('scale', **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type='scale', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'scale': float(scale), 'bias': float(bias),
                            'bias_after_scale': bias_after_scale})
    return out

"""Plain one-op layers (paddle_tpu/layers/ops.py): the 28 activations,
mean, softmax and sign, the binary ones mul and
elementwise_{add,sub,mul,div,max,min,pow}, and scale, clip,
clip_by_norm and sigmoid_cross_entropy_with_logits."""
from .layer_helper import LayerHelper

__activations__ = [
    'sigmoid', 'logsigmoid', 'exp', 'relu', 'tanh', 'tanh_shrink',
    'softshrink', 'sqrt', 'abs', 'ceil', 'floor', 'round', 'reciprocal',
    'log', 'square', 'softplus', 'softsign', 'brelu', 'leaky_relu',
    'soft_relu', 'elu', 'relu6', 'pow', 'stanh', 'hard_shrink',
    'thresholded_relu', 'hard_sigmoid', 'swish',
]

__unary__ = __activations__ + ['mean', 'softmax', 'sign']

__binary__ = ['mul', 'elementwise_add', 'elementwise_div',
              'elementwise_sub', 'elementwise_mul', 'elementwise_max',
              'elementwise_min', 'elementwise_pow']

__all__ = __unary__ + __binary__ + ['scale', 'clip', 'clip_by_norm',
                                    'sigmoid_cross_entropy_with_logits']


def _unary(op_type, reduction=False):
    """An elementwise layer keeps a ragged input's lod and ``@LEN``; a
    reduction (mean) takes the lengths, to average the real elements
    only.  Op attrs (pow's ``factor``, leaky_relu's ``alpha``) come in
    ``attrs=``."""
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


def _binary(op_type):
    """X op Y with Y broadcast from ``axis``, then ``act``; ``mul`` takes
    its flattening attrs instead (``x_num_col_dims``, ``y_num_col_dims``)."""
    def _layer(x=None, y=None, axis=-1, act=None, **kwargs):
        if x is None:
            x = kwargs.pop('X')
        if y is None:
            y = kwargs.pop('Y')
        helper = LayerHelper(op_type, **kwargs)
        out = helper.create_tmp_variable(dtype=x.dtype)
        attrs = {'axis': axis}
        attrs.update(kwargs.get('attrs', {}))
        if op_type == 'mul':
            attrs = {'x_num_col_dims': kwargs.get('x_num_col_dims', 1),
                     'y_num_col_dims': kwargs.get('y_num_col_dims', 1)}
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [out]}, attrs=attrs)
        if act is not None:
            helper.kwargs['act'] = act
            return helper.append_activation(out)
        return out

    _layer.__name__ = op_type
    return _layer


for _op in __unary__:
    globals()[_op] = _unary(_op, reduction=_op == 'mean')

for _op in __binary__:
    globals()[_op] = _binary(_op)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, **kwargs):
    helper = LayerHelper('scale', **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type='scale', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'scale': float(scale), 'bias': float(bias),
                            'bias_after_scale': bias_after_scale})
    return out


def clip(x, min, max, **kwargs):
    helper = LayerHelper('clip', **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type='clip', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'min': float(min), 'max': float(max)})
    return out


def clip_by_norm(x, max_norm, **kwargs):
    helper = LayerHelper('clip_by_norm', **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type='clip_by_norm', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'max_norm': float(max_norm)})
    return out


def sigmoid_cross_entropy_with_logits(x, label, **kwargs):
    helper = LayerHelper('sigmoid_cross_entropy_with_logits', **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type='sigmoid_cross_entropy_with_logits',
                     inputs={'X': [x], 'Label': [label]},
                     outputs={'Out': [out]})
    return out

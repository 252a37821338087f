"""Tensor layers (paddle_tpu/layers/tensor.py), cut to what the
transformer's, the LSTM models' and the image models' programs, the
optimizers, gradient clip and the learning-rate schedules use."""
from .layer_helper import LayerHelper

__all__ = ['create_parameter', 'create_global_var', 'cast', 'fill_constant',
           'reshape', 'transpose', 'concat', 'sums', 'select', 'less_than',
           'equal']


def create_parameter(shape, dtype, attr=None, is_bias=False,
                     default_initializer=None, **kwargs):
    helper = LayerHelper('create_parameter', **locals())
    from ..param_attr import ParamAttr
    return helper.create_parameter(ParamAttr.to_attr(attr), shape, dtype,
                                   is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, name=None,
                      **kwargs):
    helper = LayerHelper('global_var', **locals())
    var = helper.create_global_variable(name=name, persistable=persistable,
                                        shape=shape, dtype=dtype)
    from ..initializer import ConstantInitializer
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def cast(x, dtype, **kwargs):
    helper = LayerHelper('cast', **locals())
    # a dtype change keeps the ragged structure: the lod level and @LEN
    out = helper.create_tmp_variable(dtype, lod_level=x.lod_level)
    helper.append_op(type='cast',
                     inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'in_dtype': x.dtype, 'out_dtype': dtype})
    helper.copy_len(x, out)
    return out


def fill_constant(shape, dtype, value, out=None, **kwargs):
    helper = LayerHelper('fill_constant', **locals())
    if out is None:
        out = helper.create_tmp_variable(dtype)
    helper.append_op(type='fill_constant',
                     outputs={'Out': [out]},
                     attrs={'shape': [int(s) for s in shape],
                            'dtype': dtype, 'value': float(value)})
    out.stop_gradient = True
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, **kwargs):
    helper = LayerHelper('reshape', **locals())
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type='reshape', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'shape': [int(s) for s in shape]})
    return helper.append_activation(out)


def transpose(x, perm, **kwargs):
    helper = LayerHelper('transpose', **locals())
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type='transpose', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'axis': [int(p) for p in perm]})
    return out


def concat(input, axis=0, **kwargs):
    """Concatenate along ``axis``; a feature-axis (last-dim) concat of
    ragged inputs keeps their lengths."""
    helper = LayerHelper('concat', **locals())
    ndim = max(len(v.shape) for v in input)
    feature_axis = axis == -1 or axis == ndim - 1
    lod = max(v.lod_level for v in input) if feature_axis else 0
    out = helper.create_tmp_variable(helper.input_dtype(), lod_level=lod)
    helper.append_op(type='concat',
                     inputs={'X': input},
                     outputs={'Out': [out]},
                     attrs={'axis': axis})
    if lod > 0:
        helper.copy_len(next(v for v in input if v.lod_level > 0), out)
    return out


def sums(input, out=None, **kwargs):
    """The elementwise sum of the variables ``input`` (one ``sum`` op)."""
    helper = LayerHelper('sum', **locals())
    if out is None:
        lod = max(v.lod_level for v in input)
        out = helper.create_tmp_variable(helper.input_dtype(),
                                         lod_level=lod)
        if lod > 0:
            helper.copy_len(next(v for v in input if v.lod_level > 0), out)
    helper.append_op(type='sum', inputs={'X': input},
                     outputs={'Out': [out]})
    return out


def select(condition, x, y, **kwargs):
    """Elementwise ``x`` where ``condition`` holds, else ``y``."""
    helper = LayerHelper('select', **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type='select',
        inputs={'Condition': [condition], 'X': [x], 'Y': [y]},
        outputs={'Out': [out]})
    return out


def _compare_layer(op_type):
    def _layer(x, y, cond=None, **kwargs):
        helper = LayerHelper(op_type, **kwargs)
        if cond is None:
            cond = helper.create_tmp_variable('bool', stop_gradient=True)
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [cond]})
        return cond

    _layer.__name__ = op_type
    return _layer


less_than = _compare_layer('less_than')
equal = _compare_layer('equal')

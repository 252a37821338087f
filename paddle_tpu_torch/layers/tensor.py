"""Tensor layers (paddle_tpu/layers/tensor.py), cut to what the
transformer's programs and the optimizers use."""
from .layer_helper import LayerHelper

__all__ = ['create_parameter', 'create_global_var', 'cast', 'fill_constant',
           'reshape']


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
    out = helper.create_tmp_variable(dtype, lod_level=x.lod_level)
    helper.append_op(type='cast',
                     inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'in_dtype': x.dtype, 'out_dtype': dtype})
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

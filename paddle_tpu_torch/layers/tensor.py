"""Tensor layers (paddle_tpu/layers/tensor.py): every one of the
reference's, and the logical layers."""
from ..core.program import Variable
from .layer_helper import LayerHelper

__all__ = ['create_tensor', 'create_parameter', 'create_global_var',
           'cast', 'assign', 'fill_constant',
           'fill_constant_batch_size_like', 'ones', 'zeros', 'reshape',
           'transpose', 'expand', 'argmax_like_topk', 'concat', 'sums',
           'select', 'less_than', 'equal', 'logical_and', 'logical_or',
           'logical_xor', 'logical_not']


def create_tensor(dtype, name=None, persistable=False, **kwargs):
    """A variable of ``dtype`` in the current block, written by no op."""
    helper = LayerHelper('create_tensor', **locals())
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


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


def assign(input, output=None, **kwargs):
    """Copy ``input`` (a Variable, or a numpy-convertible value through
    ``assign_value``) into ``output``, a new variable by default."""
    helper = LayerHelper('assign', **locals())
    if output is None:
        output = helper.create_tmp_variable(
            input.dtype if isinstance(input, Variable) else 'float32')
    if isinstance(input, Variable):
        helper.append_op(type='assign', inputs={'X': [input]},
                         outputs={'Out': [output]})
    else:
        import numpy as np
        arr = np.asarray(input)
        helper.append_op(
            type='assign_value',
            outputs={'Out': [output]},
            attrs={'shape': list(arr.shape), 'dtype': str(arr.dtype),
                   'values': arr.flatten().tolist()})
    return output


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  **kwargs):
    """A constant tensor of ``shape`` whose dim ``output_dim_idx`` is dim
    ``input_dim_idx`` of ``input`` (the batch size)."""
    helper = LayerHelper('fill_constant_batch_size_like', **locals())
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type='fill_constant_batch_size_like',
                     inputs={'Input': [input]},
                     outputs={'Out': [out]},
                     attrs={'shape': [int(s) for s in shape],
                            'dtype': dtype, 'value': float(value),
                            'input_dim_idx': input_dim_idx,
                            'output_dim_idx': output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype, **kwargs):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, **kwargs):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)


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


def expand(x, expand_times, **kwargs):
    """``x`` tiled ``expand_times`` times along each dim."""
    helper = LayerHelper('expand', **locals())
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type='expand', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'expand_times': [int(t) for t in expand_times]})
    return out


def argmax_like_topk(x, **kwargs):
    """The int32 index of x's largest entry along its last axis."""
    from .nn import topk
    return topk(x, 1)[1]


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


def _logical_layer(name, binary=True):
    op_type = 'logical_' + name

    def _layer(x, y=None, out=None, **kwargs):
        helper = LayerHelper(op_type, **kwargs)
        if out is None:
            out = helper.create_tmp_variable('bool', stop_gradient=True)
        inputs = {'X': [x]}
        if binary:
            inputs['Y'] = [y]
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={'Out': [out]})
        return out

    _layer.__name__ = op_type
    return _layer


logical_and = _logical_layer('and')
logical_or = _logical_layer('or')
logical_xor = _logical_layer('xor')
logical_not = _logical_layer('not', binary=False)

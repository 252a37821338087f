"""Neural-network layers (paddle_tpu/layers/nn.py), cut to the
transformer's: fc, embedding, layer_norm, split and the fused vocab head.
Same signatures and the same op attrs as the reference, so a model script
ports by changing its import.
"""
from ..initializer import ConstantInitializer
from ..ops.common import prod
from .layer_helper import LayerHelper

__all__ = ['fc', 'embedding', 'layer_norm', 'split',
           'fused_linear_softmax_ce']


def fc(input,
       size,
       num_flatten_dims=1,
       param_attr=None,
       bias_attr=None,
       act=None,
       name=None,
       **kwargs):
    """Fully connected (fluid.layers.fc; operators/mul_op.cc)."""
    helper = LayerHelper('fc', **locals())
    dtype = helper.input_dtype()
    # float32 master weights under low-precision activations
    p_dtype = 'float32' if dtype in ('bfloat16', 'float16') else dtype
    mul_results = []
    for input_var, param_attr in helper.iter_inputs_and_params():
        w = helper.create_parameter(
            attr=param_attr,
            shape=[prod(input_var.shape[num_flatten_dims:]), size],
            dtype=p_dtype, is_bias=False)
        tmp = helper.create_tmp_variable(dtype)
        helper.append_op(
            type='mul',
            inputs={'X': [input_var], 'Y': [w]},
            outputs={'Out': [tmp]},
            attrs={'x_num_col_dims': num_flatten_dims, 'y_num_col_dims': 1})
        mul_results.append(tmp)
    if len(mul_results) != 1:
        raise NotImplementedError(
            "fc over several inputs needs the `sum` op, not ported yet: "
            "ROADMAP.md Queue 1")
    pre_activation = helper.append_bias_op(mul_results[0],
                                           dim_start=num_flatten_dims)
    return helper.append_activation(pre_activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype='float32', **kwargs):
    """fluid.layers.embedding (operators/lookup_table_op)."""
    helper = LayerHelper('embedding', **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False)
    tmp = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    attrs = {'is_sparse': is_sparse, 'height': int(size[0])}
    if padding_idx is not None:
        attrs['padding_idx'] = padding_idx
    helper.append_op(
        type='lookup_table',
        inputs={'Ids': [input], 'W': [w]},
        outputs={'Out': [tmp]},
        attrs=attrs)
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None, **kwargs):
    helper = LayerHelper('layer_norm', **locals())
    dtype = helper.input_dtype()
    param_shape = [prod(input.shape[begin_norm_axis:])]
    inputs = {'X': [input]}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype='float32',
            default_initializer=ConstantInitializer(1.0))
        inputs['Scale'] = [s]
    if shift:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype='float32',
            is_bias=True)
        inputs['Bias'] = [b]
    mean_out = helper.create_tmp_variable('float32', stop_gradient=True)
    var_out = helper.create_tmp_variable('float32', stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type='layer_norm', inputs=inputs,
        outputs={'Y': [out], 'Mean': [mean_out], 'Variance': [var_out]},
        attrs={'epsilon': epsilon, 'begin_norm_axis': begin_norm_axis})
    return helper.append_activation(out)


def fused_linear_softmax_ce(input, label, size, num_flatten_dims=1,
                            param_attr=None, bias_attr=None, chunk=4096,
                            mode='auto', **kwargs):
    """Vocab projection + softmax cross-entropy as one op
    (ops/chunked_ce.py); a plain fc sharing ``param_attr`` /
    ``bias_attr`` names reuses the trained head for inference."""
    helper = LayerHelper('fused_linear_softmax_ce', **locals())
    dtype = helper.input_dtype()
    p_dtype = 'float32' if dtype in ('bfloat16', 'float16') else dtype
    input_shape = input.shape
    flatten = num_flatten_dims
    w = helper.create_parameter(
        attr=param_attr, shape=[prod(input_shape[flatten:]), size],
        dtype=p_dtype, is_bias=False)
    inputs = {'X': [input], 'W': [w], 'Label': [label]}
    if bias_attr is not False:
        from ..param_attr import ParamAttr
        battr = bias_attr if bias_attr is not None else ParamAttr()
        b = helper.create_parameter(attr=battr, shape=[size],
                                    dtype=p_dtype, is_bias=True)
        inputs['Bias'] = [b]
    loss = helper.create_tmp_variable('float32')
    helper.append_op(
        type='fused_linear_softmax_ce', inputs=inputs,
        outputs={'Loss': [loss]},
        attrs={'chunk': int(chunk), 'mode': mode, 'flatten': flatten},
        infer_shape=False)
    loss.shape = tuple(input_shape[:flatten]) + (1,)
    return loss


def split(input, num_or_sections, dim=-1, **kwargs):
    helper = LayerHelper('split', **locals())
    input_shape = input.shape
    dim = (len(input_shape) + dim) if dim < 0 else dim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {'num': num_or_sections, 'axis': dim, 'sections': []}
    else:
        num = len(num_or_sections)
        attrs = {'sections': list(num_or_sections), 'axis': dim, 'num': 0}
    outs = [helper.create_tmp_variable(input.dtype) for _ in range(num)]
    helper.append_op(type='split', inputs={'X': [input]},
                     outputs={'Out': outs}, attrs=attrs)
    return outs

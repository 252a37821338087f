"""Neural-network layers (paddle_tpu/layers/nn.py), cut to the
transformer's, the LSTM models', the seq2seq translator's and the image
models': fc, embedding, conv2d, pool2d, batch_norm, layer_norm, split,
matmul, pad, the fused vocab head, softmax_with_cross_entropy,
cross_entropy and accuracy.
Same signatures and the same op attrs as the reference, so a model script
ports by changing its import.
"""
from ..initializer import ConstantInitializer, NormalInitializer
from ..ops.common import prod
from ..ops.conv import pair
from .layer_helper import LayerHelper

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm', 'layer_norm',
           'split', 'matmul', 'pad', 'fused_linear_softmax_ce',
           'softmax_with_cross_entropy', 'cross_entropy', 'accuracy']


def fc(input,
       size,
       num_flatten_dims=1,
       param_attr=None,
       bias_attr=None,
       act=None,
       name=None,
       **kwargs):
    """Fully connected (fluid.layers.fc; operators/mul_op.cc), over one
    input or several (their products are summed by a ``sum`` op).  A
    ragged input is padded [B, T, D], so with ``num_flatten_dims=1`` only
    its features flatten."""
    helper = LayerHelper('fc', **locals())
    dtype = helper.input_dtype()
    # float32 master weights under low-precision activations
    p_dtype = 'float32' if dtype in ('bfloat16', 'float16') else dtype
    lod = max(v.lod_level for v in helper.multiple_input())
    mul_results = []
    for input_var, param_attr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        flatten = num_flatten_dims
        if input_var.lod_level > 0 and num_flatten_dims == 1:
            flatten = len(input_shape) - 1
        w = helper.create_parameter(
            attr=param_attr, shape=[prod(input_shape[flatten:]), size],
            dtype=p_dtype, is_bias=False)
        tmp = helper.create_tmp_variable(dtype, lod_level=input_var.lod_level)
        helper.append_op(
            type='mul',
            inputs={'X': [input_var], 'Y': [w]},
            outputs={'Out': [tmp]},
            attrs={'x_num_col_dims': flatten, 'y_num_col_dims': 1})
        helper.copy_len(input_var, tmp)
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype, lod_level=lod)
        helper.append_op(type='sum', inputs={'X': mul_results},
                         outputs={'Out': [pre_bias]})
        if lod > 0:
            helper.copy_len(mul_results[0], pre_bias)
    # the bias spans the size dim: the last of a ragged [B, T, size]
    bias_dim = len(pre_bias.shape) - 1 if lod > 0 else num_flatten_dims
    pre_activation = helper.append_bias_op(pre_bias, dim_start=bias_dim)
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
    helper.copy_len(input, tmp)
    return tmp


def conv2d(input,
           num_filters,
           filter_size,
           stride=None,
           padding=None,
           groups=None,
           param_attr=None,
           bias_attr=None,
           use_cudnn=True,
           act=None,
           name=None,
           data_format='NCHW',
           dtype=None,
           **kwargs):
    """fluid.layers.conv2d (operators/conv_op): an OIHW filter drawn from
    N(0, 2 / (kh * kw * C_in)), a bias over the channel axis, then
    ``act``.  ``bias_attr=False`` still makes a bias, as in the reference:
    ``ParamAttr.to_attr`` reads False as the int 0, a learning rate of 0.0
    (param_attr.py)."""
    helper = LayerHelper('conv2d', **locals())
    dtype = dtype or helper.input_dtype()
    stride = pair(stride or [1, 1])
    padding = pair(padding or [0, 0])
    filter_size = pair(filter_size)
    c_axis = 1 if data_format == 'NCHW' else 3
    num_channels = input.shape[c_axis]
    groups = groups or 1
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    # float32 master weights for low-precision activations
    p_dtype = 'float32' if dtype in ('bfloat16', 'float16') else dtype
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=p_dtype,
        default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type='conv2d',
        inputs={'Input': [input], 'Filter': [w]},
        outputs={'Output': [pre_bias]},
        attrs={'strides': stride, 'paddings': padding, 'groups': groups,
               'dilations': [1, 1], 'data_format': data_format})
    pre_act = helper.append_bias_op(
        pre_bias, dim_start=c_axis, dim_end=c_axis + 1)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, data_format='NCHW', **kwargs):
    """fluid.layers.pool2d (operators/pool_op): max or avg."""
    if pool_type not in ["max", "avg"]:
        raise ValueError("Unknown pool_type: %r" % pool_type)
    helper = LayerHelper('pool2d', **locals())
    tmp = helper.create_tmp_variable(helper.input_dtype())
    helper.append_op(
        type='pool2d',
        inputs={'X': [input]},
        outputs={'Out': [tmp]},
        attrs={'pooling_type': pool_type, 'ksize': pair(pool_size),
               'global_pooling': global_pooling,
               'strides': pair(pool_stride),
               'paddings': pair(pool_padding),
               'data_format': data_format})
    return tmp


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-05,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               name=None, moving_mean_name=None, moving_variance_name=None,
               **kwargs):
    """fluid.layers.batch_norm (operators/batch_norm_op): float32 scale,
    bias and statistics; the running mean and variance are persistable
    globals (initialised to 0 and 1) that the op writes in place of its
    inputs (``MeanOut`` / ``VarianceOut``)."""
    helper = LayerHelper('batch_norm', **locals())
    dtype = helper.input_dtype()
    c_axis = 1 if data_layout == 'NCHW' else -1
    param_shape = [input.shape[c_axis]]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=param_shape, dtype='float32',
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=param_shape, dtype='float32',
        is_bias=True)
    mean = helper.create_global_variable(
        name=moving_mean_name or helper.name + '.mean',
        persistable=True, shape=param_shape, dtype='float32')
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name or helper.name + '.var',
        persistable=True, shape=param_shape, dtype='float32')
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_tmp_variable('float32', stop_gradient=True)
    saved_variance = helper.create_tmp_variable('float32',
                                                stop_gradient=True)
    batch_norm_out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type='batch_norm',
        inputs={'X': [input], 'Scale': [scale], 'Bias': [bias],
                'Mean': [mean], 'Variance': [variance]},
        outputs={'Y': [batch_norm_out], 'MeanOut': [mean],
                 'VarianceOut': [variance], 'SavedMean': [saved_mean],
                 'SavedVariance': [saved_variance]},
        attrs={'momentum': momentum, 'epsilon': epsilon, 'is_test': is_test,
               'data_layout': data_layout})
    return helper.append_activation(batch_norm_out)


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
    if input.lod_level > 0 and num_flatten_dims == 1:
        flatten = len(input_shape) - 1
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


def matmul(x, y, transpose_x=False, transpose_y=False, name=None, **kwargs):
    """Batched x @ y over the last two axes (operators/matmul_op)."""
    helper = LayerHelper('matmul', **locals())
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type='matmul',
        inputs={'X': [x], 'Y': [y]},
        outputs={'Out': [out]},
        attrs={'transpose_X': transpose_x, 'transpose_Y': transpose_y})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, **kwargs):
    """Softmax and cross entropy over the last axis of ``logits`` in one
    op; returns the loss."""
    helper = LayerHelper('softmax_with_cross_entropy', **locals())
    softmax = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op(
        type='softmax_with_cross_entropy',
        inputs={'Logits': [logits], 'Label': [label]},
        outputs={'Softmax': [softmax], 'Loss': [loss]},
        attrs={'soft_label': soft_label})
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


def pad(x, paddings, pad_value=0.0, name=None, **kwargs):
    """Constant padding; ``paddings`` holds (before, after) per dim."""
    helper = LayerHelper('pad', **locals())
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type='pad', inputs={'X': [x]}, outputs={'Out': [out]},
        attrs={'paddings': list(paddings), 'pad_value': float(pad_value)})
    return out


def cross_entropy(input, label, soft_label=False, **kwargs):
    """-log(input[label]) per row of the probabilities ``input``
    (operators/cross_entropy_op)."""
    helper = LayerHelper('cross_entropy', **locals())
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type='cross_entropy',
        inputs={'X': [input], 'Label': [label]},
        outputs={'Y': [out]},
        attrs={'soft_label': soft_label})
    return out


def accuracy(input, label, k=1, correct=None, total=None, **kwargs):
    """Share of rows whose label is among the top ``k`` of ``input``
    (operators/accuracy_op after a top_k op)."""
    helper = LayerHelper('accuracy', **locals())
    topk_out = helper.create_tmp_variable(dtype=input.dtype)
    topk_indices = helper.create_tmp_variable(dtype='int32',
                                              stop_gradient=True)
    helper.append_op(
        type='top_k',
        inputs={'X': [input]},
        outputs={'Out': [topk_out], 'Indices': [topk_indices]},
        attrs={'k': k})
    acc_out = helper.create_tmp_variable(dtype='float32',
                                         stop_gradient=True)
    if correct is None:
        correct = helper.create_tmp_variable(dtype='int32',
                                             stop_gradient=True)
    if total is None:
        total = helper.create_tmp_variable(dtype='int32',
                                           stop_gradient=True)
    helper.append_op(
        type='accuracy',
        inputs={'Indices': [topk_indices], 'Label': [label]},
        outputs={'Accuracy': [acc_out], 'Correct': [correct],
                 'Total': [total]})
    return acc_out

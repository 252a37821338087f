"""Neural-network layers (paddle_tpu/layers/nn.py): every one of the
reference's.  Same signatures and the same op attrs, so a model script
ports by changing its import.
"""
from ..core.program import LEN_SUFFIX
from ..initializer import ConstantInitializer, NormalInitializer
from ..ops.common import prod
from ..ops.conv import pair
from .layer_helper import LayerHelper

__all__ = ['fc', 'embedding', 'conv2d', 'conv3d', 'pool2d', 'pool3d',
           'batch_norm', 'layer_norm', 'dropout', 'split', 'matmul', 'pad',
           'conv2d_transpose', 'fused_linear_softmax_ce',
           'softmax_with_cross_entropy', 'cross_entropy',
           'square_error_cost', 'accuracy', 'auc', 'cos_sim', 'reduce_sum',
           'reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod',
           'topk', 'l2_normalize', 'lrn', 'nce', 'bilinear_tensor_product',
           'prelu', 'multiplex', 'roi_pool', 'detection_output', 'warpctc',
           'one_hot', 'im2sequence', 'row_conv']


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


def dropout(x, dropout_prob, is_test=False, seed=0, **kwargs):
    """fluid.layers.dropout (operators/dropout_op): Out and the Mask it
    drew; non-inverted, as the reference (ops/random.py)."""
    helper = LayerHelper('dropout', **locals())
    out = helper.create_tmp_variable(x.dtype)
    mask = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op(
        type='dropout',
        inputs={'X': [x]},
        outputs={'Out': [out], 'Mask': [mask]},
        attrs={'dropout_prob': dropout_prob, 'is_test': is_test,
               'seed': seed})
    return out


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


def auc(input, label, curve='ROC', num_thresholds=200, **kwargs):
    """The batch's AUC of ``input`` (two-column probabilities) against
    ``label`` (ops/metrics.py ``auc``); not differentiated."""
    helper = LayerHelper('auc', **locals())
    out = helper.create_tmp_variable('float32', stop_gradient=True)
    helper.append_op(
        type='auc',
        inputs={'Out': [input], 'Label': [label]},
        outputs={'AUC': [out]},
        attrs={'curve': curve, 'num_thresholds': num_thresholds})
    return out


def cos_sim(X, Y, **kwargs):
    """Row-wise cosine similarity of X and Y [N, 1] (operators/
    cos_sim_op); also writes the row norms."""
    helper = LayerHelper('cos_sim', **locals())
    out = helper.create_tmp_variable(X.dtype)
    xnorm = helper.create_tmp_variable(X.dtype)
    ynorm = helper.create_tmp_variable(X.dtype)
    helper.append_op(
        type='cos_sim',
        inputs={'X': [X], 'Y': [Y]},
        outputs={'Out': [out], 'XNorm': [xnorm], 'YNorm': [ynorm]})
    return out


def square_error_cost(input, label, **kwargs):
    """(input - label)^2 elementwise (operators/squared_l2_distance_op)."""
    helper = LayerHelper('square_error_cost', **locals())
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type='square_error_cost',
        inputs={'X': [input], 'Y': [label]},
        outputs={'Out': [out]})
    return out


def _reduce_layer(op_name):
    def _layer(input, dim=None, keep_dim=False, name=None, **kwargs):
        helper = LayerHelper(op_name, **locals())
        out = helper.create_tmp_variable(input.dtype)
        helper.append_op(
            type=op_name,
            inputs={'X': [input]},
            outputs={'Out': [out]},
            attrs={'dim': dim, 'keep_dim': keep_dim,
                   'reduce_all': dim is None})
        return out

    _layer.__name__ = op_name
    return _layer


reduce_sum = _reduce_layer('reduce_sum')
reduce_mean = _reduce_layer('reduce_mean')
reduce_max = _reduce_layer('reduce_max')
reduce_min = _reduce_layer('reduce_min')
reduce_prod = _reduce_layer('reduce_prod')


def one_hot(input, depth, **kwargs):
    """float32 one-hot rows of the int ``input`` (operators/one_hot_op)."""
    helper = LayerHelper('one_hot', **locals())
    out = helper.create_tmp_variable('float32')
    helper.append_op(
        type='one_hot',
        inputs={'X': [input]},
        outputs={'Out': [out]},
        attrs={'depth': depth})
    return out


def warpctc(input, label, blank=0, norm_by_times=False, **kwargs):
    """The CTC loss [B, 1] of the unnormalised logits ``input`` [B, T, V]
    against ``label`` (operators/warpctc_op); both may be ragged."""
    helper = LayerHelper('warpctc', **locals())
    loss = helper.create_tmp_variable(input.dtype)
    grad = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    inputs = {'Logits': [input], 'Label': [label]}
    block = helper.main_program.current_block()
    if block.has_var_recursive(input.name + LEN_SUFFIX):
        inputs['LogitsLen'] = [block.var_recursive(input.name + LEN_SUFFIX)]
    if block.has_var_recursive(label.name + LEN_SUFFIX):
        inputs['LabelLen'] = [block.var_recursive(label.name + LEN_SUFFIX)]
    helper.append_op(
        type='warpctc',
        inputs=inputs,
        outputs={'Loss': [loss], 'WarpCTCGrad': [grad]},
        attrs={'blank': blank, 'norm_by_times': norm_by_times})
    return loss


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None,
                **kwargs):
    """The image's conv patches as a sequence (operators/
    im2sequence_op)."""
    helper = LayerHelper('im2sequence', **locals())
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type='im2sequence', inputs={'X': [input]}, outputs={'Out': [out]},
        attrs={'kernels': pair(filter_size), 'strides': pair(stride),
               'paddings': pair(padding, 4)})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             **kwargs):
    """The look-ahead convolution over each sequence's next
    ``future_context_size`` steps (operators/row_conv_op)."""
    helper = LayerHelper('row_conv', **locals())
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[-1]]
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype, is_bias=False)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type='row_conv',
        inputs={'X': [input], 'Filter': [w]},
        outputs={'Out': [out]})
    return helper.append_activation(out)


def conv3d(input, num_filters, filter_size, stride=None, padding=None,
           groups=None, param_attr=None, bias_attr=None, act=None,
           name=None, **kwargs):
    """fluid.layers.conv3d (operators/conv_op) over NCDHW: an OIDHW filter
    with the parameter's default initialiser, a bias over the channel
    axis, then ``act``."""
    helper = LayerHelper('conv3d', **locals())
    dtype = helper.input_dtype()
    stride = pair(stride or [1, 1, 1], 3)
    padding = pair(padding or [0, 0, 0], 3)
    filter_size = pair(filter_size, 3)
    groups = groups or 1
    filter_shape = [num_filters, input.shape[1] // groups] + filter_size
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype, is_bias=False)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type='conv3d',
        inputs={'Input': [input], 'Filter': [w]},
        outputs={'Output': [pre_bias]},
        attrs={'strides': stride, 'paddings': padding, 'groups': groups,
               'dilations': [1, 1, 1]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=None, stride=None, dilation=None,
                     param_attr=None, bias_attr=None, act=None, name=None,
                     **kwargs):
    """fluid.layers.conv2d_transpose (operators/conv_transpose_op): a
    filter (in_c, num_filters, kh, kw), sized from ``output_size`` when
    ``filter_size`` is None."""
    helper = LayerHelper('conv2d_transpose', **locals())
    dtype = helper.input_dtype()
    stride = pair(stride or [1, 1])
    padding = pair(padding or [0, 0])
    dilation = pair(dilation or [1, 1])
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size must be set when filter_size is "
                             "None")
        output_size = pair(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i] +
             2 * padding[i] - 1) // dilation[i] + 1 for i in range(2)]
    else:
        filter_size = pair(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[input.shape[1], num_filters] +
        filter_size, dtype=dtype, is_bias=False)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type='conv2d_transpose',
        inputs={'Input': [input], 'Filter': [w]},
        outputs={'Output': [pre_bias]},
        attrs={'strides': stride, 'paddings': padding,
               'dilations': dilation})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, name=None, **kwargs):
    """fluid.layers.pool3d (operators/pool_op) over NCDHW."""
    helper = LayerHelper('pool3d', **locals())
    tmp = helper.create_tmp_variable(helper.input_dtype())
    helper.append_op(
        type='pool3d',
        inputs={'X': [input]},
        outputs={'Out': [tmp]},
        attrs={'pooling_type': pool_type, 'ksize': pair(pool_size, 3),
               'global_pooling': global_pooling,
               'strides': pair(pool_stride, 3),
               'paddings': pair(pool_padding, 3)})
    return tmp


def topk(input, k, **kwargs):
    """(values, int32 indices) of the ``k`` largest along the last axis
    (operators/top_k_op)."""
    helper = LayerHelper('top_k', **locals())
    values = helper.create_tmp_variable(input.dtype)
    indices = helper.create_tmp_variable('int32', stop_gradient=True)
    helper.append_op(
        type='top_k',
        inputs={'X': [input]},
        outputs={'Out': [values], 'Indices': [indices]},
        attrs={'k': k})
    return values, indices


def l2_normalize(x, axis, epsilon=1e-12, name=None, **kwargs):
    """x over its L2 norm along ``axis`` (the ``norm`` op)."""
    helper = LayerHelper('l2_normalize', **locals())
    out = helper.create_tmp_variable(x.dtype)
    norm = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type='norm',
        inputs={'X': [x]},
        outputs={'Out': [out], 'Norm': [norm]},
        attrs={'axis': axis, 'epsilon': epsilon})
    return out


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None, **kwargs):
    """Local response normalisation across channels (operators/lrn_op)."""
    helper = LayerHelper('lrn', **locals())
    out = helper.create_tmp_variable(input.dtype)
    mid = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(
        type='lrn',
        inputs={'X': [input]},
        outputs={'Out': [out], 'MidOut': [mid]},
        attrs={'n': n, 'k': k, 'alpha': alpha, 'beta': beta})
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, **kwargs):
    """The NCE cost [N, 1] of ``input`` [N, D] against ``label``, with a
    weight [classes, D] and a bias [classes] of its own (operators/
    nce_op); 10 negatives a row by default."""
    helper = LayerHelper('nce', **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_total_classes, input.shape[1]],
        dtype=input.dtype, is_bias=False)
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[num_total_classes],
        dtype=input.dtype, is_bias=True)
    cost = helper.create_tmp_variable(input.dtype)
    sample_logits = helper.create_tmp_variable(input.dtype,
                                               stop_gradient=True)
    sample_labels = helper.create_tmp_variable('int32', stop_gradient=True)
    helper.append_op(
        type='nce',
        inputs={'Input': [input], 'Label': [label], 'Weight': [w],
                'Bias': [b]},
        outputs={'Cost': [cost], 'SampleLogits': [sample_logits],
                 'SampleLabels': [sample_labels]},
        attrs={'num_total_classes': num_total_classes,
               'num_neg_samples': num_neg_samples or 10})
    return cost


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None, **kwargs):
    """Out[n, k] = x[n] W[k] y[n] (+ a [1, size] bias), then ``act``
    (operators/bilinear_tensor_product_op)."""
    helper = LayerHelper('bilinear_tensor_product', **locals())
    dtype = helper.input_dtype('x')
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[size, x.shape[1], y.shape[1]],
        dtype=dtype, is_bias=False)
    out = helper.create_tmp_variable(dtype)
    inputs = {'X': [x], 'Y': [y], 'Weight': [w]}
    if helper.bias_attr:
        inputs['Bias'] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=dtype,
            is_bias=True)]
    helper.append_op(type='bilinear_tensor_product', inputs=inputs,
                     outputs={'Out': [out]})
    return helper.append_activation(out)


def prelu(x, mode='all', param_attr=None, name=None, **kwargs):
    """where(x >= 0, x, alpha * x) with a float32 Alpha parameter (0.25 at
    first): one value ('all'), one a channel ('channel'), or one an
    element of an example ('element')."""
    helper = LayerHelper('prelu', **locals())
    if mode == 'all':
        alpha_shape = [1]
    elif mode == 'channel':
        alpha_shape = [1, x.shape[1], 1, 1]
    else:
        alpha_shape = [1] + list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype='float32',
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type='prelu', inputs={'X': [x], 'Alpha': [alpha]},
                     outputs={'Out': [out]}, attrs={'mode': mode})
    return out


def multiplex(inputs, index, **kwargs):
    """Row b from candidate ``inputs[index[b]]`` (operators/
    multiplex_op)."""
    helper = LayerHelper('multiplex', **locals())
    out = helper.create_tmp_variable(inputs[0].dtype)
    helper.append_op(
        type='multiplex',
        inputs={'X': list(inputs), 'Ids': [index]},
        outputs={'Out': [out]})
    return out


def roi_pool(input, rois, pooled_height, pooled_width, spatial_scale=1.0,
             **kwargs):
    """RoI max pooling (operators/roi_pool_op): input [N, C, H, W], rois
    [R, 5] rows (batch index, x1, y1, x2, y2) -> [R, C, ph, pw]."""
    helper = LayerHelper('roi_pool', **locals())
    out = helper.create_tmp_variable(helper.input_dtype())
    argmax = helper.create_tmp_variable('int32')
    helper.append_op(
        type='roi_pool',
        inputs={'X': [input], 'ROIs': [rois]},
        outputs={'Out': [out], 'Argmax': [argmax]},
        attrs={'pooled_height': pooled_height,
               'pooled_width': pooled_width,
               'spatial_scale': spatial_scale})
    return out


def detection_output(loc, conf, prior_box, num_classes,
                     background_label_id=0, nms_threshold=0.45,
                     confidence_threshold=0.01, nms_top_k=400,
                     keep_top_k=200, **kwargs):
    """SSD's post-processing (operators/detection_output_op): decoded
    priors, per-class NMS, the global top ``keep_top_k`` -> [N,
    keep_top_k, 6] rows (label, score, xmin, ymin, xmax, ymax), label -1
    past the detections."""
    helper = LayerHelper('detection_output', **locals())
    out = helper.create_tmp_variable('float32')
    helper.append_op(
        type='detection_output',
        inputs={'Loc': [loc], 'Conf': [conf], 'PriorBox': [prior_box]},
        outputs={'Out': [out]},
        attrs={'num_classes': num_classes,
               'background_label_id': background_label_id,
               'nms_threshold': nms_threshold,
               'confidence_threshold': confidence_threshold,
               'nms_top_k': nms_top_k, 'keep_top_k': keep_top_k})
    return out

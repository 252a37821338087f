"""Composite networks (paddle_tpu/nets.py), cut to
``simple_img_conv_pool``, ``img_conv_group``, ``sequence_conv_pool``,
``glu`` and ``scaled_dot_product_attention`` (flash and composed)."""
from . import layers

__all__ = ['simple_img_conv_pool', 'img_conv_group', 'sequence_conv_pool',
           'glu', 'scaled_dot_product_attention']


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type='max', data_format='NCHW'):
    """conv2d (with ``act``) then pool2d."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act, data_format=data_format)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, data_format=data_format)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type='max', data_format='NCHW'):
    """A stack of convs, one per entry of ``conv_num_filter`` (each with
    ``conv_act``, or followed by ``batch_norm`` with it and a dropout of
    its drop rate when ``conv_with_batchnorm``), then one pool2d.  Each
    per-conv argument is one value for all or a list of one per conv."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list of filter counts")
    n = len(conv_num_filter)

    def _to_list(obj):
        if isinstance(obj, (list, tuple)):
            if len(obj) != n:
                raise ValueError("%d values for %d convs" % (len(obj), n))
            return list(obj)
        return [obj] * n

    conv_padding = _to_list(conv_padding)
    conv_filter_size = _to_list(conv_filter_size)
    param_attr = _to_list(param_attr)
    conv_with_batchnorm = _to_list(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _to_list(conv_batchnorm_drop_rate)
    tmp = input
    for i in range(n):
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i],
            act=None if conv_with_batchnorm[i] else conv_act,
            data_format=data_format)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act,
                                    data_layout=data_format)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         data_format=data_format)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act='sigmoid', pool_type='max'):
    """sequence_conv (with ``act``) then sequence_pool."""
    conv_out = layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split in half along dim, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    act_b = layers.sigmoid(x=b)
    return layers.elementwise_mul(x=a, y=act_b)


def scaled_dot_product_attention(queries, keys, values,
                                 num_heads=1, dropout_rate=0.0,
                                 use_flash=None, causal=False,
                                 pallas_interpret=False):
    """Multi-head scaled dot-product attention over [batch, seq, d]
    inputs.  ``use_flash`` (the default None: whenever ``dropout_rate``
    is 0) builds the ``flash_attention`` op, which on the card runs the
    hand-written forward and backward kernels; ``use_flash=True`` with
    dropout raises, as the kernel has no attention-probability dropout.
    Otherwise the composed form: split heads, scale by head_dim ** -0.5,
    matmul with the transposed keys, softmax, dropout, matmul, merge
    heads.  As in the reference, the composed form ignores ``causal``: it
    never masks (ROADMAP.md, reference caveats).  ``pallas_interpret`` is
    kept as an op attr for parity with the reference's programs; it
    means nothing here."""
    if num_heads < 1:
        raise ValueError("num_heads must be >= 1")
    head_dim = queries.shape[-1] // num_heads
    if use_flash is None:
        use_flash = dropout_rate == 0.0

    if use_flash:
        if dropout_rate:
            raise ValueError("flash attention path has no attention-"
                             "probability dropout")
        from .layers.layer_helper import LayerHelper
        helper = LayerHelper('flash_attention')

        def _bthd(x):
            return layers.reshape(
                x=x, shape=[x.shape[0] if x.shape[0] > 0 else -1,
                            x.shape[1], num_heads, head_dim])

        q4, k4, v4 = _bthd(queries), _bthd(keys), _bthd(values)
        ctx_out = helper.create_tmp_variable(queries.dtype)
        helper.append_op(
            type='flash_attention',
            inputs={'Q': [q4], 'K': [k4], 'V': [v4]},
            outputs={'Out': [ctx_out]},
            attrs={'causal': bool(causal),
                   'pallas_interpret': bool(pallas_interpret)})
        return layers.reshape(
            x=ctx_out, shape=[queries.shape[0] if queries.shape[0] > 0
                              else -1, queries.shape[1],
                              num_heads * head_dim])

    def _split_heads(x):
        if num_heads == 1:
            return x
        reshaped = layers.reshape(
            x=x, shape=[x.shape[0] if x.shape[0] > 0 else -1, x.shape[1],
                        num_heads, head_dim])
        return layers.transpose(x=reshaped, perm=[0, 2, 1, 3])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    scaled_q = layers.scale(x=q, scale=head_dim ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.softmax(x=product)
    if dropout_rate:
        weights = layers.dropout(x=weights, dropout_prob=dropout_rate)
    ctx_multiheads = layers.matmul(weights, v)
    if num_heads == 1:
        return ctx_multiheads
    ctx = layers.transpose(ctx_multiheads, perm=[0, 2, 1, 3])
    return layers.reshape(
        x=ctx, shape=[ctx.shape[0] if ctx.shape[0] > 0 else -1,
                      ctx.shape[1], num_heads * head_dim])

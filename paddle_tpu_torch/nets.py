"""Composite networks (paddle_tpu/nets.py), cut to
``simple_img_conv_pool`` and the flash path of
``scaled_dot_product_attention``."""
from . import layers

__all__ = ['simple_img_conv_pool', 'scaled_dot_product_attention']


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


def scaled_dot_product_attention(queries, keys, values,
                                 num_heads=1, dropout_rate=0.0,
                                 use_flash=None, causal=False,
                                 pallas_interpret=False):
    """Multi-head scaled dot-product attention over [batch, seq, d]
    inputs through the ``flash_attention`` op: on the card it runs the
    hand-written forward and backward kernels.  The composed
    matmul + softmax form (``use_flash=False``) and attention dropout
    come with a later slice.  ``pallas_interpret`` is kept as an op attr
    for parity with the reference's programs; it means nothing here."""
    if num_heads < 1:
        raise ValueError("num_heads must be >= 1")
    if use_flash is False or dropout_rate:
        raise NotImplementedError(
            "the composed matmul/softmax attention and attention dropout "
            "are not ported yet: ROADMAP.md Queue 1")
    head_dim = queries.shape[-1] // num_heads
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

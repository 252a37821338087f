"""ResNet for CIFAR-10 (the book's ``resnet_cifar10``) and ImageNet
(depth 18/34/50/101/152), the program ``bench.py`` trains.

Reference parity: paddle_tpu/models/resnet.py, built through the port's
layers into the same program: every conv (with ``bias_attr=False``, which
``ParamAttr`` reads as a learning rate of 0.0, so each still has a bias
that an optimizer leaves as it is) then ``batch_norm``; the 7x7/2 stem or
the space-to-depth stem (2x2 pixel blocks into channels, then a 4x4/1
conv); NCHW or NHWC.  ``dtype='bfloat16'`` builds the reference's
low-precision program; this slice measures float32.
"""
from .. import layers

__all__ = ['resnet_cifar10', 'resnet_imagenet', 'build_imagenet']


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  bias_attr=False, layout='NCHW'):
    tmp = layers.conv2d(
        input=input,
        filter_size=filter_size,
        num_filters=ch_out,
        stride=stride,
        padding=padding,
        act=None,
        bias_attr=bias_attr,
        data_format=layout)
    return layers.batch_norm(input=tmp, act=act, data_layout=layout)


def shortcut(input, ch_in, ch_out, stride, layout='NCHW'):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             layout=layout)
    return input


def basicblock(input, ch_in, ch_out, stride, layout='NCHW'):
    short = shortcut(input, ch_in, ch_out, stride, layout)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, layout=layout)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, layout=layout)
    return layers.elementwise_add(x=short, y=conv2, act='relu')


def bottleneck(input, ch_in, ch_out, stride, layout='NCHW'):
    short = shortcut(input, ch_in, ch_out * 4, stride, layout)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, layout=layout)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, layout=layout)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          layout=layout)
    return layers.elementwise_add(x=short, y=conv3, act='relu')


def layer_warp(block_func, input, ch_in, ch_out, count, stride,
               layout='NCHW'):
    res_out = block_func(input, ch_in, ch_out, stride, layout)
    ch_in = ch_out * (4 if block_func is bottleneck else 1)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_in, ch_out, 1, layout)
    return res_out


def resnet_cifar10(ipt, depth=32, num_classes=10):
    """The book's CIFAR-10 net: (depth - 2) / 6 basic blocks a stage."""
    if (depth - 2) % 6:
        raise ValueError("resnet_cifar10 depth must be 6n + 2, got %d"
                         % depth)
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(ipt, ch_out=16, filter_size=3, stride=1, padding=1)
    res1 = layer_warp(basicblock, conv1, 16, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 16, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 32, 64, n, 2)
    pool = layers.pool2d(
        input=res3, pool_size=8, pool_type='avg', pool_stride=1)
    return layers.fc(input=pool, size=num_classes, act='softmax')


_DEPTH_CFG = {
    18: (basicblock, [2, 2, 2, 2]),
    34: (basicblock, [3, 4, 6, 3]),
    50: (bottleneck, [3, 4, 6, 3]),
    101: (bottleneck, [3, 4, 23, 3]),
    152: (bottleneck, [3, 8, 36, 3]),
}


def _space_to_depth_stem(input, layout):
    """2x2 pixel blocks into channels ([B,224,224,3] -> [B,112,112,12]),
    padded (2, 1), then a 4x4/1 conv: an 8x8/2 conv over pixels."""
    if layout == 'NHWC':
        b, h, w, c = input.shape
        x = layers.reshape(input, [b, h // 2, 2, w // 2, 2, c])
        x = layers.transpose(x, [0, 1, 3, 2, 4, 5])
        x = layers.reshape(x, [b, h // 2, w // 2, 4 * c])
        x = layers.pad(x, [0, 0, 2, 1, 2, 1, 0, 0])
    else:
        b, c, h, w = input.shape
        x = layers.reshape(input, [b, c, h // 2, 2, w // 2, 2])
        x = layers.transpose(x, [0, 1, 3, 5, 2, 4])
        x = layers.reshape(x, [b, 4 * c, h // 2, w // 2])
        x = layers.pad(x, [0, 0, 0, 0, 2, 1, 2, 1])
    return conv_bn_layer(x, ch_out=64, filter_size=4, stride=1, padding=0,
                         layout=layout)


def resnet_imagenet(input, depth=50, num_classes=1000, layout='NCHW',
                    stem='7x7'):
    """benchmark/paddle/image/resnet.py's ImageNet net; ``stem`` '7x7' or
    'space_to_depth'."""
    block, counts = _DEPTH_CFG[depth]
    if stem == 'space_to_depth':
        conv1 = _space_to_depth_stem(input, layout)
    else:
        conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                              padding=3, layout=layout)
    pool1 = layers.pool2d(
        input=conv1, pool_size=3, pool_stride=2, pool_padding=1,
        pool_type='max', data_format=layout)
    ch_in = 64
    out = pool1
    for i, (ch_out, count) in enumerate(zip([64, 128, 256, 512], counts)):
        stride = 1 if i == 0 else 2
        out = layer_warp(block, out, ch_in, ch_out, count, stride, layout)
        ch_in = ch_out * (4 if block is bottleneck else 1)
    pool2 = layers.pool2d(
        input=out, pool_size=7, pool_type='avg', global_pooling=True,
        data_format=layout)
    # the classifier head in float32
    head = layers.cast(x=pool2, dtype='float32')
    return layers.fc(input=head, size=num_classes, act='softmax')


def build_imagenet(depth=50, num_classes=1000, image_shape=(3, 224, 224),
                   dtype='float32', layout='NCHW', stem='7x7'):
    """Returns (img, label, prediction, avg_cost, acc), the bench model.
    With ``layout='NHWC'`` feed ``image_shape`` permuted, e.g.
    (224, 224, 3)."""
    img = layers.data(name='img', shape=list(image_shape), dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    x = img
    if dtype == 'bfloat16':
        x = layers.cast(x=x, dtype='bfloat16')
    prediction = resnet_imagenet(x, depth=depth, num_classes=num_classes,
                                 layout=layout, stem=stem)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=prediction, label=label)
    return img, label, prediction, avg_cost, acc

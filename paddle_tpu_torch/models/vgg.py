"""VGG: the book's CIFAR-10 ``vgg16_bn_drop`` and the ImageNet
``vgg_imagenet`` (depth 16 or 19) that ``benchmarks/bench_vgg.py`` trains.

Reference parity: paddle_tpu/models/vgg.py, built through the port's
layers into the same program: ``img_conv_group`` blocks of 3x3 convs,
each block ending in a 2x2/2 max pool; ``vgg16_bn_drop`` with a
batch_norm after every conv and dropout inside the blocks and around its
[N, 512] fc block (a 2-D batch_norm); ``vgg_imagenet`` with plain relu
convs, two 4096-wide fcs each followed by dropout 0.5, and the head's
``cast`` to float32; NCHW or NHWC.  Dropout is fluid's non-inverted form
(ops/random.py).
"""
from .. import layers, nets

__all__ = ['vgg16_bn_drop', 'vgg_imagenet']


def vgg16_bn_drop(input, num_classes=10):
    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type='max')

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act='relu')
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=num_classes, act='softmax')


def vgg_imagenet(input, num_classes=1000, depth=16, layout='NCHW'):
    """VGG-16 (blocks of 2, 2, 3, 3, 3 convs) or VGG-19 (2, 2, 4, 4, 4)
    of 64, 128, 256, 512 and 512 filters, then fc 4096, dropout, fc 4096,
    dropout, and a float32 softmax head."""
    cfg = {16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}[depth]

    def conv_block(ipt, num_filter, groups):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=False, pool_type='max',
            data_format=layout)

    out = input
    for num_filter, groups in zip([64, 128, 256, 512, 512], cfg):
        out = conv_block(out, num_filter, groups)
    fc1 = layers.fc(input=out, size=4096, act='relu')
    drop1 = layers.dropout(x=fc1, dropout_prob=0.5)
    fc2 = layers.fc(input=drop1, size=4096, act='relu')
    drop2 = layers.dropout(x=fc2, dropout_prob=0.5)
    head = layers.cast(x=drop2, dtype='float32')
    return layers.fc(input=head, size=num_classes, act='softmax')

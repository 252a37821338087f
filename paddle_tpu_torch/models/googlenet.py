"""GoogLeNet (Inception-v1), as the image benchmarks train it.

Reference parity: paddle_tpu/models/googlenet.py (benchmark/paddle/image/
googlenet.py): a 7x7/2 stem conv and 3x3/2 max pool, a 1x1 and a 3x3
conv and another pool, nine inception blocks (3a-3b, 4a-4e, 5a-5b; each
four branches: 1x1; 1x1 then 3x3; 1x1 then 5x5; a 3x3/1 max pool then
1x1, concatenated on channels) with a 3x3/2 max pool after 3b and 4e, a
global average pool, dropout 0.4 and a softmax head; built through the
port's layers into the same program (58 convs and an fc: 116 parameter
tensors).
"""
from .. import layers

__all__ = ['googlenet', 'inception']


def inception(input, c1, c3r, c3, c5r, c5, proj):
    conv1 = layers.conv2d(input=input, num_filters=c1, filter_size=1,
                          act='relu')
    conv3r = layers.conv2d(input=input, num_filters=c3r, filter_size=1,
                           act='relu')
    conv3 = layers.conv2d(input=conv3r, num_filters=c3, filter_size=3,
                          padding=1, act='relu')
    conv5r = layers.conv2d(input=input, num_filters=c5r, filter_size=1,
                           act='relu')
    conv5 = layers.conv2d(input=conv5r, num_filters=c5, filter_size=5,
                          padding=2, act='relu')
    pool = layers.pool2d(input=input, pool_size=3, pool_stride=1,
                         pool_padding=1)
    convprj = layers.conv2d(input=pool, num_filters=proj, filter_size=1,
                            act='relu')
    return layers.concat([conv1, conv3, conv5, convprj], axis=1)


def googlenet(input, num_classes=1000):
    conv = layers.conv2d(input=input, num_filters=64, filter_size=7,
                         stride=2, padding=3, act='relu')
    pool = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_type='max')
    conv = layers.conv2d(input=pool, num_filters=64, filter_size=1,
                         act='relu')
    conv = layers.conv2d(input=conv, num_filters=192, filter_size=3,
                         padding=1, act='relu')
    pool = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_type='max')

    ince3a = inception(pool, 64, 96, 128, 16, 32, 32)
    ince3b = inception(ince3a, 128, 128, 192, 32, 96, 64)
    pool3 = layers.pool2d(input=ince3b, pool_size=3, pool_stride=2,
                          pool_type='max')
    ince4a = inception(pool3, 192, 96, 208, 16, 48, 64)
    ince4b = inception(ince4a, 160, 112, 224, 24, 64, 64)
    ince4c = inception(ince4b, 128, 128, 256, 24, 64, 64)
    ince4d = inception(ince4c, 112, 144, 288, 32, 64, 64)
    ince4e = inception(ince4d, 256, 160, 320, 32, 128, 128)
    pool4 = layers.pool2d(input=ince4e, pool_size=3, pool_stride=2,
                          pool_type='max')
    ince5a = inception(pool4, 256, 160, 320, 32, 128, 128)
    ince5b = inception(ince5a, 384, 192, 384, 48, 128, 128)
    pool5 = layers.pool2d(input=ince5b, pool_size=7, pool_type='avg',
                          global_pooling=True)
    drop = layers.dropout(x=pool5, dropout_prob=0.4)
    return layers.fc(input=drop, size=num_classes, act='softmax')

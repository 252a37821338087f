"""AlexNet, as the image benchmarks train it.

Reference parity: paddle_tpu/models/alexnet.py (benchmark/paddle/image/
alexnet.py): five relu convs (11x11/4 of 64 filters, 5x5 of 192, three
3x3 of 384, 256, 256), a 3x3/2 max pool after the first, second and
fifth, two 4096-wide relu fcs each followed by fluid's non-inverted
dropout 0.5, and a softmax head; built through the port's layers into
the same program.
"""
from .. import layers

__all__ = ['alexnet']


def alexnet(input, num_classes=1000):
    conv1 = layers.conv2d(input=input, num_filters=64, filter_size=11,
                          stride=4, padding=2, act='relu')
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2)
    conv2 = layers.conv2d(input=pool1, num_filters=192, filter_size=5,
                          padding=2, act='relu')
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2)
    conv3 = layers.conv2d(input=pool2, num_filters=384, filter_size=3,
                          padding=1, act='relu')
    conv4 = layers.conv2d(input=conv3, num_filters=256, filter_size=3,
                          padding=1, act='relu')
    conv5 = layers.conv2d(input=conv4, num_filters=256, filter_size=3,
                          padding=1, act='relu')
    pool5 = layers.pool2d(input=conv5, pool_size=3, pool_stride=2)
    fc1 = layers.fc(input=pool5, size=4096, act='relu')
    drop1 = layers.dropout(x=fc1, dropout_prob=0.5)
    fc2 = layers.fc(input=drop1, size=4096, act='relu')
    drop2 = layers.dropout(x=fc2, dropout_prob=0.5)
    return layers.fc(input=drop2, size=num_classes, act='softmax')

"""SmallNet: the small CIFAR-10 conv net of the image benchmarks.

Reference parity: paddle_tpu/models/smallnet.py (benchmark/paddle/image/
smallnet_mnist_cifar.py): three 5x5 relu convs of 32, 32 and 64 filters,
each followed by a 3x3/2 pool (max, then average twice), a 64-wide relu
fc and a softmax head; built through the port's layers into the same
program.
"""
from .. import layers

__all__ = ['smallnet']


def smallnet(input, num_classes=10):
    conv1 = layers.conv2d(input=input, num_filters=32, filter_size=5,
                          padding=2, act='relu')
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_type='max')
    conv2 = layers.conv2d(input=pool1, num_filters=32, filter_size=5,
                          padding=2, act='relu')
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2,
                          pool_type='avg')
    conv3 = layers.conv2d(input=pool2, num_filters=64, filter_size=5,
                          padding=2, act='relu')
    pool3 = layers.pool2d(input=conv3, pool_size=3, pool_stride=2,
                          pool_type='avg')
    fc1 = layers.fc(input=pool3, size=64, act='relu')
    return layers.fc(input=fc1, size=num_classes, act='softmax')

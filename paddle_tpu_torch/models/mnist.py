"""The book's recognize_digits nets on MNIST: an MLP and a convnet.

Reference parity: paddle_tpu/models/mnist.py (fluid/tests/book/
test_recognize_digits_{mlp,conv}.py).
"""
from .. import layers, nets

__all__ = ['mlp', 'convnet', 'build']


def mlp(img, label):
    hidden1 = layers.fc(input=img, size=128, act='relu')
    hidden2 = layers.fc(input=hidden1, size=64, act='relu')
    return layers.fc(input=hidden2, size=10, act='softmax')


def convnet(img, label):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(input=conv_pool_2, size=10, act="softmax")


def build(nn_type='conv'):
    """Returns (img, label, prediction, avg_cost, acc)."""
    img = layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    label = layers.data(name='label', shape=[1], dtype='int64')
    net = convnet if nn_type == 'conv' else mlp
    prediction = net(img, label)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=prediction, label=label)
    return img, label, prediction, avg_cost, acc

"""Synthetic MNIST (paddle_tpu/datasets/mnist.py, python/paddle/v2/
dataset/mnist.py): ``train()`` / ``test()`` yield (float32[784] in
[-1, 1], int label in [0, 10)).

The task: ten fixed random digit templates (one a class, smoothed so
convolutions see local structure) plus Gaussian noise, learnable enough
for the book's nets to pass their accuracy bar.
"""
import numpy as np

from . import common

__all__ = ['train', 'test']

TRAIN_SIZE = 8192
TEST_SIZE = 2048


def _templates():
    rng = common.rng_for('mnist', 'templates')
    t = rng.normal(size=(10, 784)).astype(np.float32)
    img = t.reshape(10, 28, 28)
    img = (img + np.roll(img, 1, axis=1) + np.roll(img, 1, axis=2)) / 3.0
    return np.clip(img.reshape(10, 784), -1, 1)


def reader_creator(split, size):
    def reader():
        tpl = _templates()
        rng = common.rng_for('mnist', split)
        for _ in range(size):
            label = int(rng.integers(0, 10))
            img = tpl[label] + 0.6 * rng.normal(size=784).astype(np.float32)
            yield np.clip(img, -1, 1).astype(np.float32), label

    return reader


def train():
    """The training reader: (float32[784] in [-1, 1], int label)."""
    return reader_creator('train', TRAIN_SIZE)


def test():
    return reader_creator('test', TEST_SIZE)

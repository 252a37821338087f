"""Synthetic CIFAR-10 (paddle_tpu/datasets/cifar.py, python/paddle/v2/
dataset/cifar.py): ``train10`` / ``test10`` yield (float32[3072] in
[0, 1], CHW flattened, label in [0, 10)).

The task: a colour and texture template a class plus noise.
"""
import numpy as np

from . import common

__all__ = ['train10', 'test10']

TRAIN_SIZE = 4096
TEST_SIZE = 1024


def _templates():
    rng = common.rng_for('cifar10', 'templates')
    t = rng.random(size=(10, 3, 32, 32)).astype(np.float32)
    t = (t + np.roll(t, 1, axis=2) + np.roll(t, 1, axis=3)) / 3.0
    return t.reshape(10, 3072)


def reader_creator(split, size):
    def reader():
        tpl = _templates()
        rng = common.rng_for('cifar10', split)
        for _ in range(size):
            label = int(rng.integers(0, 10))
            img = tpl[label] + 0.25 * rng.normal(size=3072)
            yield np.clip(img, 0, 1).astype(np.float32), label

    return reader


def train10():
    return reader_creator('train', TRAIN_SIZE)


def test10():
    return reader_creator('test', TEST_SIZE)

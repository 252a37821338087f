"""Synthetic UCI Housing (paddle_tpu/datasets/uci_housing.py, python/
paddle/v2/dataset/uci_housing.py): ``train()`` / ``test()`` yield
(float32[13] normalised features, float32[1] price).

The task: a fixed linear model of the features plus unit noise, so
fit_a_line fits a line; the same samples as the reference's, bit for bit
(its generator keys, draw order and arithmetic).
"""
import numpy as np

from . import common

__all__ = ['train', 'test', 'feature_names']

feature_names = [
    'CRIM', 'ZN', 'INDUS', 'CHAS', 'NOX', 'RM', 'AGE', 'DIS', 'RAD', 'TAX',
    'PTRATIO', 'B', 'LSTAT'
]

FEATURE_NUM = 13
TRAIN_SIZE = 404
TEST_SIZE = 102


def _coef():
    rng = common.rng_for('uci_housing', 'coef')
    w = rng.normal(scale=2.0, size=FEATURE_NUM).astype(np.float32)
    b = np.float32(22.5)  # mean Boston price
    return w, b


def reader_creator(split, size):
    def reader():
        w, b = _coef()
        rng = common.rng_for('uci_housing', split)
        for _ in range(size):
            x = rng.normal(size=FEATURE_NUM).astype(np.float32)
            y = x @ w + b + rng.normal(scale=1.0)
            yield x, np.array([y], dtype=np.float32)

    return reader


def train():
    return reader_creator('train', TRAIN_SIZE)


def test():
    return reader_creator('test', TEST_SIZE)

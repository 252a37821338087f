"""Linear regression on UCI Housing (the book's fit_a_line).

Reference parity: paddle_tpu/models/fit_a_line.py
(python/paddle/v2/fluid/tests/book/test_fit_a_line.py).
"""
from .. import layers

__all__ = ['build']


def build():
    """Returns (x, y, y_predict, avg_cost)."""
    x = layers.data(name='x', shape=[13], dtype='float32')
    y = layers.data(name='y', shape=[1], dtype='float32')
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(x=cost)
    return x, y, y_predict, avg_cost

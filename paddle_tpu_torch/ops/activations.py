"""Activation ops (paddle_tpu/ops/activations.py), cut to relu, sigmoid,
tanh, exp, log, sqrt, floor, ceil, square, sign and pow (its ``factor``
attr): one elementwise function each, which the clip, regularizer and
learning-rate-decay ops use besides the models."""
import torch

from ..core.registry import register_op
from .common import first, out


def _unary(name, fn):
    @register_op(name)
    def _impl(ctx, ins, attrs):
        return out(fn(first(ins, 'X'), attrs))

    return _impl


_unary('relu', lambda x, a: torch.relu(x))
_unary('sigmoid', lambda x, a: torch.sigmoid(x))
_unary('tanh', lambda x, a: torch.tanh(x))
_unary('exp', lambda x, a: torch.exp(x))
_unary('log', lambda x, a: torch.log(x))
_unary('sqrt', lambda x, a: torch.sqrt(x))
_unary('floor', lambda x, a: torch.floor(x))
_unary('ceil', lambda x, a: torch.ceil(x))
_unary('square', lambda x, a: torch.square(x))
_unary('sign', lambda x, a: torch.sign(x))
_unary('pow', lambda x, a: torch.pow(x, a.get('factor', 1.0)))

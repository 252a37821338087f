"""Activation ops (paddle_tpu/ops/activations.py), cut to ``relu`` and
``tanh``."""
import torch

from ..core.registry import register_op
from .common import first, out


@register_op('relu')
def _relu(ctx, ins, attrs):
    return out(torch.relu(first(ins, 'X')))


@register_op('tanh')
def _tanh(ctx, ins, attrs):
    return out(torch.tanh(first(ins, 'X')))

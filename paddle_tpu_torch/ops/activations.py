"""Activation ops (paddle_tpu/ops/activations.py): one elementwise function
each, with the reference's attrs and defaults, and ``prelu``.

Each is written so that its autograd gives what ``jax.grad`` gives for
the reference's function, at the bounds and ties too:

- ``jnp.clip`` is ``min(max(x, lo), hi)``, and ``lax.max`` / ``lax.min``
  split a tie's cotangent 0.5 / 0.5, as ``torch.maximum`` /
  ``torch.minimum`` do: ``clip`` below (brelu, relu6, hard_sigmoid,
  soft_relu's inner clip) is written that way, not as ``torch.clamp``,
  which passes all of it;
- ``jnp.abs``'s derivative at 0 is 1 (``abs``);
- ``jax.nn.softplus`` is ``logaddexp(x, 0)``, which does not switch to x
  past a threshold as ``F.softplus`` does;
- the ``where`` forms keep the reference's conditions (``x >= 0`` for
  leaky_relu and elu, ``x > threshold`` for thresholded_relu).
"""
import torch

from ..core.registry import register_op
from .common import first, out


def clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` with its gradient: a tie with a bound
    passes half the cotangent."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def abs_(x):
    """``jnp.abs``, whose derivative at 0 is 1 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _unary(name, fn):
    @register_op(name)
    def _impl(ctx, ins, attrs):
        return out(fn(first(ins, 'X'), attrs))

    return _impl


def _softshrink(x, a):
    lam = a.get('lambda', 0.5)
    return torch.where(x > lam, x - lam,
                       torch.where(x < -lam, x + lam, torch.zeros_like(x)))


_unary('relu', lambda x, a: torch.relu(x))
_unary('sigmoid', lambda x, a: torch.sigmoid(x))
_unary('logsigmoid', lambda x, a: -softplus(-x))
_unary('tanh', lambda x, a: torch.tanh(x))
_unary('tanh_shrink', lambda x, a: x - torch.tanh(x))
_unary('exp', lambda x, a: torch.exp(x))
_unary('log', lambda x, a: torch.log(x))
_unary('sqrt', lambda x, a: torch.sqrt(x))
_unary('abs', lambda x, a: abs_(x))
_unary('floor', lambda x, a: torch.floor(x))
_unary('ceil', lambda x, a: torch.ceil(x))
_unary('round', lambda x, a: torch.round(x))   # half to even, as jnp
_unary('reciprocal', lambda x, a: 1.0 / x)
_unary('square', lambda x, a: torch.square(x))
_unary('softplus', lambda x, a: softplus(x))
_unary('softsign', lambda x, a: x / (abs_(x) + 1))
_unary('softshrink', _softshrink)
_unary('hard_shrink',
       lambda x, a: torch.where(abs_(x) > a.get('threshold', 0.5), x,
                                torch.zeros_like(x)))
_unary('brelu',
       lambda x, a: clip(x, a.get('t_min', 0.0), a.get('t_max', 24.0)))
_unary('leaky_relu',
       lambda x, a: torch.where(x >= 0, x, a.get('alpha', 0.02) * x))
_unary('soft_relu',
       lambda x, a: torch.log1p(torch.exp(clip(
           x, -a.get('threshold', 40.0), a.get('threshold', 40.0)))))
_unary('elu',
       lambda x, a: torch.where(x >= 0, x,
                                a.get('alpha', 1.0) * (torch.exp(x) - 1)))
_unary('relu6', lambda x, a: clip(x, 0.0, a.get('threshold', 6.0)))
_unary('pow', lambda x, a: torch.pow(x, a.get('factor', 1.0)))
_unary('stanh',
       lambda x, a: a.get('scale_b', 1.7159) * torch.tanh(
           a.get('scale_a', 2.0 / 3.0) * x))
_unary('thresholded_relu',
       lambda x, a: torch.where(x > a.get('threshold', 1.0), x,
                                torch.zeros_like(x)))
_unary('hard_sigmoid',
       lambda x, a: clip(a.get('slope', 0.2) * x + a.get('offset', 0.5),
                         0.0, 1.0))
_unary('swish', lambda x, a: x * torch.sigmoid(a.get('beta', 1.0) * x))
_unary('sign', lambda x, a: torch.sign(x))


@register_op('prelu')
def _prelu(ctx, ins, attrs):
    """where(x >= 0, x, Alpha * x): Alpha a single value, or broadcast
    against X (per channel [1, C, 1, 1], or per element); the result in
    the promotion of both dtypes, as jnp promotes an array Alpha."""
    alpha = first(ins, 'Alpha')
    x = first(ins, 'X')
    x = x.to(torch.promote_types(x.dtype, alpha.dtype))
    return out(torch.where(x >= 0, x, alpha.reshape(()) * x
                           if alpha.numel() == 1 else alpha * x))

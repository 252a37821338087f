"""Random ops (paddle_tpu/ops/random.py): ``uniform_random``,
``gaussian_random``, ``truncated_gaussian_random``, ``dropout`` and
``random_crop``.

Each op draws from a ``torch.Generator`` the executor seeds from
(program seed, step, block, op position), with a nonzero ``seed`` attr
folded in, as the reference keys its per-op PRNG.  The numbers are not
JAX's (Philox against Threefry): tests carry the reference's initial
values across, and hold the draws to the reference by distribution only.
"""
import math

import torch

from ..core import datatypes
from ..core.registry import register_op
from .common import first, out


@register_op('uniform_random', stateful_rng=True)
def _uniform_random(ctx, ins, attrs):
    dtype = datatypes.as_torch_dtype(attrs.get('dtype', 'float32'))
    lo, hi = attrs.get('min', -1.0), attrs.get('max', 1.0)
    u = torch.rand(tuple(attrs['shape']), dtype=torch.float32,
                   device=ctx.device,
                   generator=ctx.generator(attrs.get('seed', 0)))
    return out((u * (hi - lo) + lo).to(dtype))


@register_op('gaussian_random', stateful_rng=True)
def _gaussian_random(ctx, ins, attrs):
    """Normal draws, mean ``mean`` and deviation ``std``, drawn in float32
    and cast, as the reference's ``_gaussian_random``."""
    dtype = datatypes.as_torch_dtype(attrs.get('dtype', 'float32'))
    g = torch.randn(tuple(attrs['shape']), dtype=torch.float32,
                    device=ctx.device,
                    generator=ctx.generator(attrs.get('seed', 0)))
    return out((g * attrs.get('std', 1.0) + attrs.get('mean', 0.0)).to(dtype))


@register_op('truncated_gaussian_random', stateful_rng=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    """Normal draws truncated to two deviations, times ``std`` plus
    ``mean``, drawn in float32 and cast, as the reference's
    ``_truncated_gaussian_random`` (``jax.random.truncated_normal`` on
    [-2, 2]): a uniform draw between the normal CDF's values at -2 and 2,
    mapped back through the inverse CDF and clamped into [-2, 2]."""
    dtype = datatypes.as_torch_dtype(attrs.get('dtype', 'float32'))
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    u = torch.rand(tuple(attrs['shape']), dtype=torch.float32,
                   device=ctx.device,
                   generator=ctx.generator(attrs.get('seed', 0)))
    g = torch.clamp(math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo)),
                    -2.0, 2.0)
    return out((g * attrs.get('std', 1.0) + attrs.get('mean', 0.0)).to(dtype))


@register_op('dropout', stateful_rng=True)
def _dropout(ctx, ins, attrs):
    """Fluid's non-inverted dropout (dropout_op.h), as the reference keeps
    it: in training Out = X * Mask with Mask ~ Bernoulli(1 - p) and no
    1 / (1 - p) rescale; with ``is_test`` Out = X * (1 - p); with p = 0
    Out = X.  Both of the last two write a Mask of ones."""
    x = first(ins, 'X')
    p = attrs.get('dropout_prob', 0.5)
    if p == 0.0:
        return {'Out': [x], 'Mask': [torch.ones_like(x)]}
    if attrs.get('is_test', False):
        return {'Out': [(x * (1.0 - p)).to(x.dtype)],
                'Mask': [torch.ones_like(x)]}
    u = torch.rand(tuple(x.shape), dtype=torch.float32, device=ctx.device,
                   generator=ctx.generator(attrs.get('seed', 0)))
    mask = (u < 1.0 - p).to(x.dtype)
    return {'Out': [x * mask], 'Mask': [mask]}


@register_op('random_crop', stateful_rng=True)
def _random_crop(ctx, ins, attrs):
    """A window of ``shape`` over X's last len(shape) dims, its start in
    each drawn uniformly from [0, X's size - shape's + 1), one start for
    the whole batch, as the reference draws it.  The starts stay on X's
    device: the window is gathered, not sliced at a host index."""
    x = first(ins, 'X')
    shape = [int(s) for s in attrs['shape']]
    gen = ctx.generator(attrs.get('seed', 0))
    lead = x.dim() - len(shape)
    for i, size in enumerate(shape):
        start = torch.randint(0, x.shape[lead + i] - size + 1, (1,),
                              device=x.device, generator=gen)
        x = torch.index_select(
            x, lead + i, start + torch.arange(size, device=x.device))
    return out(x)

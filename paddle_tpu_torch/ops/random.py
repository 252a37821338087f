"""Random ops (paddle_tpu/ops/random.py), cut to ``uniform_random`` and
``gaussian_random``.

Each op draws from a ``torch.Generator`` the executor seeds from
(program seed, step, block, op position), with a nonzero ``seed`` attr
folded in, as the reference keys its per-op PRNG.  The numbers are not
JAX's (Philox against Threefry): tests carry the reference's initial
values across, and hold the draws to the reference by distribution only.
"""
import torch

from ..core import datatypes
from ..core.registry import register_op
from .common import out


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

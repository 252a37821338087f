"""Math ops: mul, matmul, the elementwise family (add, sub, mul, div,
pow, max, min, mod), minus, scale, sum, mean, clip, clip_by_norm, the
reductions (sum, mean, max, min, prod), softmax, top_k, cos_sim, the norms
(l1_norm, squared_l2_norm, squared_l2_distance, norm), maxout and
bilinear_tensor_product.

Reference parity: paddle_tpu/ops/math.py (paddle/operators/{mul,matmul,
elementwise_*,minus,scale,sum,mean,clip,clip_by_norm,reduce,softmax,top_k,
cos_sim,l1_norm,squared_l2_norm,squared_l2_distance,norm,maxout,
bilinear_tensor_product}_op).
The products are ``torch.matmul``: the reference leaves them to XLA,
outside any Pallas kernel.  ``clip`` is ``min(max(x, lo), hi)`` as
``jnp.clip`` is, so a value on a bound passes half its cotangent, and
``elementwise_mod`` is ``jnp.mod``'s floored modulo (``torch.remainder``).
"""
import torch

from ..core.registry import register_op
from .activations import abs_, clip
from .common import bcast_axis, first, out, prod


@register_op('mul')
def _mul(ctx, ins, attrs):
    """Fluid ``mul``: flatten X to 2-D at x_num_col_dims, Y at
    y_num_col_dims, then matmul (operators/mul_op.cc)."""
    x = first(ins, 'X')
    y = first(ins, 'Y')
    xnc = attrs.get('x_num_col_dims', 1)
    ync = attrs.get('y_num_col_dims', 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(prod(xs[:xnc]), prod(xs[xnc:]))
    y2 = y.reshape(prod(ys[:ync]), prod(ys[ync:])).to(x.dtype)
    return out(torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:]))


@register_op('matmul')
def _matmul(ctx, ins, attrs):
    """Batched X @ Y with ``transpose_X`` / ``transpose_Y`` (the last two
    axes) and ``alpha`` (operators/matmul_op)."""
    x = first(ins, 'X')
    y = first(ins, 'Y')
    if attrs.get('transpose_X', False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get('transpose_Y', False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    z = torch.matmul(x, y.to(x.dtype))
    if x.dim() == 1 and y.dim() == 1:
        return out(z)
    alpha = attrs.get('alpha', 1.0)
    return out(z * alpha if alpha != 1.0 else z)


def _elementwise(name, fn):
    """One ``elementwise_<name>`` op: Y broadcast into X from ``axis``
    (fluid's rule, ``bcast_axis``); a float Y of another width takes X's,
    so float32 master params meeting low-precision activations stay in
    the activation dtype."""
    @register_op('elementwise_' + name)
    def _impl(ctx, ins, attrs):
        x = first(ins, 'X')
        y = bcast_axis(x, first(ins, 'Y'), attrs.get('axis', -1))
        if y.dtype != x.dtype and x.dtype.is_floating_point and \
                y.dtype.is_floating_point:
            y = y.to(x.dtype)
        return out(fn(x, y))

    return _impl


for _name, _fn in (('add', torch.add), ('sub', torch.sub),
                   ('mul', torch.mul), ('div', torch.div),
                   ('pow', torch.pow), ('max', torch.maximum),
                   ('min', torch.minimum), ('mod', torch.remainder)):
    _elementwise(_name, _fn)


@register_op('scale')
def _scale(ctx, ins, attrs):
    x = first(ins, 'X')
    scale = attrs.get('scale', 1.0)
    bias = attrs.get('bias', 0.0)
    if attrs.get('bias_after_scale', True):
        return out(x * scale + bias)
    return out((x + bias) * scale)


@register_op('sum')
def _sum(ctx, ins, attrs):
    xs = ins.get('X', [])
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return out(acc)


@register_op('mean')
def _mean(ctx, ins, attrs):
    """The mean of X; over a ragged X (its lengths in XLen) the mean of the
    valid steps only, as the reference's LoDTensor holds only those."""
    x = first(ins, 'X')
    lengths = first(ins, 'XLen')
    xf = x.float()
    if lengths is None:
        m = xf.mean()
    else:
        ln = lengths.reshape(-1).long()
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < \
            ln[:, None]
        mask = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))
        # counted in float32, as the reference counts
        count = ln.float().sum() * float(prod(x.shape[2:]))
        m = torch.where(mask, xf, torch.zeros_like(xf)).sum() / \
            torch.clamp(count, min=1.0)
    return out(m.to(x.dtype).reshape(1))


@register_op('minus')
def _minus(ctx, ins, attrs):
    return out(first(ins, 'X') - first(ins, 'Y'))


@register_op('clip')
def _clip(ctx, ins, attrs):
    return out(clip(first(ins, 'X'), attrs['min'], attrs['max']))


@register_op('clip_by_norm')
def _clip_by_norm(ctx, ins, attrs):
    """X scaled to an L2 norm of at most ``max_norm``; the norm is taken
    in float32 and floored at 1e-12, and stays on the device."""
    x = first(ins, 'X')
    max_norm = attrs['max_norm']
    xf = x.float()
    norm = torch.sqrt(torch.sum(torch.square(xf)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return out((xf * scale).to(x.dtype))


def _prod_axes(x, axes, keepdim):
    # torch.prod takes one dim: the last first, so the others keep their
    # index when keepdim is False
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim, dtype=x.dtype)
    return x


_REDUCERS = {
    'sum': lambda x, a, k: torch.sum(x, dim=a, keepdim=k, dtype=x.dtype),
    'mean': lambda x, a, k: torch.mean(x, dim=a, keepdim=k),
    'max': lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
    'min': lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
    'prod': _prod_axes,
}


def _reduce(name, fn):
    """``reduce_<name>`` over ``dim`` (an axis or a list of them), or
    over every axis with ``reduce_all``; a 0-d result becomes [1], and
    integer inputs keep their width, as in the reference."""
    @register_op('reduce_' + name)
    def _impl(ctx, ins, attrs):
        x = first(ins, 'X')
        dim = attrs.get('dim', None)
        if attrs.get('reduce_all', dim is None):
            axes = tuple(range(x.dim()))
        else:
            dims = dim if isinstance(dim, (list, tuple)) else (dim,)
            axes = tuple(int(d) % x.dim() for d in dims)
        r = fn(x, axes, attrs.get('keep_dim', False))
        return out(r.reshape(1) if r.dim() == 0 else r)

    return _impl


for _name, _fn in _REDUCERS.items():
    _reduce(_name, _fn)


@register_op('softmax')
def _softmax(ctx, ins, attrs):
    x = first(ins, 'X')
    return out(torch.softmax(x.float(), dim=-1).to(x.dtype))


@register_op('top_k')
def _top_k(ctx, ins, attrs):
    vals, idxs = torch.topk(first(ins, 'X'), attrs.get('k', 1), dim=-1)
    return {'Out': [vals], 'Indices': [idxs.to(torch.int32)]}


@register_op('cos_sim')
def _cos_sim(ctx, ins, attrs):
    """Row-wise cosine of X [N, D] and Y [N, D] (a one-row Y broadcast to
    every row of X), with the norms XNorm and YNorm [N, 1]; the
    denominator carries the reference's 1e-12."""
    x = first(ins, 'X').float()
    y = first(ins, 'Y').float()
    if y.shape[0] == 1 and x.shape[0] != 1:
        y = y.expand(x.shape)
    xn = torch.sqrt(torch.square(x).sum(dim=-1, keepdim=True))
    yn = torch.sqrt(torch.square(y).sum(dim=-1, keepdim=True))
    o = (x * y).sum(dim=-1, keepdim=True) / (xn * yn + 1e-12)
    return {'Out': [o], 'XNorm': [xn], 'YNorm': [yn]}


@register_op('l1_norm')
def _l1_norm(ctx, ins, attrs):
    return out(abs_(first(ins, 'X').float()).sum().reshape(1))


@register_op('squared_l2_norm')
def _squared_l2_norm(ctx, ins, attrs):
    return out(torch.square(first(ins, 'X').float()).sum().reshape(1))


@register_op('squared_l2_distance')
def _squared_l2_distance(ctx, ins, attrs):
    """Per-row sum of (X - Y)^2 [N, 1] (a one-row Y against every row of
    X), and the difference ``sub_result``."""
    x = first(ins, 'X').float()
    y = first(ins, 'Y').float()
    if y.shape[0] == 1 and x.shape[0] != 1:
        y = y.expand(x.shape)
    diff = x - y
    o = torch.square(diff).reshape(x.shape[0], -1).sum(dim=1, keepdim=True)
    return {'Out': [o], 'sub_result': [diff]}


@register_op('norm')
def _norm(ctx, ins, attrs):
    """X L2-normalised along ``axis`` (operators/norm_op), the epsilon
    inside the root; ``Norm`` in float32."""
    x = first(ins, 'X')
    xf = x.float()
    norm = torch.sqrt(torch.square(xf).sum(dim=attrs.get('axis', 1),
                                           keepdim=True) +
                      attrs.get('epsilon', 1e-10))
    return {'Out': [(xf / norm).to(x.dtype)], 'Norm': [norm]}


@register_op('maxout')
def _maxout(ctx, ins, attrs):
    """The max over each run of ``groups`` channels of NCHW X; tied maxima
    share the cotangent evenly (``torch.amax``, as ``jnp.max``)."""
    x = first(ins, 'X')
    groups = attrs['groups']
    n, c, h, w = x.shape
    return out(torch.amax(x.reshape(n, c // groups, groups, h, w), dim=2))


@register_op('bilinear_tensor_product')
def _bilinear_tensor_product(ctx, ins, attrs):
    """Out[n, k] = X[n] @ Weight[k] @ Y[n] + Bias[k], accumulated in
    float32 and returned in X's dtype (operators/
    bilinear_tensor_product_op)."""
    x = first(ins, 'X')
    o = torch.einsum('ni,kij,nj->nk', x.float(), first(ins, 'Weight').float(),
                     first(ins, 'Y').float())
    b = first(ins, 'Bias')
    if b is not None:
        o = o + b.float().reshape(1, -1)
    return out(o.to(x.dtype))

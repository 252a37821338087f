"""Shared helpers for op implementations (paddle_tpu/ops/common.py)."""


def first(ins, slot):
    vals = ins.get(slot) or []
    return vals[0] if vals else None


def out(x):
    return {'Out': [x]}


def bcast_axis(x, y, axis):
    """Fluid elementwise broadcast: y's shape matches a contiguous run of
    x's shape starting at ``axis``; trailing 1s make torch broadcasting
    apply."""
    if x.dim() == y.dim():
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    return y.reshape(tuple(y.shape) + (1,) * (x.dim() - axis - y.dim()))


def prod(dims):
    p = 1
    for d in dims:
        p *= int(d)
    return p

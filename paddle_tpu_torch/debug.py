"""Failure detection: NaN / Inf guards.

Reference parity: paddle_tpu/debug.py (Fluid executor.cc
``FLAGS_check_nan_inf``: a per-op scan of outputs).  ``has_nan_inf``,
``check_nan_inf`` (the reference's message) and ``guarded_fetches`` check
values on the host.  ``nan_guard()`` and
``PADDLE_TPU_TORCH_CHECK_NAN_INF=1`` arm the executor's scan of every op's
outputs as it runs them (core/executor.py ``_run_one``): the first op
whose output holds a NaN or an Inf raises ``FloatingPointError`` naming
the op, its position and the output.  The reference arms
``jax.debug_nans`` instead, which makes XLA fault inside the fused step;
the port runs op by op, so it scans as Fluid's executor did.  Each scan
reads a flag back from the card, so only an armed guard syncs the host;
disarmed, the executor pays one module-attribute check an op.
"""
import contextlib

import numpy as np

from .flags import FLAGS

__all__ = ['has_nan_inf', 'check_nan_inf', 'nan_guard', 'guarded_fetches',
           'armed']

# read by core/executor.py for every op: a plain module attribute
ARMED = bool(FLAGS.check_nan_inf)
_depth = 0


def _array(value):
    import torch
    if torch.is_tensor(value):
        return value.detach().cpu().float().numpy() \
            if value.dtype == torch.bfloat16 else value.detach().cpu().numpy()
    return np.asarray(value)


def has_nan_inf(value):
    """True if the array or tensor holds any NaN or Inf."""
    arr = _array(value)
    if arr.dtype.kind not in 'fc':
        return False
    return bool(np.any(~np.isfinite(arr)))


def check_nan_inf(value, name='<tensor>'):
    """Raise RuntimeError if ``value`` has NaN or Inf (executor.cc's
    ``PADDLE_ENFORCE(!framework::HasInvalidValue(...))``); returns it."""
    if has_nan_inf(value):
        arr = _array(value)
        n_nan = int(np.isnan(arr).sum())
        n_inf = int(np.isinf(arr).sum())
        raise RuntimeError(
            "Tensor %s has %d NaN and %d Inf values" % (name, n_nan, n_inf))
    return value


def guarded_fetches(fetches, names=None):
    """Check every fetched value; returns the fetches unchanged."""
    for i, v in enumerate(fetches):
        check_nan_inf(v, names[i] if names else 'fetch[%d]' % i)
    return fetches


def armed():
    """True while the executor scans op outputs."""
    return ARMED


def reload_armed():
    """Re-read PADDLE_TPU_TORCH_CHECK_NAN_INF (an open guard stays)."""
    global ARMED
    ARMED = _depth > 0 or bool(FLAGS.check_nan_inf)


@contextlib.contextmanager
def nan_guard():
    """Scan every op output the executor computes in the enclosed region;
    the first op that writes a NaN or an Inf raises FloatingPointError
    naming it."""
    global ARMED, _depth
    _depth += 1
    ARMED = True
    try:
        yield
    finally:
        _depth -= 1
        ARMED = _depth > 0 or bool(FLAGS.check_nan_inf)


def scan_outputs(op, names, values, op_index):
    """The executor's armed check of one op's outputs: raise naming the
    op at the first output that holds a NaN or an Inf."""
    import torch
    from .core.selected_rows import SelectedRows
    for n, v in zip(names, values):
        if isinstance(v, SelectedRows):
            v = v.values
        if not torch.is_tensor(v) or not (v.is_floating_point() or
                                          v.is_complex()):
            continue
        if bool(torch.isfinite(v).all()):
            continue
        arr = _array(v)
        raise FloatingPointError(
            "nan_guard: op %r (#%d) wrote a non-finite value: Tensor %s has "
            "%d NaN and %d Inf values"
            % (op.type, op_index, n, int(np.isnan(arr).sum()),
               int(np.isinf(arr).sum())))

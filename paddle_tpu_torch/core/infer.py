"""Build-time shape and dtype inference.

Reference parity: paddle_tpu/core/infer.py (paddle/framework/
shape_inference.h).  One source of truth: the op's compute function,
run on ``meta`` tensors, which carry a shape and a dtype and no data.
The unknown batch dimension (-1) becomes a placeholder size on the way
in and -1 again on the way out, as the reference does around
``jax.eval_shape``.  An impl that reads a value into Python (``.item()``)
cannot run on meta tensors; inference is best effort and the caller
leaves such an op's declared shapes alone.
"""
import numpy as np
import torch

from . import datatypes
from .registry import get_op_impl

__all__ = ['infer_outputs', 'infer_outputs_cached']

# prime, unlikely to collide with a real dim (the reference's sentinel)
_BATCH_SENTINEL = 509
_META = torch.device('meta')
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


class _InferCtx(object):
    """Stand-in ExecutionContext for a meta-tensor run."""

    device = _META

    def generator(self, extra=0):
        return None


def _encode_ins(input_specs):
    """{slot: [(shape, dtype) | None]} -> ({slot: [meta tensor | None]},
    had_unknown) with -1 dims mapped to the batch sentinel."""
    had_unknown = False
    ins = {}
    for slot, specs in input_specs.items():
        vals = []
        for spec in specs:
            if spec is None:
                vals.append(None)
                continue
            shape, dtype = spec
            dims = []
            for d in shape:
                if d == -1:
                    had_unknown = True
                    dims.append(_BATCH_SENTINEL)
                else:
                    dims.append(int(d))
            # 64-bit values run in 32 bits, as the executor feeds them
            # and as the reference's inference narrows them
            tdtype = datatypes.as_torch_dtype(dtype)
            tdtype = _NARROW.get(tdtype, tdtype)
            vals.append(torch.empty(dims, dtype=tdtype, device=_META))
        ins[slot] = vals
    return ins, had_unknown


def _decode_outs(outs, out_slots, had_unknown):
    result = {}
    for slot in out_slots:
        specs = []
        for o in (outs or {}).get(slot, []):
            if not torch.is_tensor(o):
                specs.append(None)
                continue
            shape = tuple(-1 if (had_unknown and d == _BATCH_SENTINEL)
                          else int(d) for d in o.shape)
            specs.append((shape, datatypes.convert_dtype(o.dtype)))
        result[slot] = specs
    return result


def infer_outputs(op_type, input_specs, attrs, out_slots):
    """input_specs: {slot: [(shape, dtype) or None]}.  Returns
    {slot: [(shape, dtype) or None]} with -1 restored where the sentinel
    appears."""
    impl = get_op_impl(op_type)
    ins, had_unknown = _encode_ins(input_specs)
    with torch.no_grad():
        outs = impl.compute(_InferCtx(), ins, attrs)
    return _decode_outs(outs, out_slots, had_unknown)


_INFER_CACHE = {}
_INFER_CACHE_CAP = 65536
_FAILED = object()
# attrs that never affect shapes or dtypes: pass bookkeeping, so a
# build-time inference serves the verifier's post-pass lookup of the op
_NON_SEMANTIC_ATTRS = frozenset({'op_seq', 'op_role', 'amp_gate_var'})


class _Uncacheable(Exception):
    pass


def _hashable(v):
    if isinstance(v, np.ndarray):
        return ('nd', str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple((k, _hashable(v[k])) for k in sorted(v))
    if isinstance(v, (str, int, float, bool, bytes, type(None))):
        return v
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    raise _Uncacheable(type(v).__name__)


def _cache_key(op_type, input_specs, attrs, out_slots):
    return (op_type,
            tuple((slot,
                   tuple(None if s is None else (tuple(s[0]), str(s[1]))
                         for s in specs))
                  for slot, specs in sorted(input_specs.items())),
            tuple((k, _hashable(attrs[k])) for k in sorted(attrs)
                  if k not in _NON_SEMANTIC_ATTRS),
            tuple(out_slots))


def infer_outputs_cached(op_type, input_specs, attrs, out_slots):
    """``infer_outputs`` with a process-wide memo, failures included (an
    op that cannot run on meta tensors is not retried).  Raises what the
    compute function raises: the caller decides whether that is an
    error."""
    try:
        key = _cache_key(op_type, input_specs, attrs, out_slots)
    except _Uncacheable:
        return infer_outputs(op_type, input_specs, attrs, out_slots)
    hit = _INFER_CACHE.get(key)
    if hit is _FAILED:
        raise RuntimeError("op %r does not run on meta tensors" % op_type)
    if hit is not None:
        return hit
    if len(_INFER_CACHE) >= _INFER_CACHE_CAP:
        _INFER_CACHE.clear()
    try:
        result = infer_outputs(op_type, input_specs, attrs, out_slots)
    except Exception:
        _INFER_CACHE[key] = _FAILED
        raise
    _INFER_CACHE[key] = result
    return result

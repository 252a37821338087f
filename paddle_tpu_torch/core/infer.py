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
import torch

from . import datatypes
from .registry import get_op_impl

__all__ = ['infer_outputs']

# prime, unlikely to collide with a real dim (the reference's sentinel)
_BATCH_SENTINEL = 509
_META = torch.device('meta')


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
            vals.append(torch.empty(dims, dtype=datatypes.as_torch_dtype(
                dtype), device=_META))
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

"""Dtype names mapped to torch.

Reference parity: paddle_tpu/core/datatypes.py (paddle/framework/
data_type.h dtype strings), cut to the names the decode engine and the
transformer's training program use.
"""
import torch

__all__ = ['convert_dtype', 'as_torch_dtype', 'itemsize', 'is_float_dtype']

_STR2TORCH = {
    'bool': torch.bool,
    'uint8': torch.uint8,
    'int8': torch.int8,
    'int16': torch.int16,
    'float16': torch.float16,
    'bfloat16': torch.bfloat16,
    'float32': torch.float32,
    'float64': torch.float64,
    'int32': torch.int32,
    'int64': torch.int64,
}

_ALIASES = {
    'float': 'float32',
    'double': 'float64',
    'int': 'int32',
    'fp16': 'float16',
    'bf16': 'bfloat16',
    'fp32': 'float32',
    'fp64': 'float64',
}

_TORCH2STR = {v: k for k, v in _STR2TORCH.items()}


def convert_dtype(dtype):
    """Normalise a dtype spec (string or torch.dtype) to its canonical
    string name."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH2STR:
            raise ValueError("unsupported dtype: %r" % (dtype,))
        return _TORCH2STR[dtype]
    name = _ALIASES.get(dtype, dtype)
    if name not in _STR2TORCH:
        raise ValueError("unsupported dtype: %r" % (dtype,))
    return name


def as_torch_dtype(dtype):
    return _STR2TORCH[convert_dtype(dtype)]


def itemsize(dtype):
    """Bytes per element."""
    return torch.empty((), dtype=as_torch_dtype(dtype)).element_size()


def is_float_dtype(dtype):
    return as_torch_dtype(dtype).is_floating_point

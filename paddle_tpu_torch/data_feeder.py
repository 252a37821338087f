"""DataFeeder: reader minibatches (lists of samples) into feed dicts.

Reference parity: paddle_tpu/data_feeder.py (python/paddle/v2/fluid/
data_feeder.py).  Each field becomes one host array per feed variable:

- a dense field (``lod_level`` 0) is stacked and, where the samples'
  element count matches, reshaped to the variable's declared per-row
  shape (MNIST's flat 784 values become [1, 28, 28]; a scalar label
  becomes [1]);
- a ragged field becomes a ``LoDTensor`` (core/lod.py): padded rows with
  their lengths, which the executor feeds as ``name`` and ``name@LEN``.

64-bit types narrow to 32 bits, as the reference's converter does.  The
arrays stay on the host; the executor stages them on its device.
"""
import numpy as np

from .core import datatypes
from .core.lod import LoDTensor
from .core.program import Variable, default_main_program

__all__ = ['DataFeeder']

_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


class DataToLoDTensorConverter(object):
    def __init__(self, lod_level, shape, dtype):
        self.lod_level = lod_level
        self.shape = [int(d) for d in shape]
        dtype = np.dtype(datatypes.convert_dtype(dtype))
        self.dtype = _NARROW.get(dtype, dtype)
        self.data = []

    def feed(self, data):
        self.data.append(data)

    def done(self):
        if self.lod_level == 0:
            arr = np.array(self.data, dtype=self.dtype)
            shape = [d for d in self.shape if d != -1]
            if shape and list(arr.shape[1:]) != shape and \
                    int(np.prod(arr.shape[1:], dtype=np.int64)) == \
                    int(np.prod(shape)):
                arr = arr.reshape([arr.shape[0]] + shape)
            return arr
        return LoDTensor([np.asarray(s, dtype=self.dtype)
                          for s in self.data])


class DataFeeder(object):
    def __init__(self, feed_list, place, program=None):
        if program is None:
            program = default_main_program()
        self.feed_names, self.feed_shapes = [], []
        self.feed_dtypes, self.feed_lod_level = [], []
        for var in feed_list:
            if isinstance(var, str):
                var = program.global_block().var(var)
            if not isinstance(var, Variable):
                raise TypeError("Feed list should contain Variables")
            self.feed_names.append(var.name)
            self.feed_shapes.append(list(var.shape))
            self.feed_dtypes.append(var.dtype)
            self.feed_lod_level.append(var.lod_level)
        self.place = place

    def feed(self, iterable):
        """{name: host array or LoDTensor} for one minibatch."""
        converters = [
            DataToLoDTensorConverter(lod, shape, dtype)
            for lod, shape, dtype in zip(
                self.feed_lod_level, self.feed_shapes, self.feed_dtypes)]
        for sample in iterable:
            if len(sample) != len(converters):
                raise ValueError(
                    "The number of fields in data (%d) does not match the "
                    "number of feed vars (%d)"
                    % (len(sample), len(converters)))
            for conv, field in zip(converters, sample):
                conv.feed(field)
        return {name: conv.done()
                for name, conv in zip(self.feed_names, converters)}

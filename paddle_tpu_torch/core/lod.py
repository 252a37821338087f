"""Host-side ragged tensor container.

Reference parity: paddle_tpu/core/lod.py (paddle/framework/lod_tensor.{h,
cc}, offset-based LoD), copied so that the port imports nothing of the
reference.  Sequences are padded to a rectangle and carried with an int32
lengths vector; on the device, sequence ops mask with the lengths
(ops/sequence.py, ops/rnn.py).  This class is the host bridge: it accepts
the reference's recursive_sequence_lengths / offset LoD and produces
(padded, lengths), which the executor feeds as ``name`` and ``name@LEN``.
"""
import numpy as np

__all__ = ['LoDTensor', 'create_lod_tensor']


def _offsets_to_lengths(offsets):
    return [int(offsets[i + 1]) - int(offsets[i])
            for i in range(len(offsets) - 1)]


class LoDTensor(object):
    def __init__(self, data=None, recursive_seq_lens=None):
        """`data` is either a dense np array, or a list of per-sequence
        arrays/lists (ragged).  `recursive_seq_lens` follows the fluid
        convention: a list of lod levels, each a list of lengths."""
        self._lengths = None
        self._padded = None
        if recursive_seq_lens:
            # only the innermost level determines padding; outer levels are
            # kept for API parity.
            self._rec_lens = [list(l) for l in recursive_seq_lens]
            self._lengths = list(self._rec_lens[-1])
            total = sum(self._lengths)
            if isinstance(data, (list, tuple)) and len(data) and \
                    not np.isscalar(data[0]) and len(data) != total and \
                    sum(len(s) for s in data) == total:
                # list of per-sequence lists (ragged or equal-length):
                # concatenate to flat [sum(lengths), ...] form
                data = np.concatenate([np.asarray(s) for s in data], axis=0)
            self._flat = np.asarray(data)
        else:
            self._rec_lens = []
            if isinstance(data, (list, tuple)) and len(data) and \
                    not np.isscalar(data[0]) and \
                    _is_ragged_list(data):
                seqs = [np.asarray(s) for s in data]
                self._lengths = [len(s) for s in seqs]
                self._flat = (np.concatenate(seqs, axis=0)
                              if len(seqs) else np.zeros((0,)))
                self._rec_lens = [list(self._lengths)]
            else:
                self._padded = np.asarray(data)

    # -- fluid parity ------------------------------------------------------
    def set(self, data, place=None):
        self._padded = np.asarray(data)
        return self

    def set_recursive_sequence_lengths(self, rec_lens):
        self._rec_lens = [list(l) for l in rec_lens]
        self._lengths = list(self._rec_lens[-1])
        if self._padded is not None and self._lengths is not None and \
                self._padded.ndim >= 1 and \
                self._padded.shape[0] == sum(self._lengths):
            self._flat = self._padded
            self._padded = None
        return self

    def recursive_sequence_lengths(self):
        return self._rec_lens

    def set_lod(self, lod):
        """Offset-based LoD (old API)."""
        return self.set_recursive_sequence_lengths(
            [_offsets_to_lengths(l) for l in lod])

    def lod(self):
        out = []
        for lens in self._rec_lens:
            off = [0]
            for l in lens:
                off.append(off[-1] + l)
            out.append(off)
        return out

    # -- padded bridge ---------------------------------------------------
    def is_ragged(self):
        return self._lengths is not None

    def lengths(self):
        if self._lengths is None:
            n = self._padded.shape[0] if self._padded.ndim else 0
            return [1] * n
        return self._lengths

    def padded(self, pad_value=0):
        if self._padded is not None:
            return self._padded
        lens = self._lengths
        batch = len(lens)
        maxlen = max(lens) if lens else 0
        flat = self._flat
        trailing = flat.shape[1:]
        out = np.full((batch, maxlen) + trailing, pad_value,
                      dtype=flat.dtype)
        pos = 0
        for i, l in enumerate(lens):
            out[i, :l] = flat[pos:pos + l]
            pos += l
        return out

    def flat(self):
        if self._padded is not None and self._lengths is None:
            return self._padded
        if getattr(self, '_flat', None) is not None:
            return self._flat
        lens = self._lengths
        return np.concatenate(
            [self.padded()[i, :l] for i, l in enumerate(lens)], axis=0)

    def __array__(self, dtype=None):
        arr = self.padded() if self.is_ragged() else self._padded
        return arr.astype(dtype) if dtype is not None else arr

    def shape(self):
        return tuple(np.asarray(self).shape)

    def __repr__(self):
        return "LoDTensor(shape=%s, rec_lens=%s)" % (
            np.asarray(self).shape, self._rec_lens)


def _is_ragged_list(data):
    try:
        first = len(data[0])
    except TypeError:
        return False
    return any(len(s) != first for s in data)


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Parity with fluid.create_lod_tensor."""
    return LoDTensor(data, recursive_seq_lens)

"""Dataset commons (paddle_tpu/datasets/common.py, python/paddle/v2/
dataset/common.py): the per-split generator, the synthetic-text helpers,
and the chunk-file tools: ``convert`` (a reader into record files, read
back by ``reader.creator.recordio``), ``split`` and
``cluster_files_reader`` (pickled chunk files, each trainer reading its
share).

No dataset is downloaded: every module makes its samples from a
deterministic generator.  ``rng_for`` keys it by the reference's string,
'paddle_tpu:<name>:<split>', so both packages yield the same samples.
"""
import glob
import hashlib
import os
import pickle

import numpy as np

__all__ = ['rng_for', 'zipf_seq', 'seq_lengths', 'convert', 'split',
           'cluster_files_reader']


def rng_for(name, split='train'):
    """The deterministic numpy Generator of one (dataset, split)."""
    h = hashlib.md5(('paddle_tpu:%s:%s' % (name, split)).encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], 'little'))


def zipf_seq(rng, length, vocab_size, low=0):
    """Zipf(1.3)-distributed token ids in [low, vocab_size), as natural
    token frequencies fall."""
    ranks = rng.zipf(1.3, size=length)
    return (low + (ranks - 1) % (vocab_size - low)).astype(np.int64)


def seq_lengths(rng, n, lo, hi):
    """``n`` sequence lengths, roughly geometric, clipped to [lo, hi]."""
    raw = rng.geometric(2.0 / (lo + hi), size=n)
    return np.clip(raw, lo, hi).astype(np.int64)


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Pickle a reader's samples into chunk files ``suffix % i`` (the
    reference's ``common.split``, its chunking included: the first chunk
    closes after sample ``line_count``, each later one every
    ``line_count`` samples)."""
    dumper = dumper or pickle.dump
    indx_f = 0
    lines = []
    for i, d in enumerate(reader()):
        lines.append(d)
        if i >= line_count and i % line_count == 0:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
                lines = []
                indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """A creator over the chunk files matching ``files_pattern`` that
    trainer ``trainer_id`` of ``trainer_count`` owns (every
    trainer_count-th file of the sorted list)."""
    loader = loader or pickle.load

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        my_file_list = [f for i, f in enumerate(file_list)
                        if i % trainer_count == trainer_id]
        for fn in my_file_list:
            with open(fn, "rb") as f:
                for line in loader(f):
                    yield line

    return reader


def convert(output_path, reader, line_count, name_prefix):
    """Write a reader's samples, pickled, into record files
    ``<output_path>/<name_prefix>-NNNNN`` of ``line_count`` samples each
    (io_recordio.py's format; the reference writes the same files through
    its native writer).  Read them back with
    ``reader.creator.recordio``."""
    from ..io_recordio import RecordWriter
    indx_f = 0
    lines = []

    def flush():
        nonlocal indx_f, lines
        if not lines:
            return
        path = os.path.join(output_path, "%s-%05d" % (name_prefix, indx_f))
        with RecordWriter(path) as w:
            for d in lines:
                w.write(pickle.dumps(d))
        lines = []
        indx_f += 1

    for d in reader():
        lines.append(d)
        if len(lines) >= line_count:
            flush()
    flush()

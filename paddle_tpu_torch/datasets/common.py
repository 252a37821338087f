"""Dataset commons (paddle_tpu/datasets/common.py, python/paddle/v2/
dataset/common.py), cut to what the synthetic sets use: the per-split
generator and the synthetic-text helpers.

No dataset is downloaded: every module makes its samples from a
deterministic generator.  ``rng_for`` keys it by the reference's string,
'paddle_tpu:<name>:<split>', so both packages yield the same samples.
"""
import hashlib

import numpy as np

__all__ = ['rng_for', 'zipf_seq', 'seq_lengths']


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

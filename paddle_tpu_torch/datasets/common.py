"""Dataset commons (paddle_tpu/datasets/common.py, python/paddle/v2/
dataset/common.py), cut to what the synthetic image sets use.

No dataset is downloaded: every module makes its samples from a
deterministic generator.  ``rng_for`` keys it by the reference's string,
'paddle_tpu:<name>:<split>', so both packages yield the same samples.
"""
import hashlib

import numpy as np

__all__ = ['rng_for']


def rng_for(name, split='train'):
    """The deterministic numpy Generator of one (dataset, split)."""
    h = hashlib.md5(('paddle_tpu:%s:%s' % (name, split)).encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], 'little'))

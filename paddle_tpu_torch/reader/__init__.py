"""Reader pipelines: composable Python iterator factories.

Reference parity: paddle_tpu/reader (python/paddle/v2/reader and
python/paddle/v2/minibatch.py).  A reader creator is a callable with no
arguments that returns an iterator over samples; decorators wrap
creators; ``batch`` groups samples into minibatches.
"""
from . import creator
from .decorator import (ComposeNotAligned, buffered, cache, chain, compose,
                        firstn, map_readers, metered, shuffle, xmap_readers)
from .minibatch import batch

__all__ = ['map_readers', 'buffered', 'compose', 'chain', 'shuffle',
           'firstn', 'xmap_readers', 'cache', 'metered', 'ComposeNotAligned',
           'batch', 'creator']

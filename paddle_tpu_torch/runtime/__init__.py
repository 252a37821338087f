"""The feed runtime: the native queue, record files and arena (C++, built
at first use), pinned-memory staging on a side stream, and prefetch.

Reference parity: paddle_tpu/runtime/.
"""
from .native import (available, NativeBuildError, NativeQueue,
                     NativeRecordReader, NativeRecordWriter, StagingArena)
from .prefetch import (device_prefetch, prefetch_reader, stage_columns,
                       xmap_native)
from .feed import DeviceStager, FeedPipeline

__all__ = ['available', 'NativeBuildError', 'NativeQueue',
           'NativeRecordReader', 'NativeRecordWriter', 'StagingArena',
           'prefetch_reader', 'xmap_native', 'device_prefetch',
           'stage_columns', 'DeviceStager', 'FeedPipeline']

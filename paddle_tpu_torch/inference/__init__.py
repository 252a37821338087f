"""Serving: exported-program inference (``InferenceServer``), adaptive
batching over bucketed artifacts (``BatchingInferenceServer``), and the
autoregressive decode engine and server.

Reference parity: paddle_tpu/inference/__init__.py, less the AOT cache,
the tenancy registry and the serving fleet (ROADMAP.md Queue 1 item 8b).
"""
from .serving import export_inference, load_exported, InferenceServer
from .batching import (BatchingInferenceServer, bucket_sizes,
                       export_bucketed)
from .decode import (DecodeEngine, DecodeServer, DecodeStream,
                     decode_buckets, extract_params)

__all__ = ['export_inference', 'load_exported', 'InferenceServer',
           'BatchingInferenceServer', 'export_bucketed', 'bucket_sizes',
           'DecodeEngine', 'DecodeServer', 'DecodeStream',
           'decode_buckets', 'extract_params']

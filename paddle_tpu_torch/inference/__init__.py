"""Serving: exported-program inference (``InferenceServer``), adaptive
batching over bucketed artifacts (``BatchingInferenceServer``), the AOT
cache of readied buckets, the serving fleet with its tenancy registry,
and the autoregressive decode engine and server.

Reference parity: paddle_tpu/inference/__init__.py.
"""
from .serving import export_inference, load_exported, InferenceServer
from .batching import (BatchingInferenceServer, bucket_sizes,
                       export_bucketed)
from .decode import (DecodeEngine, DecodeServer, DecodeStream,
                     decode_buckets, extract_params)
from .fleet import ServingFleet
from .aot_cache import AotCache
from .tenancy import AdmissionError, TenantRegistry, SLO_CLASSES

__all__ = ['export_inference', 'load_exported', 'InferenceServer',
           'BatchingInferenceServer', 'export_bucketed', 'bucket_sizes',
           'DecodeEngine', 'DecodeServer', 'DecodeStream',
           'decode_buckets', 'extract_params',
           'ServingFleet', 'AotCache', 'AdmissionError',
           'TenantRegistry', 'SLO_CLASSES']

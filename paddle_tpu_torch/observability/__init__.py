"""Observability: the metrics registry, span tracing, the step timeline
and exposition.

Reference parity: paddle_tpu/observability/, the same names and the same
metric, span, category and event names.

- :mod:`metrics`: the process-wide, thread-safe registry of ``Counter`` /
  ``Gauge`` / ``Histogram`` (labels, bounded buckets).
- :mod:`tracing`: ``span("executor.run")`` feeding the registry, the
  timeline ring when armed, and ``torch.profiler.record_function``.
- :mod:`timeline`: the step-timeline flight recorder, one bounded ring of
  phase events exported as Chrome ``trace_event`` JSON
  (``PADDLE_TPU_TORCH_TRACE_DIR``) with last-N-steps crash dumps
  (``PADDLE_TPU_TORCH_TRACE_DUMP_ON_ERROR``); profiler.py's RecordEvent
  records into the same ring.
- :mod:`exporters`: Prometheus text exposition and a JSON snapshot.
- :mod:`http`: the opt-in ``/metrics`` + ``/healthz`` endpoint
  (``serve_metrics(port)``, or ``PADDLE_TPU_TORCH_METRICS_PORT``).

Instrumented layers: core/executor.py (plan cache, plan builds, runs,
steps, feed bytes and puts), the servers (inference/batching.py,
decode.py, fleet.py, serving.py, aot_cache.py), the reader decorators.
Disabled (``PADDLE_TPU_TORCH_METRICS_ENABLED=0``), the executor and
reader sites cost one cached-bool check and spans collapse to a shared
no-op.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_COMPILE_BUCKETS, DEFAULT_LATENCY_BUCKETS,
                      enabled, registry, reload_enabled, set_enabled)
from .tracing import span
from .exporters import json_snapshot, prometheus_text
from .http import (MetricsHTTPServer, healthz_report,
                   maybe_serve_from_env, register_healthz,
                   serve_metrics, unregister_healthz)
from . import timeline

__all__ = [
    'Counter', 'Gauge', 'Histogram', 'MetricsRegistry',
    'DEFAULT_COMPILE_BUCKETS', 'DEFAULT_LATENCY_BUCKETS',
    'enabled', 'set_enabled', 'reload_enabled', 'registry', 'span',
    'prometheus_text', 'json_snapshot', 'snapshot',
    'MetricsHTTPServer', 'serve_metrics', 'maybe_serve_from_env',
    'register_healthz', 'unregister_healthz', 'healthz_report',
    'counter', 'gauge', 'histogram', 'timeline',
]


def counter(name, help='', labelnames=()):
    """Get-or-create a Counter in the global registry."""
    return registry().counter(name, help, labelnames)


def gauge(name, help='', labelnames=()):
    """Get-or-create a Gauge in the global registry."""
    return registry().gauge(name, help, labelnames)


def histogram(name, help='', labelnames=(),
              buckets=DEFAULT_LATENCY_BUCKETS):
    """Get-or-create a Histogram in the global registry."""
    return registry().histogram(name, help, labelnames, buckets=buckets)


def snapshot():
    """JSON-serializable snapshot of the global registry (the dict the
    JSON exporter serializes)."""
    return registry().snapshot()

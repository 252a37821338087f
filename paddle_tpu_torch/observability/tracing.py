"""Span tracing that feeds the registry and annotates profiler traces.

Reference parity: paddle_tpu/observability/tracing.py.
``span("executor.run")`` is a context manager that does three things at
once:

- feeds its wall-clock duration into the registry histogram
  ``paddle_tpu_span_seconds{span="executor.run"}``, so /metrics carries
  per-region latency distributions with no profiler attached;
- when the flight recorder is armed, records the same region on the
  timeline ring (category ``span``);
- annotates the profiler trace with ``torch.profiler.record_function``
  (the reference's ``jax.profiler.TraceAnnotation``), so a captured
  trace (profiler.py) shows the region by name.

When metrics are disabled, ``span()`` returns one shared no-op object: no
allocation, no annotation, no clock read.
"""
import threading
import time

from . import metrics as _metrics
from . import timeline as _timeline

__all__ = ['span']

_lock = threading.Lock()
_span_children = {}  # span name -> histogram child handle


class _NullSpan(object):
    """Shared do-nothing span for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _child(name):
    child = _span_children.get(name)
    if child is None:
        hist = _metrics.registry().histogram(
            'paddle_tpu_span_seconds',
            'wall-clock duration of named host-side spans',
            labelnames=('span',))
        child = hist.labels(span=name)
        with _lock:
            _span_children.setdefault(name, child)
    return child


class _Span(object):
    __slots__ = ('_child', '_ann', '_t0', '_name')

    def __init__(self, child, ann, name):
        self._child = child
        self._ann = ann
        self._name = name

    def __enter__(self):
        if self._ann is not None:
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self._child.observe(dur)
        # when the flight recorder is armed, the same region lands on
        # the step timeline (one measurement, two sinks)
        tl = _timeline.ring_if_armed()
        if tl is not None:
            tl.record(self._name, cat='span', t0=self._t0, dur=dur)
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False


def span(name, annotate=True):
    """Context manager timing a host-side region into the registry.

    :param name: dotted region name (``"executor.run"``); becomes the
        ``span`` label on ``paddle_tpu_span_seconds``.
    :param annotate: also open a ``torch.profiler.record_function`` so
        the region shows in captured profiler traces.
    :returns: the shared no-op span when metrics are disabled.
    """
    if not _metrics.enabled():
        return _NULL_SPAN
    ann = None
    if annotate:
        from torch.profiler import record_function
        ann = record_function(name)
    return _Span(_child(name), ann, name)

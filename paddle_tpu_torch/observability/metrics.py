"""Thread-safe metrics primitives: the part the servers read.

Reference parity: paddle_tpu/observability/metrics.py, cut to
Prometheus-style ``Counter`` / ``Gauge`` / ``Histogram`` families with
labels, collected in a ``MetricsRegistry``.  Exporters and the HTTP
endpoint are not ported yet.  Metric names are restricted to ``[a-z_]+``
(digits go in label values), as in the reference.
"""
import re
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'MetricsRegistry',
           'DEFAULT_LATENCY_BUCKETS']

_NAME_RE = re.compile(r'^[a-z_]+$')

# seconds; spans request-serving latencies from 100us to 10s
DEFAULT_LATENCY_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0)


class _Metric(object):
    """A named family of label-keyed children sharing one lock."""
    kind = None

    def __init__(self, name, help='', labelnames=()):
        if not _NAME_RE.match(name):
            raise ValueError("metric name %r must match [a-z_]+" % (name,))
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}

    def _key(self, kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                "metric %s takes labels %s, got %s"
                % (self.name, sorted(self.labelnames), sorted(kv)))
        return tuple(str(kv[n]) for n in self.labelnames)

    def labels(self, **kv):
        key = self._key(kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def remove(self, **kv):
        """Drop one label combination's child (a closed server's series
        stops exporting); handles to it keep working."""
        key = self._key(kv)
        with self._lock:
            self._children.pop(key, None)


class _CounterChild(object):
    __slots__ = ('_lock', '_value')

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Counter(_Metric):
    """Monotonically increasing count."""
    kind = 'counter'

    def _make_child(self):
        return _CounterChild(self._lock)


class _GaugeChild(object):
    __slots__ = ('_lock', '_value')

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Instantaneous level (queue depth, active streams)."""
    kind = 'gauge'

    def _make_child(self):
        return _GaugeChild(self._lock)


class _HistogramChild(object):
    __slots__ = ('_lock', '_bounds', '_counts', '_count', '_sum', '_max')

    def __init__(self, lock, bounds):
        self._lock = lock
        self._bounds = bounds  # ascending upper bounds, +Inf implicit
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, value):
        v = float(value)
        i = 0
        while i < len(self._bounds) and v > self._bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._max = max(self._max, v)

    def quantile(self, q):
        """The q-quantile (0..1) by linear interpolation inside the
        bucket that holds it (Prometheus' histogram_quantile), the
        overflow bucket clamped to the largest observation."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1], got %r" % q)
        with self._lock:
            if not self._count:
                return 0.0
            rank = q * self._count
            cum, lo = 0, 0.0
            for ub, c in zip(self._bounds, self._counts):
                if c and cum + c >= rank:
                    return min(lo + (ub - lo) * (rank - cum) / c, self._max)
                cum += c
                lo = ub
            return self._max

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum


class Histogram(_Metric):
    """Bounded-bucket distribution: fixed bucket table + count/sum."""
    kind = 'histogram'

    def __init__(self, name, help='', labelnames=(),
                 buckets=DEFAULT_LATENCY_BUCKETS):
        super(Histogram, self).__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or any(b != b or b == float('inf') for b in bounds):
            raise ValueError("histogram needs finite bucket bounds (the "
                             "+Inf bucket is implicit)")
        self.bucket_bounds = bounds

    def _make_child(self):
        return _HistogramChild(self._lock, self.bucket_bounds)


_KINDS = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class MetricsRegistry(object):
    """Name -> metric map with get-or-create semantics: asking twice for
    the same (name, kind, labelnames) shares one metric, and a kind or
    label mismatch is an error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, kind, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _KINDS[kind](name, help, labelnames, **kw)
                self._metrics[name] = m
            elif m.kind != kind or m.labelnames != tuple(labelnames):
                raise ValueError(
                    "metric %r already registered as a %s with labels %s"
                    % (name, m.kind, m.labelnames))
            return m

    def counter(self, name, help='', labelnames=()):
        return self._get_or_create('counter', name, help, labelnames)

    def gauge(self, name, help='', labelnames=()):
        return self._get_or_create('gauge', name, help, labelnames)

    def histogram(self, name, help='', labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS):
        return self._get_or_create('histogram', name, help, labelnames,
                                   buckets=buckets)

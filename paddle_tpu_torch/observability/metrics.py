"""Process-wide, thread-safe metrics registry.

Reference parity: paddle_tpu/observability/metrics.py, the same
Prometheus-style ``Counter`` / ``Gauge`` / ``Histogram`` families with
labels, collected in a registry that exporters.py renders as Prometheus
text or a JSON snapshot and http.py serves at ``/metrics``.  Metric names
are the reference's, letter for letter, so a scrape of either package
reads the same way.

- Zero cost when disabled: every instrumented site in the executor and
  the readers checks :func:`enabled` (one cached bool) before it touches
  the registry, so ``PADDLE_TPU_TORCH_METRICS_ENABLED=0`` allocates
  nothing, takes no lock and makes no span on the hot path.
- Host side only: metrics record wall-clock facts about calls, queues and
  caches, never a value on the card, so nothing here syncs the device.
- Bounded memory: a histogram holds a fixed bucket table and count, sum,
  min and max.

Metric names are restricted to ``[a-z_]+`` (digits go in label values),
so every exposition sample line matches
``^[a-z_]+(\\{[^}]*\\})? <value>$``.
"""
import re
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'MetricsRegistry',
           'registry', 'enabled', 'set_enabled', 'reload_enabled',
           'DEFAULT_LATENCY_BUCKETS', 'DEFAULT_COMPILE_BUCKETS']

_NAME_RE = re.compile(r'^[a-z_]+$')

# seconds; spans request-serving latencies from 100us to 10s
DEFAULT_LATENCY_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0)

# seconds; plan builds and bucket loads run milliseconds to minutes
DEFAULT_COMPILE_BUCKETS = (
    1e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0)


# -- enabled switch --------------------------------------------------------
# Resolved lazily from FLAGS.metrics_enabled on first query and cached:
# the hot layers call enabled() per run()/submit(), and an os.environ
# read per call would itself be measurable overhead.
_enabled = None


def enabled():
    """True when instrumentation is armed (PADDLE_TPU_TORCH_METRICS_ENABLED,
    default on).  Cached after the first read; set_enabled() overrides,
    reload_enabled() re-reads the flag."""
    global _enabled
    if _enabled is None:
        from ..flags import FLAGS
        _enabled = bool(FLAGS.metrics_enabled)
    return _enabled


def set_enabled(value):
    """Force the instrumentation switch (tests; runtime opt-out)."""
    global _enabled
    _enabled = bool(value)


def reload_enabled():
    """Drop the cached switch so the next enabled() re-reads the flag."""
    global _enabled
    _enabled = None


# -- metric primitives -----------------------------------------------------
class _Metric(object):
    """Base: a named family of label-keyed children sharing one lock.

    ``labels(**kv)`` returns (creating once) the child for a label
    combination; instrument sites hold child handles, so the per-event
    cost is one lock + one float op, never a dict lookup by name.
    """
    kind = None

    def __init__(self, name, help='', labelnames=()):
        if not _NAME_RE.match(name):
            raise ValueError(
                "metric name %r must match [a-z_]+ (digits go in label "
                "values, not names — the exposition contract)" % (name,))
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                "metric %s takes labels %s, got %s"
                % (self.name, sorted(self.labelnames), sorted(kv)))
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child(key)
                self._children[key] = child
            return child

    def _default(self):
        """The unlabeled child (metrics declared without labelnames).
        Hot instrument sites should hold this child directly (one lock
        per event) instead of going through the metric-level
        conveniences (label lookup + two locks per event)."""
        return self.labels()

    def child(self):
        """Public alias of the unlabeled child, for hot-path handles."""
        return self.labels()

    def remove(self, **kv):
        """Drop one label combination's child (series retirement: a
        closed server's gauges must not export stale values forever,
        and a process cycling servers must not grow the registry
        without bound).  Handles to the removed child keep working but
        no longer export."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                "metric %s takes labels %s, got %s"
                % (self.name, sorted(self.labelnames), sorted(kv)))
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    def _samples(self):
        """[(label_values_tuple, child)] for exporters, sorted."""
        with self._lock:
            return sorted(self._children.items())


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
    """Monotonically increasing count (requests served, bytes staged)."""
    kind = 'counter'

    def _make_child(self, key):
        return _CounterChild(self._lock)

    def inc(self, amount=1):
        self._default().inc(amount)

    @property
    def value(self):
        return self._default().value


class _GaugeChild(object):
    __slots__ = ('_lock', '_value', '_fn')

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0
        self._fn = None

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def set_function(self, fn):
        """Make this gauge PULL its value: ``fn()`` is called at every
        read (exposition scrape, snapshot, ``.value``) instead of the
        stored level.  The natural fit for values that are already live
        state somewhere else — a fleet's aggregate queue depth, a pool
        size — where push-updating on every transition would scatter
        bookkeeping across the owner's code paths.  ``fn`` must be fast
        and thread-safe; it is invoked OUTSIDE the metric lock (it may
        take the owner's own locks without deadlocking a concurrent
        scrape), and any exception falls back to the last pushed value
        rather than failing the scrape.  ``set_function(None)`` reverts
        to push mode."""
        with self._lock:
            self._fn = fn

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            fn = self._fn
            v = self._value
        if fn is None:
            return v
        try:
            return float(fn())
        except Exception:
            return v


class Gauge(_Metric):
    """Instantaneous level (queue depth, batches in flight).  Children
    are push-style (``set``/``inc``/``dec``) by default; ``set_function``
    turns one into a pull-style callback gauge read at scrape time."""
    kind = 'gauge'

    def _make_child(self, key):
        return _GaugeChild(self._lock)

    def set(self, value):
        self._default().set(value)

    def set_function(self, fn):
        self._default().set_function(fn)

    def inc(self, amount=1):
        self._default().inc(amount)

    def dec(self, amount=1):
        self._default().dec(amount)

    @property
    def value(self):
        return self._default().value


class _HistogramChild(object):
    __slots__ = ('_lock', '_bounds', '_counts', '_count', '_sum',
                 '_min', '_max')

    def __init__(self, lock, bounds):
        self._lock = lock
        self._bounds = bounds  # ascending upper bounds, +Inf implicit
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, value):
        v = float(value)
        # bisect by hand: bucket tables are short (~16) and the linear
        # scan beats bisect's call overhead at this size
        i = 0
        bounds = self._bounds
        n = len(bounds)
        while i < n and v > bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def quantile(self, q):
        """Estimate the q-quantile (0..1) by linear interpolation inside
        the containing bucket — the standard Prometheus histogram_quantile
        rule, with the overflow bucket clamped to the observed max so a
        p99 never reads as +Inf."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1], got %r" % q)
        with self._lock:
            total = self._count
            if not total:
                return 0.0
            rank = q * total
            cum = 0
            lo = 0.0
            for ub, c in zip(self._bounds, self._counts):
                if c and cum + c >= rank:
                    frac = (rank - cum) / c
                    return min(lo + (ub - lo) * frac, self._max)
                cum += c
                lo = ub
            # rank landed in the +Inf overflow bucket
            return self._max

    def snapshot(self):
        with self._lock:
            cum, buckets = 0, []
            for ub, c in zip(self._bounds, self._counts):
                cum += c
                buckets.append((ub, cum))
            buckets.append((float('inf'), self._count))
            return {'count': self._count, 'sum': self._sum,
                    'min': self._min, 'max': self._max,
                    'buckets': buckets}


class Histogram(_Metric):
    """Bounded-bucket distribution (latency, occupancy): fixed bucket
    table + count/sum/min/max, O(buckets) memory forever."""
    kind = 'histogram'

    def __init__(self, name, help='', labelnames=(),
                 buckets=DEFAULT_LATENCY_BUCKETS):
        super(Histogram, self).__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b != b or b == float('inf') for b in bounds):
            raise ValueError("bucket bounds must be finite (the +Inf "
                             "bucket is implicit)")
        self.bucket_bounds = bounds

    def _make_child(self, key):
        return _HistogramChild(self._lock, self.bucket_bounds)

    def observe(self, value):
        self._default().observe(value)

    def quantile(self, q):
        return self._default().quantile(q)

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum


# -- registry --------------------------------------------------------------
_KINDS = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class MetricsRegistry(object):
    """Name -> metric map with get-or-create semantics: two subsystems
    asking for the same (name, kind, labelnames) share one metric, and a
    kind/label mismatch is a hard error, not a silent shadow."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, kind, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        "metric %r already registered as a %s, not a %s"
                        % (name, m.kind, kind))
                if m.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %r already registered with labels %s, "
                        "not %s" % (name, m.labelnames, tuple(labelnames)))
                if kind == 'histogram':
                    want = tuple(sorted(float(b) for b in kw['buckets']))
                    if m.bucket_bounds != want:
                        raise ValueError(
                            "histogram %r already registered with "
                            "buckets %s, not %s" % (name, m.bucket_bounds,
                                                    want))
                return m
            m = _KINDS[kind](name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help='', labelnames=()):
        return self._get_or_create('counter', name, help, labelnames)

    def gauge(self, name, help='', labelnames=()):
        return self._get_or_create('gauge', name, help, labelnames)

    def histogram(self, name, help='', labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS):
        return self._get_or_create('histogram', name, help, labelnames,
                                   buckets=buckets)

    def collect(self):
        """Metrics sorted by name (the exporter iteration order)."""
        with self._lock:
            return [m for _, m in sorted(self._metrics.items())]

    def snapshot(self):
        """JSON-serializable {name: {type, help, samples: [...]}}.

        Counter/gauge samples are ``{labels, value}``; histogram samples
        carry ``{labels, count, sum, min, max, buckets}`` with buckets as
        ``[[upper_bound, cumulative_count], ...]`` (+Inf spelled "+Inf").
        """
        out = {}
        for m in self.collect():
            samples = []
            for key, child in m._samples():
                labels = dict(zip(m.labelnames, key))
                if m.kind == 'histogram':
                    s = child.snapshot()
                    samples.append({
                        'labels': labels,
                        'count': s['count'], 'sum': s['sum'],
                        'min': s['min'], 'max': s['max'],
                        'buckets': [
                            ['+Inf' if ub == float('inf') else ub, c]
                            for ub, c in s['buckets']]})
                else:
                    samples.append({'labels': labels,
                                    'value': child.value})
            out[m.name] = {'type': m.kind, 'help': m.help,
                           'samples': samples}
        return out


_REGISTRY = MetricsRegistry()


def registry():
    """The process-wide registry every instrumented layer reports to."""
    return _REGISTRY

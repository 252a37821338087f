"""Opt-in runtime lock watchdog (``PADDLE_TPU_TORCH_LOCK_DEBUG=1``).

The port's copy of paddle_tpu/analysis/lockdebug.py.  The static
analyzer (:mod:`.concurrency`) proves properties of the code it can see;
this module checks the executions it cannot.  The threaded modules
create their locks through ``make_lock`` / ``make_rlock`` /
``make_condition``; armed, every acquisition is pushed on a per-thread
stack and checked against the acquisition-order graph: the static
analyzer's edges over ``paddle_tpu_torch/`` (loaded once, lazily) joined
with the orders this process has already shown.  Acquiring B while
holding A where the graph says B before A is a lock-order violation:
counted in ``paddle_tpu_lock_order_violations_total`` and recorded
(thread, held locks, site) in :func:`violations`.

Disarmed, the factories return plain ``threading.Lock`` / ``RLock`` /
``Condition`` objects, so an acquisition costs what the primitive costs.
The flag is read when a lock is made, not when it is taken.

Lock names follow the analyzer's ``<ClassName>.<attr>``; two conditions
over one lock share one name, one node of the graph.
"""
import threading
import traceback

__all__ = ['enabled', 'set_enabled', 'reload_enabled', 'make_lock',
           'make_rlock', 'make_condition', 'violations',
           'order_edges', 'install_static_edges', 'load_static_edges',
           'reset_state']

# -- enabled switch --------------------------------------------------------
# The flag is read LIVE per factory call (lock construction is a cold
# path — one os.environ lookup per server/fleet/controller built), so
# flipping PADDLE_TPU_TORCH_LOCK_DEBUG genuinely applies to locks created
# afterwards.  The zero-cost contract lives in what the factory
# RETURNS when disabled (a plain threading primitive), not in caching
# this read.
_forced = None


def enabled():
    """True when the watchdog is armed: a set_enabled() override, else
    PADDLE_TPU_TORCH_LOCK_DEBUG read live.  Decides per lock CREATION —
    existing plain locks stay plain after a flip."""
    if _forced is not None:
        return _forced
    from ..flags import FLAGS
    return bool(FLAGS.lock_debug)


def set_enabled(value):
    """Force the switch (tests; runtime opt-in without env plumbing)."""
    global _forced
    _forced = bool(value)


def reload_enabled():
    """Drop any set_enabled() override; queries read the flag again."""
    global _forced
    _forced = None


# -- watchdog state --------------------------------------------------------
# The watchdog's own bookkeeping lock is a PLAIN threading.Lock,
# deliberately outside its own instrumentation (it nests inside every
# instrumented acquisition; instrumenting it would recurse), and no
# other lock is ever taken while holding it.
_state_lock = threading.Lock()
_edges = {}          # name -> set(names legally acquired after name)
_static_loaded = False
_violations = []
_VIOLATION_CAP = 256
_tls = threading.local()

_metric = None


def _violation_counter():
    global _metric
    if _metric is None:
        try:
            from .. import observability as _obs
            _metric = _obs.registry().counter(
                'paddle_tpu_lock_order_violations_total',
                'runtime lock acquisitions that contradicted the '
                'acquisition-order graph (static analyzer edges + '
                'orders already observed this process) while '
                'PADDLE_TPU_TORCH_LOCK_DEBUG=1 — each one is a potential '
                'deadlock interleaving').child()
        except Exception:       # metrics must never break locking
            _metric = False
    return _metric


def install_static_edges(edges):
    """Merge acquisition-order edges into the graph.  ``edges`` is an
    iterable of (before, after) name pairs — the analyzer's
    ``Report.order_edges`` keys, or a test's hand-built order."""
    with _state_lock:
        for a, b in edges:
            _edges.setdefault(a, set()).add(b)


def load_static_edges():
    """Run the static analyzer over paddle_tpu_torch once and install its
    lock-order edges; idempotent, never raises (a broken sweep must
    not take locking down with it)."""
    global _static_loaded
    with _state_lock:
        if _static_loaded:
            return
        _static_loaded = True
    try:
        from . import concurrency
        report = concurrency.analyze_package()
        install_static_edges(report.order_edges)
    except Exception:
        pass


def violations(clear=False):
    """The recorded violations: [{thread, held, acquiring, stack}]."""
    with _state_lock:
        out = list(_violations)
        if clear:
            del _violations[:]
    return out


def order_edges():
    """Snapshot of the merged order graph {name: set(names)}."""
    with _state_lock:
        return {k: set(v) for k, v in _edges.items()}


def reset_state():
    """Clear edges/violations and forget the static-load (tests)."""
    global _static_loaded
    with _state_lock:
        _edges.clear()
        del _violations[:]
        _static_loaded = False


def _stack():
    st = getattr(_tls, 'stack', None)
    if st is None:
        st = _tls.stack = []
    return st


def _note_acquire(name):
    """Record one acquisition; check the order graph against every
    lock this thread already holds."""
    held = _stack()
    bad = None
    with _state_lock:
        for h in held:
            if h == name:
                continue  # reentrant / shared-name condition pair
            if name in _edges and h in _edges[name]:
                bad = h   # graph says name-before-h; we did h-then-name
                break
            _edges.setdefault(h, set()).add(name)
        if bad is not None and len(_violations) < _VIOLATION_CAP:
            _violations.append({
                'thread': threading.current_thread().name,
                'held': list(held),
                'acquiring': name,
                'inverted_against': bad,
                'stack': ''.join(traceback.format_stack(limit=12)),
            })
    held.append(name)
    if bad is not None:
        m = _violation_counter()
        if m:
            m.inc()


def _note_reacquire(name):
    """Re-entry after a Condition.wait: the edge was checked at the
    original acquisition; re-checking the reacquire would flag the
    wait itself."""
    _stack().append(name)


def _note_release(name):
    st = _stack()
    # out-of-order release is legal (try/finally unwinds): drop the
    # most recent occurrence
    for i in range(len(st) - 1, -1, -1):
        if st[i] == name:
            del st[i]
            return


class _DebugLock(object):
    """threading.Lock/RLock with order-graph bookkeeping."""
    __slots__ = ('name', '_inner')

    def __init__(self, name, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self.name)
        return got

    def release(self):
        _note_release(self.name)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _DebugCondition(object):
    """threading.Condition with order-graph bookkeeping; ``wait``
    releases the name for its sleep and re-enters without re-checking
    (the edge was judged at the original acquisition)."""
    __slots__ = ('name', '_cond')

    def __init__(self, name, cond):
        self.name = name
        self._cond = cond

    def acquire(self, *a, **kw):
        got = self._cond.acquire(*a, **kw)
        if got:
            _note_acquire(self.name)
        return got

    def release(self):
        _note_release(self.name)
        self._cond.release()

    def __enter__(self):
        self._cond.__enter__()
        _note_acquire(self.name)
        return self

    def __exit__(self, *exc):
        _note_release(self.name)
        return self._cond.__exit__(*exc)

    def wait(self, timeout=None):
        _note_release(self.name)
        try:
            return self._cond.wait(timeout)
        finally:
            _note_reacquire(self.name)

    def wait_for(self, predicate, timeout=None):
        _note_release(self.name)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            _note_reacquire(self.name)

    def notify(self, n=1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()


# -- factories -------------------------------------------------------------
def make_lock(name):
    """A lock named for the order graph.  Disabled (default): a plain
    ``threading.Lock`` — zero added cost.  Enabled: a checking
    wrapper; the first armed creation also loads the static analyzer's
    edge set so the static order graph is asserted at runtime."""
    if not enabled():
        return threading.Lock()
    load_static_edges()
    return _DebugLock(name, threading.Lock())


def make_rlock(name):
    """RLock variant of :func:`make_lock` (reentrant acquisitions of
    the same name never count as order edges)."""
    if not enabled():
        return threading.RLock()
    load_static_edges()
    return _DebugLock(name, threading.RLock())


def make_condition(name, lock=None):
    """A condition variable named for the order graph.  Two conditions
    built over ONE shared lock should pass the SAME name — they are
    one lock with two wait-sets, and the analyzer models them as one
    alias group."""
    if not enabled():
        return threading.Condition(
            lock._inner if isinstance(lock, _DebugLock) else lock)
    load_static_edges()
    raw = lock._inner if isinstance(lock, _DebugLock) else lock
    return _DebugCondition(name, threading.Condition(raw))

"""Reader decorators.

Reference parity: paddle_tpu/reader/decorator.py (python/paddle/v2/
reader/decorator.py): map_readers, shuffle, chain, compose, buffered,
firstn, cache, xmap_readers and metered, with the same contracts, on
Python threads.  ``metered`` and ``buffered`` count their samples in the
port's observability registry under the reference's series
(``paddle_tpu_reader_samples_total``, ``_samples_per_second`` and
``_buffer_depth``, labelled ``reader``).
"""
import itertools
import queue
import random
import threading
import time

from .. import observability as _obs

__all__ = ['map_readers', 'buffered', 'compose', 'chain', 'shuffle',
           'firstn', 'xmap_readers', 'cache', 'metered',
           'ComposeNotAligned']


class _ReaderMetrics(object):
    """Registry handles for one reader stage, labelled by name
    (``reader="buffered"``, or the user's ``metered`` name)."""

    _cache = {}
    _cache_lock = threading.Lock()

    def __init__(self, name):
        r = _obs.registry()
        L = ('reader',)
        sl = {'reader': name}
        self.samples = r.counter(
            'paddle_tpu_reader_samples_total',
            'samples yielded by instrumented reader stages', L
            ).labels(**sl)
        self.rate = r.gauge(
            'paddle_tpu_reader_samples_per_second',
            'recent sample rate of instrumented reader stages '
            '(updated every rate-window samples)', L).labels(**sl)
        self.buffer_depth = r.gauge(
            'paddle_tpu_reader_buffer_depth',
            'samples sitting in the prefetch buffer', L).labels(**sl)

    @classmethod
    def get(cls, name):
        with cls._cache_lock:
            m = cls._cache.get(name)
            if m is None:
                m = cls._cache[name] = cls(name)
            return m


_RATE_WINDOW = 256  # samples between rate-gauge refreshes
_DEPTH_WINDOW = 64  # samples between buffer-depth/count flushes


class _SampleWindow(object):
    """Per-sample accounting in windows: ``hit()`` per delivered sample,
    the locked metric updates once per ``window`` (the counter, the
    samples/s gauge and, given a queue, its depth gauge).  ``flush()``
    from a ``finally`` delivers the partial window, so a consumer that
    stops early never under-counts."""
    __slots__ = ('_m', '_window', '_n', '_t0')

    def __init__(self, m, window):
        self._m = m
        self._window = window
        self._n = 0
        self._t0 = time.perf_counter()

    def hit(self, q=None):
        self._n += 1
        if self._n >= self._window:
            n, self._n = self._n, 0
            self._m.samples.inc(n)
            if q is not None:
                self._m.buffer_depth.set(q.qsize())
            t1 = time.perf_counter()
            if t1 > self._t0:
                self._m.rate.set(n / (t1 - self._t0))
            self._t0 = t1

    def flush(self):
        if self._n:
            self._m.samples.inc(self._n)
            self._n = 0


def metered(reader, name='reader'):
    """Count the samples of ``reader`` (``paddle_tpu_reader_samples_total
    {reader=name}``) and keep a recent samples/s gauge; a pass-through
    when metrics are disabled."""

    def metered_reader():
        it = reader()
        if not _obs.enabled():
            yield from it
            return
        w = _SampleWindow(_ReaderMetrics.get(name), _RATE_WINDOW)
        try:
            for sample in it:
                # counted before the yield: a consumer that closes the
                # reader right after still received it
                w.hit()
                yield sample
        finally:
            w.flush()

    return metered_reader


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    """A creator whose samples are ``func(r1_sample, r2_sample, ...)``."""

    def reader():
        for vals in zip(*[r() for r in readers]):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Shuffle within windows of ``buf_size`` samples, each drained before
    the next is read; the module-level ``random`` orders them."""

    def data_reader():
        it = iter(reader())
        if buf_size <= 0:
            yield from it
            return
        while True:
            window = list(itertools.islice(it, buf_size))
            if not window:
                return
            random.shuffle(window)
            yield from window

    return data_reader


def chain(*readers):
    """All of r1's samples, then all of r2's, ..."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, **kwargs):
    """Zip readers into flat tuples; with ``check_alignment`` (default)
    readers that end at different times raise ``ComposeNotAligned``."""
    check_alignment = kwargs.pop('check_alignment', True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        zipped = itertools.zip_longest(*rs) if check_alignment \
            else zip(*rs)
        for outputs in zipped:
            if check_alignment and any(o is None for o in outputs):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned.")
            yield sum(map(make_tuple, outputs), ())

    return reader


class _End(object):
    """The end of a worker's stream, with the error that ended it."""

    def __init__(self, error=None):
        self.error = error


def buffered(reader, size):
    """Read up to ``size`` samples ahead on a worker thread; an error in
    the source re-raises in the consumer.  Its samples and queue depth
    count under ``reader="buffered"``."""

    def read_worker(r, q):
        try:
            for d in r:
                q.put(d)
        except BaseException as e:   # handed to the consumer, re-raised
            q.put(_End(e))
        else:
            q.put(_End())

    def data_reader():
        q = queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(reader(), q),
                             daemon=True)
        t.start()
        w = _SampleWindow(_ReaderMetrics.get('buffered'),
                          _DEPTH_WINDOW) if _obs.enabled() else None
        e = q.get()
        try:
            while not isinstance(e, _End):
                if w is not None:
                    w.hit(q)
                yield e
                e = q.get()
        finally:
            if w is not None:
                w.flush()
        if e.error is not None:
            raise e.error

    return data_reader


def firstn(reader, n):
    """The first ``n`` samples."""

    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def cache(reader):
    """Read the source once; replay it from memory after."""
    all_data = []
    filled = []

    def cache_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)

    return cache_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """``map`` on ``process_num`` worker threads, through queues of
    ``buffer_size``; with ``order`` the output keeps the input's order.
    A mapper's error re-raises in the consumer."""
    end = _End()

    def read_worker(in_q):
        for i, d in enumerate(reader()):
            in_q.put((i, d))
        in_q.put(end)

    def handle_worker(in_q, out_q, turn):
        # with ``order``, a worker emits only when its sample's index is
        # the next one due
        cond, nxt = turn
        item = in_q.get()
        while item is not end:
            i, sample = item
            try:
                result = mapper(sample)
            except BaseException as e:   # handed to the consumer
                result = _End(e)
            if order:
                with cond:
                    cond.wait_for(lambda: nxt[0] == i)
                    out_q.put(result)
                    nxt[0] += 1
                    cond.notify_all()
            else:
                out_q.put(result)
            if isinstance(result, _End):
                return
            item = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        turn = (threading.Condition(), [0])
        threading.Thread(target=read_worker, args=(in_q,),
                         daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=handle_worker,
                             args=(in_q, out_q, turn), daemon=True).start()
        finished = 0
        while finished < process_num:
            sample = out_q.get()
            if sample is end:
                finished += 1
            elif isinstance(sample, _End):
                raise sample.error
            else:
                yield sample

    return xreader

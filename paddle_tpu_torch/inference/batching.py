"""Dynamic request batching over shape-bucketed exported artifacts.

Reference parity: paddle_tpu/inference/batching.py, the whole module
(the Clipper / TF-Serving adaptive-batching design):

- a request queue and a dispatcher thread coalesce concurrent ``submit``
  calls into batches;
- batches land on a power-of-two **bucket ladder** (1, 2, 4, ..,
  ``max_batch``): requests pad up to the next bucket and un-pad on the
  way out, so only ~log2(max_batch) artifacts are ever exported;
- the dispatch policy is **work-conserving**: a full bucket launches at
  once while fewer than two batches are in flight, a partial batch
  launches once the device is idle and ``linger_ms`` has passed, and the
  **deadline flush** ``max_wait_ms``, counted from the oldest queued
  request, bounds what a lone request waits;
- **double-buffered staging**: on the card the dispatcher copies batch
  N+1 from pinned host memory to the card on a side stream while batch N
  still runs, launches it on the serving stream behind that copy, and
  queues the copy of its outputs back to pinned host memory; at most two
  batches are in flight, and the collector thread waits on each batch's
  event before it hands the rows out;
- **startup warmup** readies every bucket before serving starts: a
  bucket's "compile" here is loading its artifact onto the device and
  running it once on a zero feed of its shape (the kernel library's build
  and load, cuDNN's algorithm choice).  One that happens later is counted
  (``stats()['compiles_after_warmup']``).
- the **AOT cache** (inference/aot_cache.py, on when
  PADDLE_TPU_TORCH_AOT_CACHE_DIR is set): a bucket loaded from its
  artifact stores an entry, and a later process readies it from the entry
  instead, skipping ``torch.export.load`` and the unlifting; such a hit is
  counted by the cache, not as a compile, so a fresh process over a warm
  cache reports zero compiles.  Its warm call still runs.

Correctness contract: the inference graph must be row-independent along
the batch axis (true of inference programs: batch norm runs on its
frozen statistics), so padded rows cannot change real rows.  Padding
repeats the last real row rather than feeding zeros, which could make a
NaN or Inf.  Rows run through different bucket artifacts can differ in
the last bits (cuBLAS picks kernels by shape); a request that exactly
fills its bucket is bitwise an unbatched ``predict`` on that bucket's
artifact.

Telemetry: each server reports into the process registry
(observability/metrics.py) under the reference's series, labelled
``server="b<N>"``; ``close()`` retires them.  With
``PADDLE_TPU_TORCH_METRICS_ENABLED=0`` the server still counts there, as
``stats()`` reads its counts back (the reference gives each server a
private registry then), and nothing is served.  A bucket's readying runs
under the span ``serving.bucket_compile``; armed, the timeline records
each request's ``serving.queue_wait`` and each batch's
``serving.compute``; the dispatch and collector threads dump the ring
tagged with the server id on an error
(``trace_<pid>_error_b<N>.json``).  The first server of a process starts
the /metrics endpoint when ``PADDLE_TPU_TORCH_METRICS_PORT`` is set.

Departures from the reference: locks are plain ``threading``
conditions; the buckets' artifacts are opened when the server is built
and ``warmup_throttle_ms`` paces those loads; ``resident_bytes`` reports the device's own measurements (the
bucket module's buffers, and what its warm call added to
``torch.cuda.max_memory_allocated``) where the reference reads XLA's
``memory_analysis()``.
"""
import itertools
import os
import queue
import shutil
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from .. import observability as _obs
from ..analysis import lockdebug as _lkd
from ..core.place import resolve_device
from ..observability import timeline as _tlm
from ..observability.metrics import DEFAULT_LATENCY_BUCKETS
from . import aot_cache
from .serving import InferenceServer, export_inference

__all__ = ['BatchingInferenceServer', 'export_bucketed', 'bucket_sizes']

_STOP = object()

_server_seq = itertools.count()


class _ServingMetrics(object):
    """Per-server handles into the process registry, labelled
    ``server="b<N>"`` so servers in one process stay apart on /metrics;
    ``stats()`` reads this server's children back."""

    def __init__(self, reg, sid):
        L = ('server',)
        self._sid = sid
        self._families = []

        def child(metric):
            self._families.append(metric)
            return metric.labels(server=sid)

        self.submitted = child(reg.counter(
            'paddle_tpu_serving_requests_submitted_total',
            'requests accepted by submit()', L))
        self.completed = child(reg.counter(
            'paddle_tpu_serving_requests_completed_total',
            'requests whose results were delivered', L))
        self.batches = child(reg.counter(
            'paddle_tpu_serving_batches_total',
            'device batches dispatched', L))
        self.batch_rows = child(reg.counter(
            'paddle_tpu_serving_batch_rows_total',
            'real (non-padding) rows dispatched in batches', L))
        self.batch_capacity = child(reg.counter(
            'paddle_tpu_serving_batch_capacity_total',
            'bucket capacity dispatched (rows incl. padding)', L))
        self.compiles = child(reg.counter(
            'paddle_tpu_serving_compiles_total',
            'bucket loads and warm calls (warmup + on-demand)', L))
        self.compiles_after_warmup = child(reg.counter(
            'paddle_tpu_serving_compiles_after_warmup_total',
            'bucket loads after warmup finished: nonzero means the '
            'ladder missed a shape and the loop stalled', L))
        self.queue_depth = child(reg.gauge(
            'paddle_tpu_serving_queue_depth',
            'requests waiting to be batched', L))
        self.in_flight = child(reg.gauge(
            'paddle_tpu_serving_in_flight_batches',
            'batches dispatched but not yet synced', L))
        self.latency = child(reg.histogram(
            'paddle_tpu_serving_request_latency_seconds',
            'submit-to-result latency per request', L,
            buckets=DEFAULT_LATENCY_BUCKETS))
        self.occupancy = child(reg.histogram(
            'paddle_tpu_serving_batch_occupancy',
            'real rows per dispatched batch', L,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)))
        L2 = ('server', 'bucket')
        self._queue_wait_family = reg.histogram(
            'paddle_tpu_serving_queue_wait_seconds',
            'submit-to-dispatch wait per request, by dispatched bucket '
            '(bucket="all" aggregates)', L2,
            buckets=DEFAULT_LATENCY_BUCKETS)
        self._compute_family = reg.histogram(
            'paddle_tpu_serving_compute_seconds',
            'dispatch-to-sync time per batch, by bucket '
            '(bucket="all" aggregates)', L2,
            buckets=DEFAULT_LATENCY_BUCKETS)
        self._bucket_children = {}  # (family, bucket_label) -> child

    def _bucket_child(self, family, bucket):
        key = (family.name, str(bucket))
        child = self._bucket_children.get(key)
        if child is None:
            child = family.labels(server=self._sid, bucket=str(bucket))
            self._bucket_children[key] = child
        return child

    def queue_wait(self, bucket):
        return self._bucket_child(self._queue_wait_family, bucket)

    def compute(self, bucket):
        return self._bucket_child(self._compute_family, bucket)

    def observed_buckets(self):
        """Bucket sizes that have dispatched at least one batch."""
        return sorted({int(b) for (_, b) in self._bucket_children
                       if b != 'all'})

    def close(self):
        """Retire this server's label series; its own handles stay
        usable for a final stats() read."""
        for m in self._families:
            m.remove(server=self._sid)
        for fam_name, b in list(self._bucket_children):
            fam = (self._queue_wait_family
                   if fam_name == self._queue_wait_family.name
                   else self._compute_family)
            fam.remove(server=self._sid, bucket=b)


def bucket_sizes(max_batch):
    """The power-of-two bucket ladder [1, 2, 4, ...] whose top is
    ``max_batch`` rounded up to a power of two."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1, got %r" % (max_batch,))
    sizes = [1]
    while sizes[-1] < max_batch:
        sizes.append(sizes[-1] * 2)
    return sizes


def export_bucketed(dir_path, feed_specs, target_vars, executor=None,
                    main_program=None, scope=None, max_batch=None,
                    amp=None, device=None):
    """Export one shape-specialized artifact per bucket size.

    :param feed_specs: {feed_name: per-request example shape WITHOUT the
        batch axis}; bucket b exports at shape (b,) + example_shape.
    :param amp: scoped PADDLE_TPU_TORCH_AMP override for these exports
        (transpiler/amp.py ``amp_guard``): 'bf16'/'f16' bakes the
        AMP-rewritten program into every bucket's artifact, '0' forces
        full precision, None honours the ambient flag.  The override is
        process-global while the exports run.
    :param device: the executor's place when ``executor`` is None.
    :returns: {bucket_size: artifact path}.
    """
    from ..flags import FLAGS
    from ..transpiler.amp import amp_guard
    if max_batch is None:
        max_batch = int(FLAGS.serving_max_batch)
    paths = {}
    with amp_guard(amp):
        for b in bucket_sizes(max_batch):
            shapes = {n: (b,) + tuple(s) for n, s in feed_specs.items()}
            p = os.path.join(dir_path, 'bucket_%d.pt2' % b)
            export_inference(p, shapes, target_vars, executor=executor,
                             main_program=main_program, scope=scope,
                             device=device)
            paths[b] = p
    return paths


class _Request(object):
    __slots__ = ('feed', 'rows', 'future', 't_submit', 'rid')

    def __init__(self, feed, rows, t_submit, rid):
        self.feed = feed
        self.rows = rows
        self.future = Future()
        self.t_submit = t_submit
        self.rid = rid


def _host_dtype(dtype):
    """The numpy dtype a request's rows are held in on the host:
    bfloat16, which numpy lacks, stays float32 until the card casts it."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


class BatchingInferenceServer(object):
    """Adaptive-batching front end over a ladder of bucket-sized
    :class:`InferenceServer` artifacts (load once, predict concurrently).

    - ``submit(feed)`` -> Future of [outputs] (thread-safe; blocks only on
      queue backpressure); ``predict(feed)`` is submit + wait.
    - A request carries one example (feed values at the exported example
      shape) or a leading batch axis of k <= max_batch rows; outputs keep
      the request's leading axis.
    - ``stats()``: queue depth, batch occupancy, latency percentiles and
      the compile counters.

    Construction: ``BatchingInferenceServer({bucket: path})`` over
    :func:`export_bucketed`'s artifacts, or :meth:`from_program`.
    ``device`` (None: the card) must be the device the artifacts were
    exported on.  Knobs: ``max_wait_ms`` (the deadline flush),
    ``linger_ms`` (the grace a partial batch waits while the device is
    idle), ``max_queue`` (submit blocks past it), ``warmup_throttle_ms``
    (a pause between two buckets' loads, so that a server built beside
    live traffic, as a fleet's deploy builds one, leaves the cores to the
    serving threads between them).
    """

    def __init__(self, bucket_paths, max_wait_ms=None, linger_ms=0.5,
                 max_queue=4096, warmup=True, share_artifacts_with=None,
                 device=None, warmup_throttle_ms=0.0):
        from ..flags import FLAGS
        if max_wait_ms is None:
            max_wait_ms = float(FLAGS.serving_max_wait_ms)
        if share_artifacts_with is not None:
            # a sibling over the same exported version: reuse its loaded
            # and warmed buckets; queues, threads, metrics and lifecycle
            # stay per server
            src = share_artifacts_with
            if not isinstance(src, BatchingInferenceServer):
                raise TypeError(
                    "share_artifacts_with must be a "
                    "BatchingInferenceServer, got %r" % (src,))
            if bucket_paths and \
                    sorted(int(b) for b in bucket_paths) != src._buckets:
                raise ValueError(
                    "share_artifacts_with: bucket_paths ladder %s does "
                    "not match the source server's %s: sharing is only "
                    "valid between replicas of one exported version"
                    % (sorted(int(b) for b in bucket_paths),
                       src._buckets))
            self.device = src.device
            self._servers = src._servers
            # the same dict, deliberately: a bucket warmed through either
            # sibling is warm for both
            self._compiled = src._compiled
            self._bucket_paths = dict(src._bucket_paths)
            self._buckets = src._buckets
            self.max_batch = src.max_batch
            self._feed_names = src._feed_names
            self._example_shapes = src._example_shapes
            self._dtypes = src._dtypes
            self._aot = src._aot
            self._aot_digests = src._aot_digests
            self._bucket_used = src._bucket_used
            self._res_gen = src._res_gen
        else:
            if not bucket_paths:
                raise ValueError("bucket_paths is empty")
            self.device = resolve_device(device)
            aot = aot_cache.AotCache()
            self._aot = aot if aot.enabled() else None
            self._aot_digests = {}   # bucket -> artifact sha1, shared
            self._compiled = {}   # bucket -> warmed InferenceServer
            self._bucket_paths = {int(b): p
                                  for b, p in bucket_paths.items()}
            self._buckets = sorted(self._bucket_paths)
            self._servers = {}
            throttle = float(warmup_throttle_ms) / 1e3
            for i, b in enumerate(self._buckets):
                if throttle and i:
                    time.sleep(throttle)
                self._servers[b] = self._open(b)
            self.max_batch = self._buckets[-1]
            avals = self._servers[self.max_batch].feed_avals()
            self._feed_names = sorted(avals)
            self._example_shapes = {
                n: tuple(a.shape[1:]) for n, a in avals.items()}
            self._dtypes = {n: _host_dtype(a.dtype)
                            for n, a in avals.items()}
            for b in self._buckets:
                av = self._servers[b].feed_avals()
                want = {n: (b,) + self._example_shapes[n]
                        for n in self._feed_names}
                got = {n: tuple(a.shape) for n, a in av.items()}
                if got != want:
                    raise ValueError(
                        "bucket %d artifact feeds %s do not match the "
                        "ladder (expected %s): every bucket must export "
                        "the same example shapes with only the batch "
                        "axis varying" % (b, got, want))
            # last-dispatch stamps (time.monotonic) per bucket, written by
            # the dispatcher; readers tolerate a stale read
            self._bucket_used = {}
            # residency generation, bumped on evict and on post-warmup
            # loads; one shared cell between siblings
            self._res_gen = [0]
        self.max_wait = float(max_wait_ms) / 1e3
        self.linger = float(linger_ms) / 1e3
        self.max_queue = int(max_queue)

        # one lock, two wait-sets: the dispatcher sleeps on _cv, clients
        # blocked on backpressure on _cv_space.  Both conditions carry one
        # watchdog name: they are one lock in the acquisition-order graph
        # (PADDLE_TPU_TORCH_LOCK_DEBUG)
        lock = threading.Lock()
        self._cv = _lkd.make_condition('BatchingInferenceServer._cv', lock)
        self._cv_space = _lkd.make_condition('BatchingInferenceServer._cv',
                                             lock)
        self._pending = deque()   # guarded by _cv
        self._pending_rows = 0    # running row total of _pending
        self._in_flight = 0       # batches dispatched, not yet synced
        self._stopping = False
        self._draining = False    # drain(): stop accepting, keep flushing
        # collector handoff; capacity 2 == the double-buffer window
        self._inflight_q = queue.Queue(maxsize=2)
        self._on_card = self.device.type == 'cuda'
        if self._on_card:
            self._stream = torch.cuda.Stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)

        sid = 'b%d' % next(_server_seq)
        self._m = _ServingMetrics(_obs.registry(), sid)
        if _obs.enabled():
            _obs.maybe_serve_from_env()
        self._req_seq = itertools.count()
        self._warmup_done = False
        self._closed = False
        self._owned_dir = None  # set by from_program when it made the dir

        if warmup:
            for b in self._buckets:
                self._ensure_compiled(b)
        self._warmup_done = True

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            name='paddle-tpu-torch-batch-dispatch', daemon=True)
        self._collector = threading.Thread(
            target=self._collect_loop,
            name='paddle-tpu-torch-batch-collect', daemon=True)
        self._dispatcher.start()
        self._collector.start()

    @classmethod
    def from_program(cls, feed_specs, target_vars, executor=None,
                     main_program=None, scope=None, max_batch=None,
                     path_dir=None, device=None, **kw):
        """Export the bucket ladder for a program and serve it, in one
        call.  ``feed_specs`` are per-request example shapes (no batch
        axis); ``device`` is the executor's place when ``executor`` is
        None (None: the card); other kwargs go to the constructor."""
        owned = path_dir is None
        path_dir = path_dir or tempfile.mkdtemp(
            prefix='paddle_tpu_torch_buckets_')
        if executor is not None:
            device = executor.place
        paths = export_bucketed(path_dir, feed_specs, target_vars,
                                executor=executor,
                                main_program=main_program, scope=scope,
                                max_batch=max_batch, device=device)
        srv = cls(paths, device=device, **kw)
        if owned:
            srv._owned_dir = path_dir  # removed by close()
        return srv

    # -- client surface ------------------------------------------------
    def submit(self, feed, request_id=None):
        """Enqueue one request; returns a Future of [output arrays], each
        keeping the request's leading row count.  Blocks only while the
        queue is full.  After :meth:`drain` or :meth:`close` this raises
        ``RuntimeError``.  ``request_id`` threads an upstream id through;
        by default each request takes this server's next id."""
        norm, rows = self._normalize(feed)
        rid = (next(self._req_seq) if request_id is None
               else request_id)
        req = _Request(norm, rows, time.perf_counter(), rid)
        with self._cv:
            self._check_accepting()
            while (len(self._pending) >= self.max_queue
                   and not self._closed and not self._draining):
                self._cv_space.wait(0.1)
            self._check_accepting()
            self._pending.append(req)
            self._pending_rows += rows
            self._m.submitted.inc()
            self._m.queue_depth.set(len(self._pending))
            # wake the dispatcher only on transitions it can act on: the
            # first work after idle, or a bucket's worth queued
            if len(self._pending) == 1 or \
                    self._pending_rows >= self.max_batch:
                self._cv.notify()
        return req.future

    def _check_accepting(self):
        """Raise the post-retirement error.  Caller holds _cv."""
        if self._closed:
            raise RuntimeError(
                "BatchingInferenceServer is closed; submit() after close() "
                "is rejected (the dispatcher is gone and the request's "
                "Future would never complete)")
        if self._draining:
            raise RuntimeError(
                "BatchingInferenceServer is draining; it no longer accepts "
                "new requests (queued and in-flight work is being flushed "
                "before retirement)")

    def predict(self, feed, timeout=None):
        """submit + wait: returns [output arrays] for this request."""
        return self.submit(feed).result(timeout)

    def queue_state(self):
        """A live snapshot of the dispatch queue: requests and rows
        waiting, batches in flight, and whether the server accepts
        work."""
        with self._cv:
            return {
                'queued_requests': len(self._pending),
                'queued_rows': self._pending_rows,
                'in_flight_batches': self._in_flight,
                'accepting': not (self._closed or self._draining),
            }

    def drain(self, timeout=30.0):
        """Stop accepting requests and flush what is here (partial
        batches launch at once); the threads, buckets and metrics stay.
        Returns True when the queue drained within ``timeout`` seconds.
        Idempotent; drain then close is the graceful retirement."""
        with self._cv:
            self._draining = True
            self._cv.notify()
            self._cv_space.notify_all()
        deadline = time.perf_counter() + timeout
        while True:
            with self._cv:
                if not self._pending and self._in_flight == 0:
                    return True
            if time.perf_counter() >= deadline:
                return False
            time.sleep(0.002)

    def stats(self):
        """The reference's dict: counters, occupancy, the compile
        counters, and p50/p99 of the request latency, of its queue wait
        (submit to dispatch) and of the batch compute (dispatch to host
        sync), overall and per dispatched bucket (bucket-interpolated
        histogram quantiles)."""
        with self._cv:
            depth = len(self._pending)
            in_flight = self._in_flight
        m = self._m
        batches = m.batches.value
        rows_sum = m.batch_rows.value
        capacity_sum = m.batch_capacity.value
        qw, comp = m.queue_wait('all'), m.compute('all')
        per_bucket = {}
        for b in m.observed_buckets():
            bq, bc = m.queue_wait(b), m.compute(b)
            per_bucket[b] = {
                'queue_wait_p50_ms': bq.quantile(0.5) * 1e3,
                'queue_wait_p99_ms': bq.quantile(0.99) * 1e3,
                'compute_p50_ms': bc.quantile(0.5) * 1e3,
                'compute_p99_ms': bc.quantile(0.99) * 1e3,
                'batches': int(bc.count),
            }
        return {
            'queue_depth': depth,
            'in_flight_batches': in_flight,
            'requests_submitted': int(m.submitted.value),
            'requests_completed': int(m.completed.value),
            'batches': int(batches),
            'mean_batch_occupancy':
                rows_sum / batches if batches else 0.0,
            'mean_bucket_fill':
                rows_sum / capacity_sum if capacity_sum else 0.0,
            'compiles': int(m.compiles.value),
            'compiles_after_warmup': int(m.compiles_after_warmup.value),
            'p50_latency_ms': m.latency.quantile(0.5) * 1e3,
            'p99_latency_ms': m.latency.quantile(0.99) * 1e3,
            'queue_wait_p50_ms': qw.quantile(0.5) * 1e3,
            'queue_wait_p99_ms': qw.quantile(0.99) * 1e3,
            'compute_p50_ms': comp.quantile(0.5) * 1e3,
            'compute_p99_ms': comp.quantile(0.99) * 1e3,
            'per_bucket': per_bucket,
            'buckets': list(self._buckets),
        }

    def resident_bytes(self):
        """What serving this ladder keeps resident, per bucket and in
        all, with the reference's keys: ``artifact_bytes`` the artifact
        file while its bucket is loaded; for a warmed bucket
        ``argument_bytes`` its module's buffers (the state, each bucket
        its own copy) and its zero feed, ``output_bytes`` its outputs,
        ``temp_bytes`` what its warm call added to the device's peak
        beyond those (the card's ``max_memory_allocated``; 0 on the CPU),
        ``code_bytes`` 0 (the kernel libraries are shared by the process).
        ``servable_key`` identifies the shared servable of siblings built
        with ``share_artifacts_with=``."""
        per_bucket = {}
        total = 0
        for b in self._buckets:
            e = {'compiled': b in self._compiled}
            p = self._bucket_paths.get(b)
            if p and b in self._servers:
                try:
                    e['artifact_bytes'] = os.path.getsize(p)
                except OSError:
                    pass
            srv = self._compiled.get(b)
            if srv is not None:
                e.update(srv.resident)
            e['estimate_bytes'] = (
                e.get('artifact_bytes', 0) + e.get('argument_bytes', 0)
                + e.get('output_bytes', 0) + e.get('temp_bytes', 0)
                + e.get('code_bytes', 0))
            total += e['estimate_bytes']
            per_bucket[b] = e
        return {
            'total_bytes': int(total),
            'per_bucket': per_bucket,
            'servable_key': id(self._compiled),
            'basis': 'per-bucket artifact file size + the warmed module\'s '
                     'buffers and zero feed, its outputs, and the peak '
                     'its warm call added on the device, summed over the '
                     'ladder',
        }

    def close(self, timeout=10.0):
        """Stop accepting requests, flush what is queued, and join the
        worker threads."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._stopping = True
            self._cv.notify()
            self._cv_space.notify_all()
        self._dispatcher.join(timeout)
        self._collector.join(timeout)
        self._m.close()
        if self._owned_dir:
            shutil.rmtree(self._owned_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- batch formation (pure, unit-testable) -------------------------
    def _bucket_for(self, rows):
        """Smallest ladder bucket holding ``rows`` rows."""
        for b in self._buckets:
            if b >= rows:
                return b
        raise ValueError("rows=%d exceeds max_batch=%d"
                         % (rows, self.max_batch))

    def _normalize(self, feed):
        """Validate one request against the exported feed signature and
        cast to the host dtypes (in the caller's thread).  Returns
        ({name: (rows,) + example array}, rows)."""
        if len(feed) != len(self._feed_names):
            raise ValueError(
                "feed names %s do not match the exported signature %s"
                % (sorted(feed), self._feed_names))
        norm, rows = {}, None
        for n in self._feed_names:
            try:
                arr = feed[n]
            except KeyError:
                raise ValueError(
                    "feed is missing %r; the exported signature is %s"
                    % (n, self._feed_names))
            ex = self._example_shapes[n]
            if torch.is_tensor(arr):
                arr = arr.detach().cpu().numpy()
            elif type(arr) is not np.ndarray:
                arr = np.asarray(arr)
            shape = arr.shape
            if shape == ex:
                arr, k = arr[None], 1
            elif len(shape) == len(ex) + 1 and shape[1:] == ex:
                k = shape[0]
            else:
                raise ValueError(
                    "feed %r has shape %s; expected the example shape %s "
                    "or (rows,) + %s" % (n, shape, ex, ex))
            if k == 0:
                raise ValueError(
                    "feed %r carries 0 rows; empty requests cannot be "
                    "batched" % n)
            if rows is None:
                rows = k
            elif k != rows:
                raise ValueError(
                    "feed rows disagree across names: %r has %d, others "
                    "have %d" % (n, k, rows))
            if arr.dtype != self._dtypes[n]:
                arr = arr.astype(self._dtypes[n])
            norm[n] = arr
        if rows > self.max_batch:
            raise ValueError(
                "request carries %d rows > max_batch %d; split it"
                % (rows, self.max_batch))
        return norm, rows

    def _assemble(self, reqs):
        """Form one device batch from requests: concatenate rows, pick
        the smallest bucket that fits, pad up to it by repeating the last
        real row.  Rows at or past ``offsets[-1][1]`` are padding and are
        never returned."""
        offsets, lo = [], 0
        for r in reqs:
            offsets.append((lo, lo + r.rows))
            lo += r.rows
        rows = lo
        bucket = self._bucket_for(rows)
        stacked = {}
        for n in self._feed_names:
            parts = [r.feed[n] for r in reqs]
            pad = bucket - rows
            if pad:
                parts.append(np.broadcast_to(
                    parts[-1][-1:], (pad,) + self._example_shapes[n]))
            stacked[n] = (np.concatenate(parts, axis=0)
                          if len(parts) > 1 else parts[0])
        return bucket, stacked, offsets

    # -- bucket readiness ----------------------------------------------
    def _aot_key(self, bucket):
        """The bucket's AOT cache key; digests are memoized per bucket
        and shared between siblings."""
        digest = self._aot_digests.get(bucket)
        if digest is None:
            digest = aot_cache.artifact_digest(self._bucket_paths[bucket])
            self._aot_digests[bucket] = digest
        return self._aot.key(digest, bucket,
                             aot_cache.device_kind(self.device))

    def _open(self, bucket):
        """The bucket's server, not yet warm: from its AOT cache entry
        where there is one (``_exported`` is then None), else loaded from
        its artifact."""
        if self._aot is not None:
            srv = self._aot.load_compiled(self._aot_key(bucket), self.device)
            if srv is not None:
                return srv
        return InferenceServer(self._bucket_paths[bucket], self.device)

    def _ensure_compiled(self, bucket):
        """Ready a bucket: open it (again, if it was evicted) and run it
        once on a zero feed of its shape, which builds or loads the kernel
        libraries it launches and lets cuDNN choose its algorithms.  A
        bucket loaded from its artifact is counted as a compile (one after
        warmup in ``compiles_after_warmup``) and stores its AOT cache
        entry; one readied from an entry is the cache's counted hit."""
        srv = self._compiled.get(bucket)
        if srv is not None:
            return srv
        srv = self._servers.get(bucket)
        if srv is None:
            # evicted: the artifact outlives eviction, re-open it
            srv = self._open(bucket)
            self._servers[bucket] = srv
        zeros = {n: np.zeros((bucket,) + self._example_shapes[n],
                             self._dtypes[n]) for n in self._feed_names}
        dev = self.device
        if self._on_card:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        staged = {n: srv._stage(n, a) for n, a in zeros.items()}
        with _obs.span('serving.bucket_compile'):
            outs = srv.predict_async(staged)
        feed_bytes = sum(t.numel() * t.element_size()
                         for t in staged.values())
        out_bytes = sum(o.numel() * o.element_size() for o in outs)
        temp = 0
        if self._on_card:
            torch.cuda.synchronize(dev)
            temp = max(0, torch.cuda.max_memory_allocated(dev) - base
                       - feed_bytes - out_bytes)
        srv.resident = {
            'argument_bytes': int(feed_bytes + sum(
                b.numel() * b.element_size()
                for b in srv._module.buffers())),
            'output_bytes': int(out_bytes), 'temp_bytes': int(temp),
            'code_bytes': 0}
        del staged, outs
        if srv._exported is not None:   # loaded from the artifact
            self._m.compiles.inc()
            if self._warmup_done:
                self._m.compiles_after_warmup.inc()
            if self._aot is not None:
                self._aot.store(self._aot_key(bucket), srv,
                                artifact=self._bucket_paths[bucket],
                                bucket=bucket)
        self._compiled[bucket] = srv
        self._res_gen[0] += 1
        return srv

    def evict_buckets(self, buckets=None):
        """Drop the warmed module and the loaded artifact of the given
        buckets (default: the whole ladder), for every sibling sharing
        this servable.  The artifact files stay: the next request for an
        evicted bucket loads it again (a counted post-warmup load).
        Returns the bytes freed (``resident_bytes`` delta).  A batch in
        flight keeps its own reference to the module it runs."""
        before = self.resident_bytes()['total_bytes']
        targets = (list(self._buckets) if buckets is None
                   else [int(b) for b in buckets])
        for b in targets:
            self._compiled.pop(b, None)
            self._servers.pop(b, None)
        self._res_gen[0] += 1
        return max(0, before - self.resident_bytes()['total_bytes'])

    def bucket_last_used(self):
        """{bucket: last dispatch stamp (time.monotonic)} across every
        sibling of this servable; buckets never dispatched are absent."""
        return dict(self._bucket_used)

    @property
    def residency_generation(self):
        """Bumped whenever the servable's residency changes (evict or a
        post-warmup load)."""
        return self._res_gen[0]

    # -- worker threads ------------------------------------------------
    def _pop_batch(self):
        """Pop the longest prefix of the pending queue that fits
        max_batch.  Caller holds _cv."""
        batch, rows = [], 0
        while self._pending:
            r = self._pending[0]
            if rows + r.rows > self.max_batch:
                break
            batch.append(self._pending.popleft())
            rows += r.rows
        self._pending_rows -= rows
        self._m.queue_depth.set(len(self._pending))
        return batch

    def _flush_now(self, grew_full, t_first, now):
        """The dispatch policy.  Caller holds _cv."""
        if self._in_flight >= 2:
            return False  # double-buffer window full: wait for a sync
        if grew_full:
            return True   # bucket can't grow: launch immediately
        if self._draining or self._stopping:
            return True   # retiring: flush partials, don't linger
        if self._in_flight == 0 and now - t_first >= self.linger:
            return True   # device idle: don't hoard a partial batch
        return now - t_first >= self.max_wait  # deadline flush

    def _dispatch_loop(self):
        while True:
            with self._cv:
                while True:
                    if self._stopping and not self._pending:
                        self._inflight_q.put(_STOP)
                        return
                    if self._pending:
                        now = time.perf_counter()
                        t_first = self._pending[0].t_submit
                        grew_full = self._pending_rows >= self.max_batch
                        if self._flush_now(grew_full, t_first, now):
                            batch = self._pop_batch()
                            self._in_flight += 1
                            self._m.in_flight.set(self._in_flight)
                            self._cv_space.notify_all()  # queue space
                            break
                        if self._in_flight >= 2:
                            # saturated: only a completion unblocks us,
                            # and the collector notifies then
                            self._cv.wait()
                            continue
                        # sleep until the nearest deadline; full buckets
                        # and completions notify
                        wake = t_first + self.max_wait - now
                        if self._in_flight == 0:
                            wake = min(wake, t_first + self.linger - now)
                        self._cv.wait(max(wake, 1e-4))
                    else:
                        self._cv.wait()
            self._launch(batch)

    def _run_on_card(self, srv, stacked):
        """Stage ``stacked`` (host arrays) to the card from pinned memory
        on the copy stream, launch the bucket on the serving stream
        behind that copy, and queue its outputs' copy back to pinned host
        memory.  Returns (host tensors, the event that marks them
        written); nothing here waits for the card."""
        with torch.cuda.device(self.device):
            with torch.cuda.stream(self._copy_stream):
                staged = {
                    n: torch.from_numpy(np.ascontiguousarray(a))
                    .pin_memory().to(self.device, non_blocking=True)
                    for n, a in stacked.items()}
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
            self._stream.wait_event(copied)
            with torch.cuda.stream(self._stream):
                for t in staged.values():
                    t.record_stream(self._stream)
                outs = srv.predict_async(staged)
                host = []
                for o in outs:
                    if o.dtype == torch.bfloat16:
                        o = o.float()
                    h = torch.empty(o.shape, dtype=o.dtype,
                                    pin_memory=True)
                    h.copy_(o, non_blocking=True)
                    host.append(h)
                done = torch.cuda.Event()
                done.record(self._stream)
        return host, done

    def _launch(self, reqs):
        """Stage and launch one batch without waiting for its result;
        the collector owns the sync."""
        try:
            bucket, stacked, offsets = self._assemble(reqs)
            srv = self._ensure_compiled(bucket)
            self._bucket_used[bucket] = time.monotonic()
            if self._on_card:
                outs, done = self._run_on_card(srv, stacked)
            else:
                outs, done = srv.predict_async(stacked), None
        except Exception as e:
            # the dispatch thread's forensics, tagged with this server's
            # id; it never raises, and the futures carry the error
            _tlm.maybe_dump_on_error(tag=self._m._sid)
            for r in reqs:
                r.future.set_exception(e)
            with self._cv:
                self._in_flight -= 1
                self._m.in_flight.set(self._in_flight)
                self._cv.notify()
            return
        rows = offsets[-1][1]
        t_launch = time.perf_counter()
        tl = _tlm.ring_if_armed()
        if tl is not None:
            # each request's wait, submit to dispatch, under its id and
            # the bucket it rode out in
            for r in reqs:
                tl.record('serving.queue_wait', 'span',
                          t0=r.t_submit, dur=t_launch - r.t_submit,
                          args={'request_id': r.rid, 'bucket': bucket,
                                'server': self._m._sid})
        self._m.batches.inc()
        self._m.batch_rows.inc(rows)
        self._m.batch_capacity.inc(bucket)
        self._m.occupancy.observe(rows)
        qw_b = self._m.queue_wait(bucket)
        qw_all = self._m.queue_wait('all')
        for r in reqs:
            w = t_launch - r.t_submit
            qw_b.observe(w)
            qw_all.observe(w)
        self._inflight_q.put((outs, done, reqs, offsets, bucket, t_launch))

    def _collect_loop(self):
        while True:
            item = self._inflight_q.get()
            if item is _STOP:
                return
            outs, done, reqs, offsets, bucket, t_launch = item
            try:
                if done is not None:
                    done.synchronize()
                    host = [h.numpy() for h in outs]
                else:
                    host = [(o.float() if o.dtype == torch.bfloat16 else o)
                            .numpy() for o in outs]
            except Exception as e:  # pragma: no cover - defensive
                _tlm.maybe_dump_on_error(tag=self._m._sid)
                for r in reqs:
                    r.future.set_exception(e)
                with self._cv:
                    self._in_flight -= 1
                    self._m.in_flight.set(self._in_flight)
                    self._cv.notify()
                continue
            # the device is done: open the dispatch window before fanning
            # results out, so the next batch stages while clients wake
            with self._cv:
                self._in_flight -= 1
                self._m.in_flight.set(self._in_flight)
                self._cv.notify()
            now = time.perf_counter()
            self._m.compute(bucket).observe(now - t_launch)
            self._m.compute('all').observe(now - t_launch)
            tl = _tlm.ring_if_armed()
            if tl is not None:
                tl.record('serving.compute', 'compute', t0=t_launch,
                          dur=now - t_launch,
                          args={'bucket': bucket, 'rows': offsets[-1][1],
                                'server': self._m._sid,
                                'request_ids': [r.rid for r in reqs]})
            self._m.completed.inc(len(reqs))
            for r in reqs:
                self._m.latency.observe(now - r.t_submit)
            for r, (lo, hi) in zip(reqs, offsets):
                # copy partial slices: a view would pin the whole bucket's
                # output for as long as any client holds its result
                r.future.set_result(
                    [h[lo:hi] if hi - lo == h.shape[0]
                     else h[lo:hi].copy() for h in host])

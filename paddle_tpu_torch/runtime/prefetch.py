"""Prefetch: the device-side chunk pipeline and the host-side readers.

Reference parity: paddle_tpu/runtime/prefetch.py.

- ``device_prefetch(thunks)`` is the double-buffered driver of the
  executor's prefetching ``run_steps`` (PADDLE_TPU_TORCH_DEVICE_PREFETCH):
  it primes one chunk, then runs each later staging thunk right after the
  consumer dispatched the chunk before it.  The executor enqueues a
  chunk's kernels and returns before the card has run them, so staging
  after the dispatch already overlaps the card's work; the generator pins
  that order and bounds the staged chunks alive to two.
- ``stage_columns`` stages host columns on the card through pinned blocks
  and a side stream (runtime/feed.py ``DeviceStager``).
- ``prefetch_reader`` / ``xmap_native`` (xmap_readers parity,
  python/paddle/v2/reader/decorator.py:318): producer threads that hand
  pickled samples through the native queue, whose blocking calls release
  the GIL.
"""
import pickle
import threading
import time

from .native import NativeQueue

__all__ = ['prefetch_reader', 'xmap_native', 'device_prefetch',
           'stage_columns']

_END = b'\x00__PTQ_END__'

_stagers = {}
_stagers_lock = threading.Lock()


def stage_columns(cols, device=None):
    """{name: host array} as {name: tensor on ``device``} (None: the
    card), packed into one pinned block and copied on a side stream; the
    current stream waits for the copy.  One ``DeviceStager`` per device
    (and thread) serves every call."""
    import numpy as np
    import torch
    from ..core.place import resolve_device
    from .feed import DeviceStager
    dev = resolve_device(device)
    key = (str(dev), threading.get_ident())
    with _stagers_lock:
        st = _stagers.get(key)
        if st is None:
            st = _stagers[key] = DeviceStager(dev)
    names = sorted(cols)
    views, _ = st.stage([torch.from_numpy(np.ascontiguousarray(cols[n]))
                         for n in names])
    return dict(zip(names, views))


def device_prefetch(thunks):
    """Double-buffered staging driver: run zero-argument staging thunks
    one chunk ahead of the consumer.

    Exactly one thunk is primed before the first yield (the only staging
    the card waits for); every later thunk runs right after the previous
    chunk was yielded, i.e. after the consumer dispatched it.  No thread:
    the consumer's dispatch returns before the card has finished, so
    staging after it runs beside the card's work.  At most two staged
    chunks are alive (the one in flight and the one just staged)."""
    from ..observability import timeline as _tlm

    def _run(thunk, primed):
        # a 'prefetch.stage' event per staging call: the primed one is on
        # the critical path, every later one overlaps the card's work
        tl = _tlm.ring_if_armed()
        if tl is None:
            return thunk()
        t0 = time.perf_counter()
        out = thunk()
        tl.record('prefetch.stage', 'feed', t0=t0,
                  dur=time.perf_counter() - t0,
                  args={'primed': primed})
        return out

    it = iter(thunks)
    try:
        ahead = _run(next(it), True)
    except StopIteration:
        return
    while True:
        cur, ahead = ahead, None
        yield cur
        # the consumer just dispatched `cur`; stage the next chunk while
        # the card works on it
        try:
            ahead = _run(next(it), False)
        except StopIteration:
            return


def prefetch_reader(reader, buf_size=64):
    """Wrap a sample reader so a background thread stays `buf_size`
    batches ahead of the consumer."""

    def _reader():
        q = NativeQueue(buf_size)

        def produce():
            try:
                for sample in reader():
                    if not q.push(pickle.dumps(
                            sample, protocol=pickle.HIGHEST_PROTOCOL)):
                        return  # consumer closed early
            finally:
                q.push(_END)
                q.close()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                blob = q.pop()
                if blob is None or blob == _END:
                    break
                yield pickle.loads(blob)
        finally:
            q.close()
            t.join(timeout=5)

    return _reader


def xmap_native(mapper, reader, process_num=4, buffer_size=64,
                order=False):
    """Parallel map over a reader through native queues (xmap_readers
    parity: thread workers, with the handoff buffers in C++, whose
    blocking calls release the GIL)."""

    def _reader():
        in_q = NativeQueue(buffer_size)
        out_q = NativeQueue(buffer_size)
        n_done = [0]
        errors = []
        done_lock = threading.Lock()

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    if not in_q.push(pickle.dumps((i, sample))):
                        return  # consumer closed early
            except BaseException as e:
                # a reader failure must reach the consumer, not
                # masquerade as a clean (truncated) end-of-stream —
                # and not depend on every worker finishing either: a
                # sibling stuck inside its mapper never pops its _END,
                # so the n_done countdown would never close the
                # stream.  Same ring-close as the worker path: record
                # the error, then close both queues (the consumer's
                # None pop observes `errors`)
                errors.append(e)
                in_q.close()
                out_q.close()
            finally:
                # no-ops after an error close
                for _ in range(process_num):
                    in_q.push(_END)

        def work():
            try:
                while True:
                    blob = in_q.pop()
                    if blob is None or blob == _END:
                        break
                    i, sample = pickle.loads(blob)
                    if not out_q.push(pickle.dumps((i, mapper(sample)))):
                        break  # consumer closed early
            except BaseException as e:  # surface to the consumer
                # mirror the FeedPipeline ring-close fix: record the
                # error, then CLOSE both queues instead of waiting for
                # siblings — a sibling blocked in a stuck mapper (or a
                # feeder blocked on a full in_q) would otherwise keep
                # the consumer waiting forever for an _END that never
                # comes.  `errors` is appended before the closes, so
                # the consumer's None pop observes it.
                errors.append(e)
                in_q.close()
                out_q.close()
            finally:
                # clean path: count down so the LAST finisher ends the
                # stream (a crashed worker already closed out_q; its
                # countdown push lands on a closed queue, a no-op)
                with done_lock:
                    n_done[0] += 1
                    if n_done[0] == process_num:
                        out_q.push(_END)

        threads = [threading.Thread(target=feed, daemon=True)]
        threads += [threading.Thread(target=work, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()

        pending = {}
        next_idx = 0
        try:
            while True:
                blob = out_q.pop()
                if blob is None or blob == _END:
                    break
                i, mapped = pickle.loads(blob)
                if not order:
                    yield mapped
                    continue
                pending[i] = mapped
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
            if errors:
                # fail BEFORE draining stragglers: a partial ordered
                # tail after a known failure is corrupt, not data
                raise errors[0]
            if order:  # drain any stragglers in order
                for i in sorted(pending):
                    yield pending[i]
        finally:
            in_q.close()
            out_q.close()

    return _reader

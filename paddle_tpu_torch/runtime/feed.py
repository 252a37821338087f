"""The device feed path: pinned host blocks, H2D copies on a side stream.

Reference parity: paddle_tpu/runtime/feed.py (N1 + N2: a pool of arena
blocks that hold assembled host batches, filled by producer threads while
the consumer puts the previous one on the device).  The reference's
``jax.device_put`` captures the host bytes before it returns, so its
block is free again at once.  Here the copy is asynchronous, so the rule
is different:

- a block is page-locked host memory from torch's pinned allocator
  (``torch.empty(..., pin_memory=True)``), the arena's counterpart: only
  such memory copies to the card without the driver staging it again;
- its copy to the card is enqueued on a side CUDA stream
  (``non_blocking=True``) and an event is recorded after it;
- the consuming stream waits on that event before any kernel reads the
  data (``wait_event``: the host does not wait), and ``record_stream``
  tells the caching allocator that the consuming stream uses the device
  buffer, so its memory is not handed out again while that stream's work
  is queued;
- the block returns to the pool only after the copy's event has
  completed: a block refilled before its copy ran would corrupt a later
  batch.

``DeviceStager`` packs a list of host arrays into one pinned block at
256-byte aligned offsets and returns device views of one device buffer;
the executor's prefetching ``run_steps`` stages each chunk of steps with
it.  ``FeedPipeline`` streams batches assembled by producer threads.  On
a CPU device the views lie in a fresh host buffer (no pool, no stream):
the tensors the caller gets must not alias a block that is refilled.
"""
import threading

import numpy as np
import torch

from .native import NativeQueue

__all__ = ['FeedPipeline', 'DeviceStager', 'slot_layout', 'ALIGN']

ALIGN = 256


def slot_layout(nbytes):
    """(offsets, total): each of ``nbytes`` at an ``ALIGN``-byte boundary
    of one buffer, in order."""
    offsets, total = [], 0
    for n in nbytes:
        total = (total + ALIGN - 1) // ALIGN * ALIGN
        offsets.append(total)
        total += int(n)
    return offsets, max(total, 1)


def _as_bytes(t):
    """A contiguous CPU tensor's bytes as a flat numpy uint8 array."""
    t = t.contiguous()
    return t.view(torch.uint8).reshape(-1).numpy() if t.numel() else \
        np.empty(0, np.uint8)


class _PinnedPool(object):
    """Pinned host blocks, each reusable once the copy that read it has
    completed (its event); at most ``blocks`` exist."""

    def __init__(self, blocks):
        self._blocks = int(blocks)
        self._free = []         # [(block, event or None)]
        self._made = 0
        self.waits = 0          # acquires that had to wait for a copy

    def acquire(self, nbytes):
        for i, (blk, ev) in enumerate(self._free):
            if blk.numel() >= nbytes and (ev is None or ev.query()):
                del self._free[i]
                return blk
        if self._made < self._blocks:
            self._made += 1
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        # every block is either too small or still being copied: wait for
        # the oldest copy, then grow the block if it is too small
        blk, ev = self._free.pop(0)
        if ev is not None and not ev.query():
            self.waits += 1
            ev.synchronize()
        if blk.numel() < nbytes:
            blk = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return blk

    def release(self, blk, ev):
        self._free.append((blk, ev))


class DeviceStager(object):
    """Stage host arrays to ``device`` through pinned blocks and a side
    stream (module docstring).  ``stage(tensors)`` takes CPU tensors and
    returns ``(device tensors, device buffer)``: views of one buffer at
    ``slot_layout`` offsets, safe to read on the calling thread's current
    stream."""

    def __init__(self, device, blocks=3):
        self.device = torch.device(device)
        self._cuda = self.device.type == 'cuda'
        if self._cuda:
            self._pool = _PinnedPool(blocks)
            self._stream = torch.cuda.Stream(self.device)

    @property
    def waits(self):
        return self._pool.waits if self._cuda else 0

    def stage(self, tensors, layout=None):
        tensors = [t if t.device.type == 'cpu' else t.cpu() for t in tensors]
        offsets, total = layout or slot_layout(
            t.numel() * t.element_size() for t in tensors)
        if not self._cuda:
            buf = torch.empty(total, dtype=torch.uint8)
            host = buf.numpy()
            for t, off in zip(tensors, offsets):
                b = _as_bytes(t)
                host[off:off + b.size] = b
            return self._views(buf, tensors, offsets), buf
        blk = self._pool.acquire(total)
        host = blk.numpy()
        for t, off in zip(tensors, offsets):
            b = _as_bytes(t)
            host[off:off + b.size] = b
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            buf = torch.empty(total, dtype=torch.uint8, device=self.device)
            buf.copy_(blk[:total], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._pool.release(blk, ev)
        consumer.wait_event(ev)
        buf.record_stream(consumer)
        return self._views(buf, tensors, offsets), buf

    @staticmethod
    def _views(buf, tensors, offsets):
        out = []
        for t, off in zip(tensors, offsets):
            n = t.numel() * t.element_size()
            out.append(buf[off:off + n].view(t.dtype).view(t.shape))
        return out


class FeedPipeline(object):
    """Stream {name: device tensor} feeds assembled off-thread into pinned
    blocks.

    :param specs: {name: (shape, numpy dtype)}, the per-batch layout.
    :param fill: ``fill(views, step) -> None | False`` writes the batch
        into ``views`` ({name: writable ndarray over the block}); False
        ends the stream.  With ``workers > 1`` it runs concurrently on
        distinct steps and blocks.
    :param depth: pinned blocks in flight (at least 2 a worker).
    :param device: the card by default (None); ``'cpu'`` yields host
        tensors copied out of the block.
    :param workers: producer threads.  Order is kept: worker w fills steps
        w, w + N, ... into its own ready ring and the consumer reads the
        rings round-robin; blocks are partitioned per worker (block i
        belongs to worker i mod N), so no worker can starve another.
    :param stage: False yields the raw ndarray views of the block; the
        block is recycled when the consumer advances.
    """

    def __init__(self, specs, fill, depth=3, device=None, workers=1,
                 stage=True):
        from ..core.place import resolve_device
        self._stage = stage
        self._specs = {n: (tuple(shape), np.dtype(dt))
                       for n, (shape, dt) in specs.items()}
        self._fill = fill
        self._device = resolve_device(device)
        self._workers = max(1, int(workers))
        names = sorted(self._specs)
        self._offsets, total = slot_layout(
            int(np.prod(self._specs[n][0])) * self._specs[n][1].itemsize
            for n in names)
        self._offsets = dict(zip(names, self._offsets))
        depth = max(depth, 2 * self._workers)
        if depth > 256:
            raise ValueError(
                "FeedPipeline depth %d exceeds the 256-block limit (depth "
                "is floored at 2*workers = %d; block tokens are single "
                "bytes): lower depth or workers" % (depth, 2 * self._workers))
        pin = self._device.type == 'cuda'
        self._blocks = [torch.empty(total, dtype=torch.uint8, pin_memory=pin)
                        for _ in range(depth)]
        self._free = [NativeQueue(depth + 1) for _ in range(self._workers)]
        self._ready = [NativeQueue(depth + 1) for _ in range(self._workers)]
        for i in range(depth):
            self._free[i % self._workers].push(bytes([i]))
        self._threads = [
            threading.Thread(target=self._produce, args=(w,), daemon=True)
            for w in range(self._workers)]
        self._started = False
        self._error = None
        self._stream = torch.cuda.Stream(self._device) if pin else None

    def _views(self, idx):
        host = self._blocks[idx].numpy()
        out = {}
        for n, (shape, dt) in self._specs.items():
            off = self._offsets[n]
            count = int(np.prod(shape))
            out[n] = host[off:off + count * dt.itemsize].view(dt).reshape(
                shape)
        return out

    def _produce(self, worker):
        step = worker
        while True:
            tok = self._free[worker].pop()
            if tok is None:
                return
            idx = tok[0]
            try:
                ok = self._fill(self._views(idx), step)
            except BaseException as e:
                # close every ready ring, not only this worker's: the
                # consumer may wait on another's; _error is set first, so
                # any None pop sees it
                self._error = e
                for q in self._ready:
                    q.close()
                return
            if ok is False:
                self._free[worker].push(tok)
                self._ready[worker].close()
                return
            self._ready[worker].push(bytes([idx]))
            step += self._workers

    def _recycle(self, pending, worker):
        """Return the blocks whose copies completed to their workers' free
        rings.  When ``worker`` has no batch ready and holds blocks still
        being copied, wait for its oldest copy: its producer may be
        waiting for that block."""
        for item in list(pending):
            idx, ev = item
            if ev.query():
                pending.remove(item)
                self._free[idx % self._workers].push(bytes([idx]))
        if self._ready[worker].qsize() == 0:
            mine = [it for it in pending if it[0] % self._workers == worker]
            if mine:
                mine[0][1].synchronize()
                pending.remove(mine[0])
                self._free[worker].push(bytes([mine[0][0]]))

    def __iter__(self):
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()
        pending = []   # (block, copy event) not yet back in a free ring
        k = 0
        while True:
            self._recycle(pending, k % self._workers)
            tok = self._ready[k % self._workers].pop()
            if tok is None:
                if self._error is not None:
                    raise RuntimeError(
                        "feed pipeline producer failed") from self._error
                return
            idx = tok[0]
            views = self._views(idx)
            if not self._stage:
                yield views
                self._free[idx % self._workers].push(bytes([idx]))
                k += 1
                continue
            if self._stream is None:
                feed = {n: torch.from_numpy(v.copy())
                        for n, v in views.items()}
                self._free[idx % self._workers].push(bytes([idx]))
            else:
                blk = self._blocks[idx]
                consumer = torch.cuda.current_stream(self._device)
                with torch.cuda.stream(self._stream):
                    buf = torch.empty(blk.numel(), dtype=torch.uint8,
                                      device=self._device)
                    buf.copy_(blk, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self._stream)
                consumer.wait_event(ev)
                buf.record_stream(consumer)
                pending.append((idx, ev))
                feed = {}
                for n, (shape, dt) in self._specs.items():
                    off = self._offsets[n]
                    nb = int(np.prod(shape)) * dt.itemsize
                    tdt = torch.from_numpy(np.empty(0, dt)).dtype
                    feed[n] = buf[off:off + nb].view(tdt).view(shape)
            k += 1
            yield feed

    def close(self):
        for q in self._free:
            q.close()
        for q in self._ready:
            q.close()

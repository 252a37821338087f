"""The port's feed runtime (paddle_tpu_torch/runtime/) against the
reference's (paddle_tpu/runtime/), on the CPU.

- The port's own copy of the native library builds with g++ and loads;
  the queue keeps order, blocks at capacity, closes, and sums across
  producers and consumers.
- Record files written by either package's native writer are read back
  bitwise by the other's native reader and by both Python readers; the
  CRC catches corruption; an exhausted reader keeps stopping.
- With PADDLE_TPU_TORCH_USE_NATIVE_RUNTIME off the pure-Python classes
  run (same contracts); with it on, a library that does not build raises
  ``NativeBuildError`` (the reference quietly falls back).
- The staging arena recycles blocks; ``prefetch_reader`` and
  ``xmap_native`` give the reference's samples, in order when asked,
  and carry a mapper's error to the consumer.
- ``FeedPipeline`` and ``DeviceStager`` on the CPU device: batches in
  order from several workers, a producer's error raised in the consumer,
  staged slots at 256-byte offsets equal to their sources bitwise.
"""
import os
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import io_recordio as jrecordio
from paddle_tpu import runtime as jrt

from paddle_tpu_torch import io_recordio as trecordio
from paddle_tpu_torch import runtime as trt
from paddle_tpu_torch.runtime import native as tnative


def test_native_library_builds_from_the_ports_copy():
    assert trt.available()
    assert tnative._so_path.endswith('libpaddle_tpu_torch_native.so')
    assert os.path.dirname(tnative._src).endswith(
        os.path.join('paddle_tpu_torch', 'runtime'))


@pytest.mark.parametrize('native', [True, False], ids=['cpp', 'python'])
def test_queue_order_close_backpressure(native, monkeypatch):
    if not native:
        monkeypatch.setenv('PADDLE_TPU_TORCH_USE_NATIVE_RUNTIME', '0')
    q = trt.NativeQueue(capacity=4)
    assert q.native is native
    for i in range(4):
        assert q.push(b'item%d' % i)
    assert q.qsize() == 4
    assert [q.pop() for _ in range(4)] == [b'item%d' % i for i in range(4)]
    q.close()
    assert q.pop() is None and not q.push(b'late')

    q = trt.NativeQueue(capacity=2)

    def producer():
        for i in range(10):
            q.push(bytes([i]))
        q.close()

    t = threading.Thread(target=producer)
    t.start()
    got = []
    while True:
        b = q.pop()
        if b is None:
            break
        got.append(b[0])
    t.join(5)
    assert got == list(range(10))


def test_queue_multi_producer_consumer_totals():
    q = trt.NativeQueue(capacity=8)
    n_prod, per = 4, 50
    got, lock = [], threading.Lock()

    def producer(p):
        for i in range(per):
            q.push(b'%d:%d' % (p, i))

    def consumer():
        while True:
            b = q.pop()
            if b is None:
                return
            with lock:
                got.append(b)

    cons = [threading.Thread(target=consumer) for _ in range(3)]
    prods = [threading.Thread(target=producer, args=(p,))
             for p in range(n_prod)]
    for t in cons + prods:
        t.start()
    for t in prods:
        t.join(10)
    q.close()
    for t in cons:
        t.join(10)
    assert sorted(got) == sorted(b'%d:%d' % (p, i) for p in range(n_prod)
                                 for i in range(per))


PAYLOADS = [b'alpha', b'', b'x' * 10000, np.arange(100).tobytes(),
            np.random.RandomState(0).bytes(4097)]


def test_record_files_cross_both_packages_bitwise(tmp_path):
    assert jrt.available()
    t_path, j_path = str(tmp_path / 't.rio'), str(tmp_path / 'j.rio')
    with trt.NativeRecordWriter(t_path) as w:
        for p in PAYLOADS:
            w.write(p)
    with jrt.NativeRecordWriter(j_path) as w:
        for p in PAYLOADS:
            w.write(p)
    with open(t_path, 'rb') as a, open(j_path, 'rb') as b:
        assert a.read() == b.read()
    for path in (t_path, j_path):
        assert list(jrt.NativeRecordReader(path)) == PAYLOADS
        assert list(trt.NativeRecordReader(path)) == PAYLOADS
        assert list(jrecordio.read_records(path)) == PAYLOADS
        assert list(trecordio.read_records(path)) == PAYLOADS


def test_record_reader_crc_and_exhaustion(tmp_path):
    path = str(tmp_path / 'c.rio')
    with trt.NativeRecordWriter(path) as w:
        w.write(b'payload-payload')
    r = trt.NativeRecordReader(path)
    assert list(r) == [b'payload-payload']
    with pytest.raises(StopIteration):
        next(r)
    r.close()
    with open(path, 'r+b') as f:
        f.seek(-3, os.SEEK_END)
        f.write(b'XXX')
    with pytest.raises(IOError, match='crc'):
        list(trt.NativeRecordReader(path))


def test_python_classes_with_native_off(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_USE_NATIVE_RUNTIME', '0')
    assert not trt.available()
    path = str(tmp_path / 'p.rio')
    with trt.NativeRecordWriter(path) as w:
        for p in PAYLOADS:
            w.write(p)
    assert list(jrt.NativeRecordReader(path)) == PAYLOADS
    arena = trt.StagingArena(block_size=64, blocks=1)
    mv, tok = arena.acquire()
    assert len(mv) == 64 and arena.free_blocks() == 0
    arena.release(tok)
    assert arena.free_blocks() == 1


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / 'broken.cc'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(tnative, '_lib', None)
    monkeypatch.setattr(tnative, '_src', str(bad))
    monkeypatch.setattr(tnative, '_so_path', str(tmp_path / 'lib.so'))
    monkeypatch.setattr(tnative, '_build_dir', str(tmp_path))
    with pytest.raises(tnative.NativeBuildError, match='g\\+\\+ failed'):
        trt.NativeQueue(4)


def test_staging_arena_reuse():
    arena = trt.StagingArena(block_size=1024, blocks=2)
    mv1, tok1 = arena.acquire()
    mv2, tok2 = arena.acquire()
    assert arena.free_blocks() == 0
    mv1[:5] = b'hello'
    assert bytes(np.frombuffer(mv1, np.uint8, count=5)) == b'hello'
    del mv1, mv2
    arena.release(tok1)
    arena.release(tok2)
    assert arena.free_blocks() == 2


def test_prefetch_and_xmap_readers_equal_the_reference():
    def src():
        for i in range(40):
            yield {'i': i, 'v': np.arange(i % 5)}

    def key(s):
        return (s['i'], s['v'].tolist())

    want = [key(s) for s in jrt.prefetch_reader(src, 4)()]
    assert [key(s) for s in trt.prefetch_reader(src, 4)()] == want

    def mapper(s):
        return s['i'] * 3

    ref = list(jrt.xmap_native(mapper, src, 3, 8, order=True)())
    assert list(trt.xmap_native(mapper, src, 3, 8, order=True)()) == ref
    assert sorted(trt.xmap_native(mapper, src, 3, 8)()) == sorted(ref)

    def bad(s):
        if s['i'] == 7:
            raise ValueError('bad sample')
        return s

    with pytest.raises(ValueError, match='bad sample'):
        list(trt.xmap_native(bad, src, 3, 4, order=True)())


def _fill(views, step):
    if step >= 9:
        return False
    views['a'][...] = step
    views['b'][...] = -step


SPECS = {'a': ((3, 5), np.float32), 'b': ((7,), np.int64)}


@pytest.mark.parametrize('workers', [1, 3])
def test_feed_pipeline_order_on_the_cpu(workers):
    fp = trt.FeedPipeline(SPECS, _fill, depth=4, device='cpu',
                          workers=workers)
    seen = []
    for feed in fp:
        assert isinstance(feed['a'], torch.Tensor)
        assert feed['a'].shape == (3, 5) and feed['b'].dtype == torch.int64
        seen.append(int(feed['a'][0, 0]))
        assert (feed['b'] == -seen[-1]).all()
    assert seen == list(range(9))
    raw = trt.FeedPipeline(SPECS, _fill, device='cpu', stage=False)
    assert [int(v['a'][0, 0]) for v in raw] == list(range(9))


def test_feed_pipeline_error_reaches_the_consumer():
    def fill(views, step):
        if step == 4:
            raise KeyError('broken batch')
        views['a'][...] = step

    fp = trt.FeedPipeline(SPECS, fill, device='cpu', workers=2)
    with pytest.raises(RuntimeError, match='producer failed') as e:
        list(fp)
    assert isinstance(e.value.__cause__, KeyError)


def test_device_stager_packs_aligned_slots():
    from paddle_tpu_torch.runtime.feed import ALIGN, DeviceStager, slot_layout
    rng = np.random.RandomState(4)
    srcs = [torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 9, (13, 1)).astype(np.int32)),
            torch.from_numpy(rng.randn(2).astype(np.float32)).bfloat16(),
            torch.tensor([True, False, True])]
    offsets, total = slot_layout(t.numel() * t.element_size()
                                 for t in srcs)
    assert all(o % ALIGN == 0 for o in offsets)
    views, buf = DeviceStager('cpu').stage(srcs)
    assert buf.numel() == total
    for v, s in zip(views, srcs):
        assert v.dtype == s.dtype and v.shape == s.shape
        assert torch.equal(v.view(torch.uint8) if v.dtype == torch.bool
                           else v, s.view(torch.uint8)
                           if s.dtype == torch.bool else s)
    staged = trt.stage_columns({'x': srcs[0].numpy()}, 'cpu')
    assert torch.equal(staged['x'], srcs[0])

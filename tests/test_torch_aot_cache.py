"""The AOT cache (paddle_tpu_torch/inference/aot_cache.py) on the CPU: the
cache's own contract, as tests/test_aot_cache.py holds the reference's.

The reference persists XLA's compiled executable; the port persists a
bucket's lifted graph code and state, so the entry here is made from a
loaded ``InferenceServer`` of a small artifact (the 6 -> 16 -> 4 MLP)
rather than a jitted function, and its round trip is held bitwise to the
artifact's own answers.  Entries key on the device kind ('cpu' here), the
torch and CUDA versions; a header for others is a counted miss, a body or
header that does not parse a counted corrupt entry, both read as misses;
an object that is not a loaded server is not stored; the orphan sweep
removes others' tmp files and entries whose artifact is gone, and keeps
the rest.  The serving-level contract (a fresh fleet over a warm cache
compiles nothing) is in tests/test_torch_tenancy.py.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfl
from paddle_tpu_torch.inference import InferenceServer, export_inference
from paddle_tpu_torch.inference.aot_cache import (AotCache,
                                                  artifact_digest,
                                                  device_kind)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_AOT_CACHE_DIR', str(tmp_path))
    c = AotCache()
    assert c.enabled()
    return c


@pytest.fixture(scope='module')
def compiled(tmp_path_factory):
    """A loaded bucket: the MLP exported at batch 4 and opened."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 11
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[6], dtype='float32')
        h = tfl.layers.fc(input=x, size=16, act='relu')
        pred = tfl.layers.fc(input=h, size=4)
    exe, scope = tfl.Executor('cpu'), tfl.Scope()
    exe.run(startup, scope=scope)
    path = str(tmp_path_factory.mktemp('aot_art') / 'bucket_4.pt2')
    export_inference(path, {'x': (4, 6)}, [pred], executor=exe,
                     main_program=main, scope=scope)
    return InferenceServer(path, device='cpu')


def _artifact(tmp_path, name='bucket_4.pt2', data=b'module'):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def _key(art, bucket=4):
    return AotCache.key(artifact_digest(art), bucket, 'cpu')


def test_disabled_without_flag(monkeypatch):
    monkeypatch.delenv('PADDLE_TPU_TORCH_AOT_CACHE_DIR', raising=False)
    c = AotCache()
    assert not c.enabled()
    assert c.load_compiled('0' * 40, 'cpu') is None
    assert c.store('0' * 40, object()) is False
    assert c.sweep_orphans() == []


def test_key_is_stable_and_sensitive(tmp_path):
    art = _artifact(tmp_path)
    d = artifact_digest(art)
    assert d == artifact_digest(art)
    k = AotCache.key(d, 4, 'cpu')
    assert k == AotCache.key(d, 4, 'cpu')
    assert k != AotCache.key(d, 8, 'cpu')
    assert k != AotCache.key(d, 4, 'NVIDIA H100 80GB HBM3')
    assert device_kind('cpu') == 'cpu'
    d2 = artifact_digest(_artifact(tmp_path, 'other.pt2', b'x'))
    assert k != AotCache.key(d2, 4, 'cpu')


def test_store_load_roundtrip(cache, compiled, tmp_path):
    key = _key(compiled.path)
    s0 = AotCache.stats()
    assert cache.load_compiled(key, 'cpu') is None
    assert cache.store(key, compiled, artifact=compiled.path, bucket=4)
    srv = cache.load_compiled(key, 'cpu')
    assert srv is not None and srv._exported is None
    assert srv.feed_avals() == compiled.feed_avals()
    x = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    got, = srv.predict({'x': x})
    want, = compiled.predict({'x': x})
    np.testing.assert_array_equal(got, want)
    assert sum(b.numel() for b in srv._module.buffers()) == \
        sum(b.numel() for b in compiled._module.buffers())
    s1 = AotCache.stats()
    assert s1['misses'] == s0['misses'] + 1
    assert s1['stores'] == s0['stores'] + 1
    assert s1['hits'] == s0['hits'] + 1
    assert s1['corrupt'] == s0['corrupt']
    # a hit is not persistable itself: it has no exported program
    assert cache.store(_key(compiled.path, 8), srv) is False


def test_header_mismatch_is_counted_miss(cache, compiled):
    key = _key(compiled.path)
    assert cache.store(key, compiled, artifact=compiled.path, bucket=4)
    p = cache.path(key)
    with open(p, 'rb') as f:
        hdr = json.loads(f.readline().decode())
        body = f.read()
    for field, other in (('torch', '0.0.0-someday'),
                         ('device_kind', 'NVIDIA H100 80GB HBM3'),
                         ('schema', 0)):
        with open(p, 'wb') as f:
            f.write(json.dumps(dict(hdr, **{field: other})).encode()
                    + b'\n' + body)
        s0 = AotCache.stats()
        assert cache.load_compiled(key, 'cpu') is None
        s1 = AotCache.stats()
        assert s1['misses'] == s0['misses'] + 1, field
        assert s1['corrupt'] == s0['corrupt'], field


def test_corrupt_entry_counts_and_reads_as_miss(cache, compiled):
    key = _key(compiled.path)
    assert cache.store(key, compiled, artifact=compiled.path, bucket=4)
    p = cache.path(key)
    with open(p, 'rb') as f:
        hdr_line = f.readline()
    with open(p, 'wb') as f:
        f.write(hdr_line + b'\x00garbage-not-a-zip')
    s0 = AotCache.stats()
    assert cache.load_compiled(key, 'cpu') is None
    assert AotCache.stats()['corrupt'] == s0['corrupt'] + 1
    with open(p, 'wb') as f:
        f.write(b'\xff\xfe not json\n')
    assert cache.load_compiled(key, 'cpu') is None
    assert AotCache.stats()['corrupt'] == s0['corrupt'] + 2


def test_unpicklable_executable_degrades_quietly(cache, tmp_path):
    art = _artifact(tmp_path)
    key = _key(art)
    assert cache.store(key, object(), artifact=art) is False
    assert not os.path.exists(cache.path(key))


def test_sweep_orphans(cache, compiled, tmp_path):
    live_art = _artifact(tmp_path, 'live.pt2', b'live')
    dead_art = _artifact(tmp_path, 'dead.pt2', b'dead')
    k_live, k_dead, k_anon = _key(live_art, 1), _key(dead_art, 2), \
        _key(live_art, 3)
    assert cache.store(k_live, compiled, artifact=live_art, bucket=1)
    assert cache.store(k_dead, compiled, artifact=dead_art, bucket=2)
    assert cache.store(k_anon, compiled, artifact=None, bucket=3)
    os.remove(dead_art)   # as gc_versions removes a version
    foreign_tmp = os.path.join(cache.root,
                               'aot_dead.bin.tmp.%d' % (os.getpid() + 1))
    own_tmp = os.path.join(cache.root, 'aot_x.bin.tmp.%d' % os.getpid())
    alien = os.path.join(cache.root, 'NOT_OURS.txt')
    for p in (foreign_tmp, own_tmp, alien):
        open(p, 'wb').close()
    s0 = AotCache.stats()
    removed = cache.sweep_orphans()
    assert sorted(removed) == sorted([os.path.basename(cache.path(k_dead)),
                                      os.path.basename(foreign_tmp)])
    assert AotCache.stats()['orphans'] == s0['orphans'] + 2
    for p in (cache.path(k_live), cache.path(k_anon), own_tmp, alien):
        assert os.path.exists(p)
    assert cache.load_compiled(k_live, 'cpu') is not None


def test_poisoned_header_is_swept(cache, compiled):
    key = _key(compiled.path)
    assert cache.store(key, compiled, artifact=compiled.path, bucket=4)
    with open(cache.path(key), 'wb') as f:
        f.write(b'\xff\xfe broken\n')
    removed = cache.sweep_orphans()
    assert os.path.basename(cache.path(key)) in removed


def test_entry_state_loads_on_the_device_asked(cache, compiled):
    """The body's state is host tensors; a hit puts them on the device it
    is asked for (the CPU here), and its module's outputs keep the
    artifact's dtypes."""
    key = _key(compiled.path)
    assert cache.store(key, compiled, artifact=compiled.path, bucket=4)
    srv = cache.load_compiled(key, torch.device('cpu'))
    assert all(b.device.type == 'cpu' for b in srv._module.buffers())
    out, = srv.predict_async({'x': torch.zeros(4, 6)})
    assert out.dtype == torch.float32 and out.shape == (4, 4)
    with pytest.raises(ValueError, match='shape'):
        srv.predict_async({'x': torch.zeros(2, 6)})

"""Exported-program serving (paddle_tpu_torch/inference/serving.py) on the
CPU, against the reference's (paddle_tpu/inference/serving.py, which
tests/test_serving.py runs on the CPU).

- Cross-package: the port's ``export_inference`` -> ``InferenceServer
  .predict`` against the reference's on the same program and state
  (built by ``paddle_tpu`` and handed over, tests/torch_serving_cases.py),
  within 1e-5 absolute: an fc net, ``resnet_cifar10`` at depth 8 on
  32x32 images, and the transformer LM at L=2, D=64, H=2, T=32, whose
  ``flash_attention`` ops export as the ``paddle_tpu_torch::flash_fwd``
  operator and run its CPU implementation (the kernel's plain version).
  Float32 sums in other orders: softmax outputs and O(10) logits.
- The port's artifact equals ``Executor.run`` of the same program
  bitwise.
- Each case of tests/test_serving.py has a counterpart: round trip;
  ``predict_many`` / ``predict_async`` equal to ``predict`` bitwise;
  example-arg dtypes; a bfloat16 feed var exporting a bfloat16 input;
  device values passed through ``predict_many`` without a host copy.
- Export on the card raises, naming the op, for an op that launches a
  kernel through ctypes; entry points default to the card, so on a host without one
  they raise unless given ``device='cpu'``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.inference import serving as jserving

import paddle_tpu_torch as tfl
from paddle_tpu_torch.inference import InferenceServer, serving
from paddle_tpu_torch.inference.serving import (_example_args,
                                                export_inference)

import torch_serving_cases as cases

TOL = 1e-5


def _export_both(tmp_path, net, feed, **kw):
    """Export ``net`` at ``feed``'s shapes through both packages;
    returns (reference server, port server, port pieces)."""
    jmain, jexe, jscope, out = cases.reference(net, **kw)
    shapes = {n: a.shape for n, a in feed.items()}
    jpath = str(tmp_path / 'ref.stablehlo')
    jserving.export_inference(jpath, shapes, [out], executor=jexe,
                              main_program=jmain, scope=jscope)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    tpath = str(tmp_path / 'port.pt2')
    size = export_inference(tpath, shapes, [out.name], executor=texe,
                            main_program=tmain, scope=tscope)
    assert size > 0
    return (jserving.InferenceServer(jpath),
            InferenceServer(tpath, device='cpu'),
            (tmain, texe, tscope, out.name, tpath))


def _cross_package(tmp_path, net, feed, **kw):
    jsrv, tsrv, (tmain, texe, tscope, fetch, path) = _export_both(
        tmp_path, net, feed, **kw)
    want, = jsrv.predict(feed)
    got, = tsrv.predict(feed)
    assert got.shape == want.shape
    assert np.abs(got - np.asarray(want)).max() <= TOL
    run, = texe.run(tmain.prune([fetch], list(feed)).inference_optimize(),
                    feed=feed, fetch_list=[fetch], scope=tscope)
    np.testing.assert_array_equal(got, run)
    return tsrv, path


def test_fc_net_serves_as_the_reference(tmp_path):
    feed = {'x': np.random.default_rng(0).standard_normal(
        (4, 6)).astype(np.float32)}
    tsrv, _ = _cross_package(tmp_path, cases.fc_net, feed)
    got, = tsrv.predict(feed)
    np.testing.assert_allclose(got.sum(axis=1), np.ones(4), rtol=1e-5)


def test_resnet_cifar10_serves_as_the_reference(tmp_path):
    feed = {'img': np.random.default_rng(1).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)}
    _cross_package(tmp_path, cases.resnet8, feed)


def test_transformer_serves_as_the_reference_through_the_flash_op(
        tmp_path):
    feed = {'src': np.random.default_rng(2).integers(
        0, 100, (2, 32)).astype(np.int64)}
    tsrv, path = _cross_package(tmp_path, cases.transformer_logits, feed)
    ep = torch.export.load(path)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    assert targets.count('paddle_tpu_torch.flash_fwd.default') == 2
    assert tsrv.feed_avals()['src'] == ((2, 32), torch.int32)


def _fc_server(tmp_path, batch=2, d_in=5, seed=3):
    jmain, jexe, jscope, out = cases.reference(
        cases.fc_net, seed=seed, d_in=d_in, hidden=8, classes=4)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    path = str(tmp_path / 'm.pt2')
    export_inference(path, {'x': (batch, d_in)}, [out.name], executor=texe,
                     main_program=tmain, scope=tscope)
    return InferenceServer(path, device='cpu'), tmain, texe, tscope, out


def test_export_and_serve_roundtrip(tmp_path):
    srv, tmain, texe, tscope, out = _fc_server(tmp_path, batch=4, d_in=6)
    feed = {'x': np.random.RandomState(0).randn(4, 6).astype('float32')}
    want, = texe.run(tmain, feed=feed, fetch_list=[out.name], scope=tscope)
    got, = srv.predict(feed)
    np.testing.assert_array_equal(got, want)
    run = serving.load_exported(srv.path, device='cpu')
    np.testing.assert_array_equal(run(feed)[0], want)


def test_predict_many_and_async_match_predict(tmp_path):
    srv, *_ = _fc_server(tmp_path)
    rng = np.random.RandomState(1)
    feeds = [{'x': rng.randn(2, 5).astype('float32')} for _ in range(5)]
    want = [srv.predict(f)[0] for f in feeds]
    got_many = srv.predict_many(feeds)
    assert len(got_many) == 5
    for w, outs in zip(want, got_many):
        np.testing.assert_array_equal(outs[0], w)
    pending = [srv.predict_async(f) for f in feeds]
    for w, outs in zip(want, pending):
        assert torch.is_tensor(outs[0])
        np.testing.assert_array_equal(outs[0].numpy(), w)
    stacked = srv.predict_stacked({'x': np.stack([f['x'] for f in feeds])})
    assert stacked[0].shape == (5, 2, 4)
    with pytest.raises(ValueError, match='disagrees'):
        srv.predict_stacked({'x': np.stack([f['x'] for f in feeds])}, k=4)
    assert srv.predict_many([]) == []


def test_example_args_honour_declared_dtypes():
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        tfl.layers.data(name='xb', shape=[4], dtype='bfloat16')
        tfl.layers.data(name='ids', shape=[1], dtype='int64')
        tfl.layers.data(name='mask', shape=[4], dtype='bool')
        tfl.layers.data(name='xf', shape=[4], dtype='float32')
        tfl.layers.data(name='xd', shape=[4], dtype='float64')
    shapes = {'xb': (2, 4), 'ids': (2, 1), 'mask': (2, 4),
              'xf': (2, 4), 'xd': (2, 4), 'unknown': (2, 3)}
    out = _example_args(main, shapes)
    assert {n: t.dtype for n, t in out.items()} == {
        'xb': torch.bfloat16, 'ids': torch.int32, 'mask': torch.bool,
        'xf': torch.float32, 'xd': torch.float32, 'unknown': torch.float32}
    for name, shape in shapes.items():
        assert tuple(out[name].shape) == shape
        assert not out[name].any()


def test_bf16_feed_var_exports_bf16_artifact(tmp_path):
    def net():
        x = fluid.layers.data(name='x', shape=[4], dtype='bfloat16')
        return fluid.layers.fc(input=x, size=3)
    jmain, _, jscope, pred = cases.reference(net, seed=5)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    path = str(tmp_path / 'bf16.pt2')
    export_inference(path, {'x': (2, 4)}, [pred.name], executor=texe,
                     main_program=tmain, scope=tscope)
    srv = InferenceServer(path, device='cpu')
    avals = srv.feed_avals()
    assert avals['x'].dtype == torch.bfloat16
    assert avals['x'].shape == (2, 4)
    got, = srv.predict({'x': np.ones((2, 4), np.float32)})
    assert got.shape == (2, 3) and np.isfinite(got).all()


def test_predict_many_passes_device_values_through(tmp_path, monkeypatch):
    """Tensors already on the device stack where they lie: the only copy
    to a host array is the final fetch of the one stacked output."""
    srv, *_ = _fc_server(tmp_path, seed=6)
    rng = np.random.RandomState(2)
    host_feeds = [{'x': rng.randn(2, 5).astype('float32')}
                  for _ in range(3)]
    want = srv.predict_many(host_feeds)
    device_feeds = [{'x': torch.from_numpy(f['x'])} for f in host_feeds]
    dragged = []
    real = torch.Tensor.numpy

    def spy(self, *a, **kw):
        dragged.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, 'numpy', spy)
    got = srv.predict_many(device_feeds)
    monkeypatch.undo()
    assert dragged == [(3, 2, 4)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0], w[0])


def _lstm_program():
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[3, 16], dtype='float32',
                            lod_level=1)
        h, _ = tfl.layers.dynamic_lstm(input=x, size=16)
    return main, startup, h


def _fake_cuda(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device='cuda')


def test_export_on_the_card_refuses_unwrapped_kernels(tmp_path,
                                                      monkeypatch):
    """Every ctypes launch refuses fake CUDA tensors (torch.export's) at
    the kernel loader, before reading a data pointer; export names the op
    that reached it.  The CPU has no card, so the program-level case
    routes the lstm op's CPU path into the loader, as its CUDA path goes
    there first."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from paddle_tpu_torch.ops.kernels import (build, dense_update, gru,
                                              lstm, table_update)
    e = _fake_cuda
    calls = {
        'lstm_fwd': lambda: lstm._lstm_forward(e(3, 2, 64), e(16, 64),
                                               e(3, 16), False),
        'gru_fwd': lambda: gru._gru_forward(e(3, 2, 48), e(16, 48), None,
                                            False),
        'dense_update': lambda: dense_update.dense_apply_sgd(
            e(8, 4), e(8, 4), e(1)),
        'table_update': lambda: table_update.sparse_apply_sgd(
            e(8, 4), e(3, dtype=torch.int64), e(3, 4), e(1)),
    }
    with FakeTensorMode():
        for kernel, call in calls.items():
            with pytest.raises(NotImplementedError,
                               match=r'%s.*item 8b' % kernel):
                call()
    main, startup, h = _lstm_program()
    exe, scope = tfl.Executor('cpu'), tfl.Scope()
    exe.run(startup, scope=scope)
    monkeypatch.setattr(lstm, '_plain_lstm_forward',
                        lambda *a: build.load('lstm_fwd'))
    with pytest.raises(NotImplementedError,
                       match=r"op 'lstm': kernel lstm_fwd.*item 8b"):
        export_inference(str(tmp_path / 'lstm.pt2'),
                         {'x': (2, 3, 16), 'x@LEN': (2,)},
                         [h], executor=exe, main_program=main, scope=scope)


def test_entry_points_default_to_the_card(tmp_path):
    srv, *_ = _fc_server(tmp_path)
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(srv.path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_inference(str(tmp_path / 'x.pt2'), {'x': (2, 5)}, ['x'])

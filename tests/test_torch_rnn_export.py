"""RNN programs through ``torch.export`` on the CPU: the forwards of #7
and #9 as the operators ``paddle_tpu_torch::lstm_fwd`` / ``gru_fwd``
(paddle_tpu_torch/ops/kernels/lstm.py, gru.py).

- The book's stacked LSTM classifier (``sentiment.stacked_lstm_net``,
  3 layers, the even one reversed) and the seq2seq translator's
  bidirectional GRU encoder (``seq2seq.encoder``), each at a small width,
  built and initialised by the reference and handed over
  (tests/torch_serving_cases.py): the export succeeds, its graph holds
  one operator node a layer, the artifact equals ``Executor.run`` of the
  same program bitwise (the operators' CPU implementations are the
  kernels' plain versions, which the executor runs too), and both equal
  the reference's ``Executor.run`` within 1e-5 absolute (its CPU
  executor takes its scan path: float32 sums in other orders).
- A width that is not a multiple of 4 pads outside the operator and
  exports the same way.
- Each operator's CPU implementation is its plain version, bitwise, with
  and without the gates (then an empty tensor); the training path
  (``lstm_scan`` / ``gru_scan`` with gradients) gives the same values
  and gradients, bitwise, as the direct call of the forward that the
  operator wraps.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import sentiment as jsent
from paddle_tpu.models import seq2seq as jseq

from paddle_tpu_torch.inference import InferenceServer, export_inference
from paddle_tpu_torch.ops.kernels import gru as gk
from paddle_tpu_torch.ops.kernels import lstm as lk

import torch_serving_cases as cases

TOL = 1e-5
B, T, V = 3, 6, 50


def _words():
    return fluid.layers.data(name='words', shape=[1], dtype='int64',
                             lod_level=1)


def _sentiment(hid=16):
    data = _words()
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    _, _, prediction = jsent.stacked_lstm_net(
        data, label, V, emb_dim=8, hid_dim=hid, stacked_num=3)
    return prediction


def _encoder():
    return jseq.encoder(_words(), V, word_dim=8, hidden_dim=8)


def _feed(seed):
    rng = np.random.default_rng(seed)
    ln = rng.integers(2, T + 1, B).astype(np.int32)
    ln[0] = T
    return rng.integers(1, V, (B, T, 1)).astype(np.int64), ln


def _export_and_serve(tmp_path, net, op, n_ops, **kw):
    jmain, jexe, jscope, out = cases.reference(net, **kw)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    path = str(tmp_path / 'rnn.pt2')
    export_inference(path, {'words': (B, T, 1), 'words@LEN': (B,)},
                     [out.name], executor=texe, main_program=tmain,
                     scope=tscope)
    srv = InferenceServer(path, device='cpu')
    targets = [str(n.target) for n in srv._exported.graph.nodes
               if n.op == 'call_function']
    assert targets.count('paddle_tpu_torch.%s.default' % op) == n_ops
    ids, ln = _feed(7)
    got, = srv.predict({'words': ids, 'words@LEN': ln})
    infer = tmain.prune([out.name], ['words']).inference_optimize()
    run, = texe.run(infer, feed={'words': (ids, ln)},
                    fetch_list=[out.name], scope=tscope)
    np.testing.assert_array_equal(got, run)
    jinfer = jmain.prune([out], ['words']).inference_optimize()
    want, = jexe.run(jinfer, feed={'words': (ids, ln)}, fetch_list=[out],
                     scope=jscope)
    assert got.shape == np.asarray(want).shape
    assert np.abs(got - np.asarray(want)).max() <= TOL
    return got


def test_stacked_lstm_classifier_exports_through_the_operator(tmp_path):
    got = _export_and_serve(tmp_path, _sentiment, 'lstm_fwd', 3)
    np.testing.assert_allclose(got.sum(axis=1), np.ones(B), rtol=1e-5)


def test_gru_encoder_exports_through_the_operator(tmp_path):
    got = _export_and_serve(tmp_path, _encoder, 'gru_fwd', 2)
    assert got.shape == (B, T, 16)


def test_padded_width_exports(tmp_path):
    """hid 120 is H=30: lstm_scan pads to 32 around the operator."""
    _export_and_serve(tmp_path, lambda: _sentiment(hid=120), 'lstm_fwd', 3)


def _lstm_inputs(seed, t=5, b=3, h=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((t, b, 4 * h), generator=g),
            torch.randn((h, 4 * h), generator=g) * 0.3,
            torch.randn((3, h), generator=g) * 0.3)


def _gru_inputs(seed, t=5, b=3, h=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((t, b, 3 * h), generator=g),
            torch.randn((h, 3 * h), generator=g) * 0.3,
            torch.randn((b, h), generator=g))


def test_operators_are_their_plain_versions_on_the_cpu():
    x, w, pw = _lstm_inputs(0)
    hs, cs, gates = lk.lstm_fwd(x, w, pw, True)
    for a, b in zip((hs, cs, gates), lk._plain_lstm_forward(x, w, pw)):
        assert torch.equal(a, b)
    hs2, cs2, none = lk.lstm_fwd(x, w, pw, False)
    assert torch.equal(hs2, hs) and torch.equal(cs2, cs)
    assert none.numel() == 0
    x, w, h0 = _gru_inputs(1)
    for init in (h0, None):
        hs, gates = gk.gru_fwd(x, w, init, True)
        for a, b in zip((hs, gates), gk._plain_gru_forward(x, w, init)):
            assert torch.equal(a, b)
        hs2, none = gk.gru_fwd(x, w, init, False)
        assert torch.equal(hs2, hs) and none.numel() == 0
    with pytest.raises(ValueError, match='do not match'):
        lk.lstm_fwd(x, w, pw, False)


class _DirectLSTM(torch.autograd.Function):
    """_LSTMScan with the forward's direct call in place of the
    operator."""

    @staticmethod
    def forward(ctx, x, w, pw):
        hs, cs, gates = lk._lstm_forward(x, w, pw, with_gates=True)
        ctx.save_for_backward(w, pw, hs, cs, gates)
        ctx.set_materialize_grads(False)
        return hs, cs

    @staticmethod
    def backward(ctx, ct_h, ct_c):
        return lk._lstm_backward(*ctx.saved_tensors, ct_h, ct_c)


class _DirectGRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, h0):
        hs, gates = gk._gru_forward(x, w, h0, with_gates=True)
        ctx.save_for_backward(w, h0, hs, gates)
        ctx.set_materialize_grads(False)
        return hs

    @staticmethod
    def backward(ctx, ct_h):
        w, h0, hs, gates = ctx.saved_tensors
        dx, dw, dh0 = gk._gru_backward(w, h0, hs, gates, ct_h)
        return dx, dw, dh0


def _grads(fn, inputs):
    leaves = [v.clone().requires_grad_(True) for v in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
    loss.backward()
    return [o.detach() for o in outs] + [v.grad for v in leaves]


def test_training_through_the_operators_is_the_direct_path():
    inputs = _lstm_inputs(2)
    for a, b in zip(_grads(lk.lstm_scan, inputs),
                    _grads(_DirectLSTM.apply, inputs)):
        assert torch.equal(a, b)
    inputs = _gru_inputs(3)
    for a, b in zip(_grads(gk.gru_scan, inputs),
                    _grads(_DirectGRU.apply, inputs)):
        assert torch.equal(a, b)
    with torch.no_grad():
        x, w, pw = _lstm_inputs(4)
        hs, cs = lk.lstm_scan(x, w, pw)
        want = lk._lstm_forward(x, w, pw, with_gates=False)
        assert torch.equal(hs, want[0]) and torch.equal(cs, want[1])

"""The ``lstm`` and ``gru`` ops' route (paddle_tpu_torch/ops/rnn.py) by the
hidden widths the Hopper kernels take, against the reference, on the CPU.

- ``max_hidden`` and ``kernel_takes`` of ops/kernels/lstm.py and gru.py:
  the kernels' shared-memory caps (``chip_smoke.py`` holds them against
  the built libraries), and any width up to them once padded to a
  multiple of 4.
- ``lstm_scan`` / ``gru_scan`` at widths that are not multiples of 4 run
  the kernels' functions padded with zero units: outputs and gradients
  match the plain versions at the unpadded width.
- The ops at the widths the kernels take (H = 6, 30, 128, 256, 512) run
  the kernel path (plain versions on the CPU), and past the caps the
  eager scan: the kernel modules' ``lstm_scan`` / ``gru_scan`` are
  watched for the call.  Either way the outputs and the gradients of
  Input, Weight and Bias match the reference's op, whose CPU executor
  takes its own scan.
- Training parity at H = 30, with the harness of tests/test_torch_rnn.py:
  ``rnn_lm.build(hidden_dim=30)`` and ``dynamic_lstm_net(lstm_size=30)``
  take 3 Adagrad steps from the reference's state, through the kernel
  path.

Tolerances, float32 on both sides with other summation orders: op outputs
1e-5 absolute (O(1) values; the weights are scaled by 1 / sqrt(H) so the
gates stay O(1) at every width); gradients 1e-4 absolute (sums over T * B
terms); training as tests/test_torch_rnn.py: loss 1e-5, gradients 1e-6,
state after 3 steps 1e-3 (Adagrad's first step carries a last-bit gap of
a gradient near 1e-6 into a visible fraction of lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.models import rnn_lm as jrnn
from paddle_tpu.models import sentiment as jsent

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import rnn_lm as trnn
from paddle_tpu_torch.models import sentiment as tsent
from paddle_tpu_torch.ops import rnn as trnn_ops
from paddle_tpu_torch.ops.kernels import gru as tg
from paddle_tpu_torch.ops.kernels import lstm as tl

TOL_OUT = 1e-5
TOL_GRAD = 1e-4
TOL_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-6
TOL_STATE = 1e-3
V = 50


def test_kernel_takes_restates_the_kernels_caps():
    # csrc/lstm_fwd.cu: kMaxSmem / (rows * 6 * 4); lstm_bwd.cu:
    # kMaxSmem / ((rows * 6 + 3) * 4); kMaxSmem = 232448, rows = 8 only
    assert {n: tl.max_hidden(n) for n in ('lstm_fwd', 'lstm_bwd')} == \
        {'lstm_fwd': 1210, 'lstm_bwd': 1139}
    assert tl.max_hidden('lstm_fwd', 16) == 0
    # csrc/gru_fwd.cu: kMaxSmem / (rows * 3 * 4); gru_bwd.cu: rows * 4 * 4
    assert {(n, r): tg.max_hidden(n, r) for n in ('gru_fwd', 'gru_bwd')
            for r in (8, 16)} == {
        ('gru_fwd', 8): 2421, ('gru_fwd', 16): 1210,
        ('gru_bwd', 8): 1816, ('gru_bwd', 16): 908}
    assert tg.max_hidden('gru_bwd', 12) == 0
    assert tg.max_hidden('gru_fwd') == tg.max_hidden('gru_fwd', 8)


@pytest.mark.parametrize('takes,h', [
    (tl.kernel_takes, {1: True, 3: True, 4: True, 30: True, 256: True,
                       1136: True, 1137: False, 1138: False, 1140: False,
                       1208: False}),
    (tg.kernel_takes, {1: True, 4: True, 30: True, 512: True, 1813: True,
                       1816: True, 1817: False, 1820: False, 2420: False}),
], ids=['lstm', 'gru'])
def test_kernel_takes_at_the_edges(takes, h):
    assert {w: takes(w) for w in h} == h
    assert not takes(0)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


SCAN_CASES = [(op, H) for op in ('lstm', 'gru') for H in (1, 6, 30)]


@pytest.mark.parametrize('op,H', SCAN_CASES,
                         ids=['%s_H%d' % c for c in SCAN_CASES])
def test_scan_pads_a_width_that_is_not_a_multiple_of_4(monkeypatch, op, H):
    """lstm_scan / gru_scan hand the kernels' wrappers H padded to a
    multiple of 4 and match the plain versions at H: hs (and cs), and the
    gradients of x, w and pw (h0)."""
    mod, fwd = (tl, '_lstm_forward') if op == 'lstm' else \
        (tg, '_gru_forward')
    widths = []
    real = getattr(mod, fwd)

    def watched(x, *args, **kwargs):
        widths.append(x.shape[-1] // (4 if op == 'lstm' else 3))
        return real(x, *args, **kwargs)
    monkeypatch.setattr(mod, fwd, watched)
    rng = np.random.default_rng(H)
    T, B = 5, 3
    g = 4 if op == 'lstm' else 3
    ins = [torch.tensor(v, requires_grad=True) for v in (
        _rand(rng, (T, B, g * H)), _rand(rng, (H, g * H), H ** -0.5),
        _rand(rng, (3, H), 0.3) if op == 'lstm' else
        _rand(rng, (B, H), 0.5))]
    cts = [torch.tensor(_rand(rng, (T, B, H))) for _ in range(2)]
    if op == 'lstm':
        got = tl.lstm_scan(*ins)
        want = tl._plain_lstm_forward(*ins)[:2]
    else:
        got = (tg.gru_scan(*ins),)
        want = tg._plain_gru_forward(*ins)[:1]
    assert widths == [tl.padded_width(H)] and widths[0] % 4 == 0
    outs = []
    for res in (got, want):
        loss = sum((r * c).sum() for r, c in zip(res, cts))
        outs.append(([r.detach().numpy() for r in res],
                     [d.numpy() for d in torch.autograd.grad(loss, ins)]))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert a.shape == b.shape == (T, B, H)
        assert np.abs(a - b).max() <= TOL_OUT
    for a, b in zip(outs[0][1], outs[1][1]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL_GRAD


def _op_inputs(rng, op, B, T, H):
    g = 4 if op == 'lstm' else 3
    ins = {'Input': _rand(rng, (B, T, g * H)),
           'Weight': _rand(rng, (H, g * H), H ** -0.5),
           'Bias': _rand(rng, (1, g * H), 0.3),
           'XLen': np.asarray([T, max(1, T - 1)][:B], np.int32)}
    return ins


def _ref_op(op, ins, attrs, ct):
    """The reference op's Hidden and d(sum(Hidden * ct)) with respect to
    Input, Weight and Bias by jax.grad."""
    impl = jget_op(op)
    wrt = ('Input', 'Weight', 'Bias')

    class _Ctx(object):
        pass

    def run(*vals):
        staged = {k: [jnp.asarray(v)] for k, v in ins.items()}
        for k, v in zip(wrt, vals):
            staged[k] = [v]
        return impl.compute(_Ctx(), staged, dict(attrs))['Hidden'][0]

    vals = [jnp.asarray(ins[k]) for k in wrt]
    grads = jax.grad(lambda *v: jnp.sum(run(*v) * ct),
                     argnums=(0, 1, 2))(*vals)
    return np.asarray(run(*vals)), [np.asarray(g) for g in grads]


def _port_op(op, ins, attrs, ct):
    wrt = ('Input', 'Weight', 'Bias')
    staged = {k: [torch.tensor(v, requires_grad=k in wrt)]
              for k, v in ins.items()}
    hid = tget_op(op).compute(None, staged, dict(attrs))['Hidden'][0]
    grads = torch.autograd.grad((hid * torch.tensor(ct)).sum(),
                                [staged[k][0] for k in wrt])
    return hid.detach().numpy(), [g.numpy() for g in grads]


ROUTE_CASES = [
    # op, H, whether the kernel path runs
    ('lstm', 30, True), ('lstm', 6, True), ('lstm', 1140, False),
    ('lstm', 128, True), ('lstm', 256, True), ('lstm', 512, True),
    ('gru', 30, True), ('gru', 1820, False), ('gru', 128, True),
    ('gru', 256, True), ('gru', 512, True),
]


@pytest.mark.parametrize('op,H,kernel', ROUTE_CASES,
                         ids=['%s_H%d' % c[:2] for c in ROUTE_CASES])
def test_op_routes_by_the_width_the_kernels_take(monkeypatch, op, H, kernel):
    mod, fn = (tl, 'lstm_scan') if op == 'lstm' else (tg, 'gru_scan')
    calls = []
    real = getattr(mod, fn)

    def watched(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(mod, fn, watched)
    rng = np.random.default_rng(H)
    B, T = 2, 3
    ins = _op_inputs(rng, op, B, T, H)
    ct = _rand(rng, (B, T, H))
    attrs = {'use_pallas': True}
    if op == 'lstm':
        attrs['use_peepholes'] = False
    got = _port_op(op, ins, attrs, ct)
    assert len(calls) == (1 if kernel else 0)
    path = (trnn_ops._kernel_path(attrs, None, None, H) if op == 'lstm'
            else trnn_ops._gru_kernel_path(attrs, H))
    assert path is kernel
    want = _ref_op(op, ins, attrs, ct)
    assert np.abs(got[0] - want[0]).max() <= TOL_OUT
    for a, b, slot in zip(got[1], want[1], ('Input', 'Weight', 'Bias')):
        assert np.abs(a - b).max() <= TOL_GRAD, slot


def _lm(pkg):
    mod = jrnn if pkg is fluid else trnn
    return (mod.build(V, emb_dim=8, hidden_dim=30, num_layers=2)[2],)


def _dynamic_sentiment(pkg):
    mod = jsent if pkg is fluid else tsent
    data = pkg.layers.data(name='words', shape=[1], dtype='int64',
                           lod_level=1)
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    return mod.dynamic_lstm_net(data, label, V, emb_dim=8,
                                lstm_size=30)[:2]


def _build(pkg, model):
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.program_guard(main, startup):
            fetch = model(pkg)
            pkg.optimizer.AdagradOptimizer(0.1).minimize(fetch[0])
    return main, startup, fetch


def _lm_batches(rng, B=4, T=8):
    for _ in range(3):
        ln = rng.integers(1, T + 1, B)
        ln[0] = T
        src = rng.integers(1, V, (B, T, 1)).astype(np.int64)
        tgt = rng.integers(1, V, (B, T, 1)).astype(np.int64)
        yield {'src': (src, ln), 'target': (tgt, ln)}


def _sentiment_batches(rng, B=4, T=8):
    for _ in range(3):
        ln = rng.integers(1, T + 1, B)
        ln[0] = T
        words = rng.integers(1, V, (B, T, 1)).astype(np.int64)
        yield {'words': (words, ln),
               'label': rng.integers(0, 2, (B, 1)).astype(np.int64)}


@pytest.mark.parametrize('model,batches', [
    (_lm, _lm_batches), (_dynamic_sentiment, _sentiment_batches)],
    ids=['rnn_lm_H30', 'sentiment_dynamic_lstm_H30'])
def test_adagrad_steps_at_h30_match_the_reference(monkeypatch, model,
                                                  batches):
    calls = []
    real = tl.lstm_scan

    def watched(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)
    monkeypatch.setattr(tl, 'lstm_scan', watched)
    jmain, jstartup, jfetch = _build(fluid, model)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tmain = tfl.Program.from_dict(jmain.to_dict())
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    params = [p.name for p in jmain.all_parameters()]
    fetch = [v.name for v in jfetch] + [p + '@GRAD' for p in params]
    nf = len(jfetch)
    for feed in batches(np.random.default_rng(2)):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        assert np.isfinite(got[0]).all()
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL_LOSS
        if nf > 1:   # the sentiment net's accuracy
            assert float(got[1][0]) == float(want[1][0])
        for name, a, b in zip(params, got[nf:], want[nf:]):
            assert np.abs(a - np.asarray(b)).max() <= TOL_TRAIN_GRAD, name
    for name in persist:   # parameters, moments, the learning rate
        a, b = tscope.get_numpy(name), np.asarray(jscope.get(name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL_STATE, name
    lstm = [op for op in tmain.global_block().ops if op.type == 'lstm']
    assert lstm and all(op.attrs['use_pallas'] for op in lstm)
    # every lstm op took the kernel path, in every step
    assert calls == [30] * (3 * len(lstm))
    assert all(tfl_w.shape[0] == 30 for tfl_w in (
        tscope.get_numpy(op.input('Weight')[0]) for op in lstm))

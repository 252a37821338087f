"""The port's ragged (LoD) machinery and its LSTM models against the
reference, on the CPU.

- ``LoDTensor`` / ``create_lod_tensor`` give the reference's padded arrays
  and lengths; the executor feeds a ``(data, lengths)`` tuple or a
  ``LoDTensor`` as ``name`` and ``name@LEN`` (int32), narrowing int64 ids
  to int32 as the reference does.
- ``sequence_pool`` for every pool type (and the first / last step ops),
  ``mean`` over a ragged input, ``sum``, ``softmax``, ``top_k``,
  ``cross_entropy``, ``accuracy``, ``assign`` and ``concat`` against the
  reference's ops on the same inputs.
- Program parity: the port's ``rnn_lm.build`` (both loss forms) and
  ``sentiment.build`` (stacked and dynamic LSTM) + ``AdagradOptimizer``
  serialise to exactly the reference's programs, startup included.
- Training parity, with the harness of tests/test_torch_train.py: the
  reference builds and initialises, the port loads ``to_dict`` and every
  persistable, both run 3 Adagrad steps (lr 0.1) on the same seeded ragged
  batches.  The reference's CPU executor takes its scan path and the port
  its kernel path (plain versions on the CPU), so this also holds the two
  paths against each other at the program level.

Tolerances.  Ops: 1e-6 absolute (float32, O(1) values).  Training: loss
1e-5 absolute (O(1) losses); each fetched gradient 1e-6 absolute (the
measured gap was 8e-8); moments and parameters after 3 steps 1e-3
absolute: Adagrad's first step is lr * g / (|g| + 1e-6), so where a
gradient lies near 1e-6 a last-bit difference in g moves the step by a
visible fraction of lr = 0.1 (the measured gap was 2.8e-4, on a sentiment
fc weight; the LM's was 6e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import lod as jlod
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.models import rnn_lm as jrnn
from paddle_tpu.models import sentiment as jsent

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.inference import BatchingInferenceServer
from paddle_tpu_torch.models import rnn_lm as trnn
from paddle_tpu_torch.models import sentiment as tsent
from paddle_tpu_torch.ops.kernels import lstm as tl

TOL_OP = 1e-6
TOL_LOSS = 1e-5
TOL_GRAD = 1e-6
TOL_STATE = 1e-3
V = 50


@pytest.mark.parametrize('data,lens', [
    ([[1, 2, 3], [4], [5, 6]], None),
    (np.arange(12).reshape(6, 2), [[2, 1, 3]]),
    ([[1, 2], [3, 4]], [[2, 2]]),
    (np.ones((3, 4)), None),
])
def test_lod_tensor_matches_the_reference(data, lens):
    j = jlod.create_lod_tensor(data, lens)
    t = tlod.create_lod_tensor(data, lens)
    assert np.array_equal(np.asarray(t), np.asarray(j))
    assert t.is_ragged() == j.is_ragged()
    assert t.lengths() == j.lengths()
    assert t.lod() == j.lod()
    assert np.array_equal(t.flat(), j.flat())


def test_executor_feeds_ragged_data_with_its_lengths():
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[1], dtype='int64', lod_level=1)
        e = tfl.layers.embedding(input=x, size=[10, 3])
        y = tfl.layers.sequence_pool(input=e, pool_type='sum')
    assert x.shape == (-1, -1) and main.global_block().has_var('x@LEN')
    exe = tfl.Executor(tfl.CPUPlace())
    scope = scope_from_numpy({'embedding_0.w_0': np.eye(10, 3,
                                                        dtype=np.float32)},
                             'cpu')
    ids = np.array([[1, 2, 0], [0, 1, 2]], np.int64)[..., None]
    feeds = [{'x': (ids, [2, 3])},
             {'x': tfl.create_lod_tensor([[1, 2], [0, 1, 2]], None)}]
    for feed in feeds:
        ln, emb_len, out = exe.run(
            main, feed=feed, fetch_list=['x@LEN', 'embedding_0.tmp_0@LEN', y],
            scope=scope)
        assert ln.dtype == np.int32 and ln.tolist() == [2, 3]
        assert emb_len.tolist() == [2, 3]   # the @LEN companion's assign
        assert np.array_equal(out, [[0, 1, 1], [1, 1, 1]])


def _both(op, ins, attrs):
    want = jget_op(op).compute(
        None, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    got = tget_op(op).compute(
        None, {k: [torch.tensor(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    return got, want


def _close(got, want, slots):
    for slot in slots:
        a = got[slot][0].numpy()
        b = np.asarray(want[slot][0])
        assert a.shape == b.shape and a.dtype == b.dtype, slot
        assert np.abs(a.astype(np.float64) - b).max() <= TOL_OP, slot


@pytest.mark.parametrize('op,pooltype', [
    ('sequence_pool', p) for p in
    ('SUM', 'AVERAGE', 'SQRT', 'MAX', 'LAST', 'FIRST')] +
    [('sequence_first_step', None), ('sequence_last_step', None)])
@pytest.mark.parametrize('with_len', [True, False])
def test_sequence_pool_matches_the_reference(op, pooltype, with_len):
    rng = np.random.default_rng(1)
    ins = {'X': [rng.standard_normal((4, 6, 3)).astype(np.float32)]}
    if with_len:
        ins['XLen'] = [np.array([6, 1, 4, 2], np.int32)]
    attrs = {'pooltype': pooltype} if pooltype else {}
    _close(*_both(op, ins, attrs), ['Out'])


def test_math_loss_and_metric_ops_match_the_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 5, 3)).astype(np.float32)
    probs = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    label = rng.integers(0, 5, (6, 1)).astype(np.int32)
    cases = [
        ('mean', {'X': [x], 'XLen': [np.array([5, 2, 3, 1], np.int32)]},
         {}, ['Out']),
        ('mean', {'X': [x]}, {}, ['Out']),
        ('sum', {'X': [x, 2 * x, x[:1]]}, {}, ['Out']),
        ('softmax', {'X': [x]}, {}, ['Out']),
        ('top_k', {'X': [probs]}, {'k': 2}, ['Out', 'Indices']),
        ('cross_entropy', {'X': [probs], 'Label': [label]}, {}, ['Y']),
        ('cross_entropy', {'X': [probs], 'Label': [probs[::-1].copy()]},
         {'soft_label': True}, ['Y']),
        ('assign', {'X': [x]}, {}, ['Out']),
        ('concat', {'X': [x, x[:, :2]]}, {'axis': 1}, ['Out']),
    ]
    for op, ins, attrs, slots in cases:
        _close(*_both(op, ins, attrs), slots)
    top = tget_op('top_k').compute(None, {'X': [torch.tensor(probs)]},
                                   {'k': 2})['Indices'][0]
    got, want = _both('accuracy', {'Indices': [top.numpy()],
                                   'Label': [label]}, {})
    _close(got, want, ['Accuracy', 'Correct', 'Total'])


LM = dict(vocab_size=V, emb_dim=8, hidden_dim=8, num_layers=2)
SENT = dict(emb_dim=8, hid_dim=16, stacked_num=3)


def _lm(pkg, fuse=True):
    mod = jrnn if pkg is fluid else trnn
    return (mod.build(fuse_vocab_loss=fuse, **LM)[2],)


def _sentiment(pkg, net):
    mod = jsent if pkg is fluid else tsent
    return mod.build(V, net=net)[2:4]


def _small_sentiment(pkg):
    """stacked_lstm_net at narrow widths (emb 8, hid 16 = 4H, H = 4)."""
    mod = jsent if pkg is fluid else tsent
    data = pkg.layers.data(name='words', shape=[1], dtype='int64',
                           lod_level=1)
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    return mod.stacked_lstm_net(data, label, V, **SENT)[:2]


def _build(pkg, model):
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.program_guard(main, startup):
            fetch = model(pkg)
            pkg.optimizer.AdagradOptimizer(0.1).minimize(fetch[0])
    return main, startup, fetch


PROGRAMS = {
    'rnn_lm': _lm,
    'rnn_lm_unfused': lambda pkg: _lm(pkg, fuse=False),
    'sentiment_stacked_lstm': lambda pkg: _sentiment(pkg, 'stacked_lstm'),
    'sentiment_dynamic_lstm': lambda pkg: _sentiment(pkg, 'dynamic_lstm'),
}


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_port_build_serialises_to_the_reference_program(name):
    jm, js, _ = _build(fluid, PROGRAMS[name])
    tm, ts, _ = _build(tfl, PROGRAMS[name])
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def test_lm_program_has_the_ops_the_slice_ports():
    tm, _, _ = _build(tfl, _lm)
    types = [op.type for op in tm.global_block().ops]
    assert types.count('lstm') == 2 and types.count('assign') == 9
    assert types.count('adagrad') == 11
    lstm = [op for op in tm.global_block().ops if op.type == 'lstm']
    assert all(op.attrs['use_pallas'] and op.input('XLen') for op in lstm)


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


@pytest.mark.parametrize('model,batches,n_lstm', [
    (_lm, _lm_batches, 2), (_small_sentiment, _sentiment_batches, 3)],
    ids=['rnn_lm', 'sentiment_stacked_lstm'])
def test_adagrad_steps_match_the_reference(model, batches, n_lstm):
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
    losses = []
    for feed in batches(np.random.default_rng(1)):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        assert np.isfinite(got[0]).all()
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL_LOSS
        if nf > 1:   # the sentiment net's accuracy
            assert float(got[1][0]) == float(want[1][0])
        for name, a, b in zip(params, got[nf:], want[nf:]):
            assert np.abs(a - np.asarray(b)).max() <= TOL_GRAD, name
        losses.append(float(got[0][0]))
    for name in persist:   # parameters, moments, the learning rate
        a, b = tscope.get_numpy(name), np.asarray(jscope.get(name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL_STATE, name
    moments = [n for n in persist if n.endswith('_moment_0')]
    assert len(moments) == len(params)
    assert all(tscope.get_numpy(n).max() > 0 for n in moments)
    # the CPU run took the kernel path's plain versions: no launch
    assert tl.launches == tl.bwd_launches == 0
    assert sum(op.type == 'lstm' for op in tmain.global_block().ops) == \
        n_lstm


@pytest.mark.parametrize('build,match', [
    # Executor.compile and the composed attention came with the serving
    # slice; the AOT cache of compiled executables waits
    (lambda: BatchingInferenceServer({1: 'unused.pt2'}, aot_cache='dir'),
     'compile'),
    # seq2seq.decode came with the control-flow slice; ParallelDo waits
    (lambda: tfl.layers.ParallelDo(), 'ParallelDo'),
])
def test_what_the_slice_does_not_bring_raises(build, match):
    with tfl.program_guard(tfl.Program(), tfl.Program()):
        with pytest.raises(NotImplementedError, match=match):
            build()

"""The port's seq2seq attention translator (paddle_tpu_torch/models/seq2seq.py)
and the ops it brings, against the reference, on the CPU.

- ``matmul``, ``sequence_softmax``, ``tanh`` and ``softmax_with_cross_entropy``
  against the reference's ops on the same inputs.
- The synthetic WMT14 task (paddle_tpu_torch/datasets/wmt14.py) against the
  reference's generator lines it copies.
- Program parity: the port's ``seq2seq.build`` + ``AdamOptimizer`` serialise
  to exactly the reference's programs, startup included, with the fused
  vocab loss and without it.
- Training parity, with the harness of tests/test_torch_rnn.py: the
  reference builds and initialises, the port loads ``to_dict`` and every
  persistable, both run 3 Adam steps (lr 1e-3) of a small translator (dict
  50, word_dim 8, hidden 8) on seeded ragged batches of the synthetic task,
  sources and targets of different lengths, with identical padded ids (lazy
  Adam moves every touched row, padding ids included).  The reference's
  CPU executor takes the GRU scan path and the XLA scatter branch; the port
  takes its kernel paths (plain versions on the CPU), so this also holds
  the paths against each other at the program level.
- Dead ops: a run that fetches only the loss skips the ``prediction``
  branch; fetching ``prediction`` computes it, as the reference's; the
  transformer, LM and sentiment programs run every op under the fetches
  their training runs use.

Tolerances.  Ops: 1e-6 absolute (float32, O(1) values).  Training: loss
1e-5 absolute; each fetched gradient, dense or densified sparse, 1e-6
absolute (the measured gap was 1.2e-7); moments and parameters after 3
steps 1e-4 absolute: Adam's first steps move a parameter by about lr *
g / (|g| + 1e-8), and mt_enc_proj_b's gradient is zero but for rounding
(softmax over the source steps ignores a bias added to every score), so
its steps are ratios of rounding noise near 1e-10 (the measured gap was
4.1e-6 there, 1e-6 or less elsewhere).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.datasets import common as jcommon
from paddle_tpu.datasets import wmt14 as jwmt14
from paddle_tpu.models import seq2seq as js2s

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.executor import live_ops
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.datasets import wmt14
from paddle_tpu_torch.models import rnn_lm as trnn
from paddle_tpu_torch.models import seq2seq as ts2s
from paddle_tpu_torch.models import sentiment as tsent
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.kernels import gru as tg
from paddle_tpu_torch.ops.kernels import table_update as ttu

TOL_OP = 1e-6
TOL_LOSS = 1e-5
TOL_GRAD = 1e-6
TOL_STATE = 1e-4
V = 50
CFG = dict(dict_size=V, word_dim=8, hidden_dim=8)
SPARSE = ('mt_src_emb', 'mt_trg_emb')


def _both(op, ins, attrs):
    want = jget_op(op).compute(
        None, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    got = tget_op(op).compute(
        None, {k: [torch.tensor(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    return got, want


@pytest.mark.parametrize('op,ins,attrs,slots', [
    ('matmul', {'X': [(4, 3, 5)], 'Y': [(4, 6, 5)]}, {'transpose_Y': True},
     ['Out']),
    ('matmul', {'X': [(4, 5, 3)], 'Y': [(4, 5, 6)]},
     {'transpose_X': True, 'alpha': 0.5}, ['Out']),
    ('matmul', {'X': [(3, 5)], 'Y': [(5, 2)]}, {}, ['Out']),
    ('sequence_softmax', {'X': [(4, 3, 6)], 'XLen': 'lens'}, {'axis': 2},
     ['Out']),
    ('sequence_softmax', {'X': [(4, 6)], 'XLen': 'lens'}, {}, ['Out']),
    ('sequence_softmax', {'X': [(4, 6, 1)], 'XLen': 'lens'}, {}, ['Out']),
    ('sequence_softmax', {'X': [(4, 6)]}, {}, ['Out']),
    ('tanh', {'X': [(4, 6)]}, {}, ['Out']),
    ('softmax_with_cross_entropy', {'Logits': [(4, 3, 7)],
                                    'Label': 'labels'}, {},
     ['Loss', 'Softmax']),
    ('softmax_with_cross_entropy', {'Logits': [(5, 7)], 'Label': 'soft'},
     {'soft_label': True}, ['Loss', 'Softmax']),
])
def test_ops_match_the_reference(op, ins, attrs, slots):
    rng = np.random.default_rng(len(op) + len(ins))
    made = {}
    for slot, spec in ins.items():
        if spec == 'lens':
            made[slot] = [np.array([6, 1, 4, 2], np.int32)]
        elif spec == 'labels':
            made[slot] = [rng.integers(0, 7, (4, 3, 1)).astype(np.int32)]
        elif spec == 'soft':
            made[slot] = [rng.dirichlet(np.ones(7), 5).astype(np.float32)]
        else:
            made[slot] = [rng.standard_normal(s).astype(np.float32)
                          for s in spec]
    got, want = _both(op, made, attrs)
    for slot in slots:
        a, b = got[slot][0].numpy(), np.asarray(want[slot][0])
        assert a.shape == b.shape and a.dtype == b.dtype, slot
        assert np.abs(a - b).max() <= TOL_OP, slot


def test_synthetic_wmt14_matches_the_reference_generator():
    src = [3, 9, 29999, 17, 5]
    assert wmt14.translate(src, 30000) == jwmt14._translate(src, 30000)
    a = wmt14.zipf_seq(np.random.default_rng(4), 500, 29997)
    b = jcommon.zipf_seq(np.random.default_rng(4), 500, 29997)
    assert np.array_equal(a, b)
    feed = wmt14.batch(np.random.default_rng(5), V, [4, 2, 7], None)
    (src, sl), (trg, tl), (lab, ll) = (
        feed[k] for k in ('src_word_id', 'target_language_word',
                          'target_language_next_word'))
    assert sl.tolist() == [4, 2, 7] and tl.tolist() == ll.tolist() == \
        [5, 3, 8]
    for b in range(3):   # the reference reader's (src, trg, trg_next)
        s = src[b, :sl[b], 0].tolist()
        y = jwmt14._translate(s, V) + [jwmt14.END_ID]
        assert lab[b, :ll[b], 0].tolist() == y
        assert trg[b, :tl[b], 0].tolist() == [jwmt14.START_ID] + y[:-1]
    cut = wmt14.batch(np.random.default_rng(5), V, [6, 6], 6)
    assert cut['target_language_word'][1].tolist() == [6, 6]


def _build(pkg, prog_mod, mod, fuse=True):
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.program_guard(main, startup):
            out = mod.build(fuse_vocab_loss=fuse, **CFG)
            pkg.optimizer.AdamOptimizer(1e-3).minimize(out[-1])
    return main, startup, out


@pytest.mark.parametrize('fuse', [True, False])
def test_port_build_serialises_to_the_reference_program(fuse):
    jm, js, _ = _build(fluid, jprog, js2s, fuse)
    tm, ts, _ = _build(tfl, tprog, ts2s, fuse)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    types = [op.type for op in tm.global_block().ops]
    assert types.count('gru') == 3 and types.count('adam') == 22
    assert types.count('sparse_grad_assemble') == 2
    gru = [op for op in tm.global_block().ops if op.type == 'gru']
    assert all(op.attrs['use_pallas'] for op in gru)
    assert [op.attrs['is_reverse'] for op in gru] == [False, True, False]
    assert [bool(op.input('H0')) for op in gru] == [False, False, True]


def _reference_run(fuse=True):
    jmain, jstartup, jout = _build(fluid, jprog, js2s, fuse)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tmain = tfl.Program.from_dict(jmain.to_dict())
    tscope = scope_from_numpy(persist, 'cpu')
    return (jmain, jexe, jscope, jout), (tmain, tfl.Executor(tfl.CPUPlace()),
                                         tscope), persist


def _dense(a):
    if a.dtype == object:   # a SelectedRows fetch
        return np.asarray(a.item().to_dense())
    return np.asarray(a)


def test_adam_steps_match_the_reference():
    (jmain, jexe, jscope, jout), (tmain, texe, tscope), persist = \
        _reference_run()
    params = [p.name for p in jmain.all_parameters()]
    fetch = [jout[-1].name] + [p + '@GRAD' for p in params]
    rng = np.random.default_rng(1)
    losses = []
    for step in range(3):
        feed = wmt14.batch(rng, V, rng.integers(2, 8, 4))
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        assert np.isfinite(got[0]).all()
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL_LOSS
        for name, a, b in zip(params, got[1:], want[1:]):
            assert (a.dtype == object) == (name in SPARSE), name
            assert np.abs(_dense(a) - _dense(b)).max() <= TOL_GRAD, name
        losses.append(float(got[0][0]))
    for name in persist:   # parameters, both moments, beta pows, lr
        a, b = tscope.get_numpy(name), np.asarray(jscope.get(name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL_STATE, name
    moments = [n for n in persist if '_moment' in n]
    assert len(moments) == 2 * len(params)
    # the CPU run took the kernel paths' plain versions: no launch
    assert tg.launches == tg.bwd_launches == ttu.launches == 0


def test_dead_prediction_branch_is_skipped_unless_fetched():
    (jmain, jexe, jscope, jout), (tmain, texe, tscope), _ = _reference_run()
    prediction, cost = jout[3].name, jout[4].name
    feed = wmt14.batch(np.random.default_rng(2), V, [5, 3, 6])
    texe.run(tmain, feed=feed, fetch_list=[cost], scope=tscope)
    skipped = [t for _, t in texe.skipped_ops]
    assert {'mul', 'elementwise_add', 'softmax'} <= set(skipped)
    assert set(skipped) <= {'mul', 'elementwise_add', 'softmax', 'assign'}
    # the state moved on one step in the port: fetch from fresh copies
    (jmain, jexe, jscope, jout), (tmain, texe, tscope), _ = _reference_run()
    got = texe.run(tmain, feed=feed, fetch_list=[prediction, cost],
                   scope=tscope)
    want = jexe.run(jmain, feed=feed, fetch_list=[prediction, cost],
                    scope=jscope)
    assert 'softmax' not in [t for _, t in texe.skipped_ops]
    assert got[0].shape == (3, 7, V)
    assert np.abs(got[0] - np.asarray(want[0])).max() <= TOL_OP
    assert abs(float(got[1][0]) - float(want[1][0])) <= TOL_LOSS


def _trained(build, opt):
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        fetch = build()
        opt().minimize(fetch[0])
    return main, fetch


def _sentiment_fetch():
    data = tfl.layers.data(name='words', shape=[1], dtype='int64',
                           lod_level=1)
    label = tfl.layers.data(name='label', shape=[1], dtype='int64')
    return tsent.stacked_lstm_net(data, label, V, emb_dim=8, hid_dim=16,
                                  stacked_num=3)[:2]


@pytest.mark.parametrize('build,opt', [
    (lambda: ttr.build(vocab_size=64, seq_len=16, n_layers=2, d_model=16,
                       n_heads=2)[2:],
     lambda: tfl.optimizer.AdamOptimizer(1e-3)),
    (lambda: trnn.build(V, emb_dim=8, hidden_dim=8)[2:],
     lambda: tfl.AdagradOptimizer(0.1)),
    (_sentiment_fetch, lambda: tfl.AdagradOptimizer(0.1)),
], ids=['transformer', 'rnn_lm', 'sentiment'])
def test_earlier_training_programs_run_every_op(build, opt):
    """Under the fetches their training runs use, every op of these
    programs runs but the ``assign`` ops that copy a ``@LEN`` companion no
    running op reads (an LSTM's unused cell lengths, and the copies made
    from them)."""
    main, fetch = _trained(build, opt)
    block = main.global_block()
    live = set(live_ops(block, [v.name for v in fetch]))
    read = {n for i in live for n in block.ops[i].input_arg_names}
    for i, op in enumerate(block.ops):
        if i not in live:
            out, = op.output_arg_names
            assert op.type == 'assign' and out.endswith('@LEN') and \
                out not in read, (i, op.type)
    assert sum(op.type != 'assign' for op in block.ops) == \
        sum(block.ops[i].type != 'assign' for i in live)


def test_what_the_slice_does_not_bring_raises():
    """Generation (``decode``) came with the control-flow slice and builds
    the reference's While program (tests/test_torch_beam_search.py holds
    it to the reference); what is still to come raises, naming its
    ROADMAP item: ParallelDo (item 10).  A second autodiff op (item 6)
    runs since the GAN's slice: the fetched gradient is the last one's."""
    types = []
    for pkg, pm, mod in ((fluid, jprog, js2s), (tfl, tprog, ts2s)):
        with pm.reset_unique_name_guard():
            main = pkg.Program()
            with pkg.program_guard(main, pkg.Program()):
                src = pkg.layers.data(name='src_word_id', shape=[1],
                                      dtype='int64', lod_level=1)
                mod.decode(src, V)
            types.append(sorted(op.type for b in main.blocks
                                for op in b.ops))
    assert types[0] == types[1] and {'while', 'beam_search'} <= set(types[1])
    with tfl.program_guard(tfl.Program(), tfl.Program()):
        with pytest.raises(NotImplementedError, match='item 10'):
            tfl.layers.ParallelDo()
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[3], dtype='float32')
        w = tfl.layers.create_parameter([3, 1], 'float32')
        for _ in range(2):
            tfl.backward.calc_gradient(
                tfl.layers.mean(tfl.layers.mul(x, w)), [w])
    scope = tfl.Scope()
    tfl.Executor(tfl.CPUPlace()).run(startup, scope=scope)
    g, = tfl.Executor(tfl.CPUPlace()).run(
        main, feed={'x': np.ones((2, 3), 'float32')},
        fetch_list=[w.name + '@GRAD'], scope=scope)
    # d mean(x w) / dw = the rows' mean of x
    assert np.array_equal(g, np.ones((3, 1), np.float32))

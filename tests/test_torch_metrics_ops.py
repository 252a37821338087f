"""The metric ops and evaluators of the sequence-labelling slice against
the reference's, on the same seeded numpy inputs, on the CPU.

- ``chunk_eval`` (paddle_tpu_torch/ops/metrics.py) under the plain, IOB,
  IOE and IOBES schemes, with and without excluded chunk types, with
  ragged rows (a row of length 0), on random tags (every kind, type and
  outside tag) and on the synthetic CoNLL-2005 labels against a noisy
  copy of them: all six outputs, the counts exactly, the ratios bitwise.
  The tag convention is the reference's (kind = tag % n_tag, type = tag
  // n_tag), 'O' at 0 included.
- ``edit_distance``: normalised or not, ragged on both sides, empty rows,
  and through the layer with ``ignored_tokens`` (``sequence_erase`` on
  both inputs) and both executors; exact.
- ``precision_recall`` and ``positive_negative_pair``: every output;
  bitwise, but for ``precision_recall``'s macro means, within 1e-6 (a
  mean of per-class ratios, summed in another order by XLA).
- ``evaluator.Accuracy``, ``ChunkEvaluator`` (states reset and streamed
  across batches, through each package's executor) and ``StreamingAUC``
  (update, merge, reset) against the reference's classes: equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op_impl as jget_op

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.datasets import conll05
from torch_seqlab_cases import CHUNK_SCHEMES, EDIT_CASES, chunk_case
from torch_seqlab_cases import edit_case, pos_neg_case
from torch_seqlab_cases import precision_recall_case


def _ref(op, ins, attrs):
    return jget_op(op).compute(
        None, {k: [jnp.asarray(v[0])] for k, v in ins.items()}, dict(attrs))


def _port(op, ins, attrs):
    """64-bit ints narrowed to 32 bits, as both executors feed them."""
    return tget_op(op).compute(
        None, {k: [torch.tensor(v[0].astype(np.int32)
                                if v[0].dtype == np.int64 else v[0])]
               for k, v in ins.items()}, dict(attrs))


def _equal(got, want, tol=0.0):
    assert sorted(got) == sorted(want)
    for slot in want:
        a, b = got[slot][0].numpy(), np.asarray(want[slot][0])
        assert a.shape == b.shape and a.dtype == b.dtype, slot
        assert np.abs(a.astype(np.float64) - b).max() <= tol, (slot, a, b)


@pytest.mark.parametrize('scheme', list(CHUNK_SCHEMES))
@pytest.mark.parametrize('excluded', [None, [1], [0, 2]])
@pytest.mark.parametrize('seed', [0, 1])
def test_chunk_eval_matches_the_reference(scheme, excluded, seed):
    ins = chunk_case(scheme, 3, seed)
    attrs = {'chunk_scheme': scheme, 'num_chunk_types': 3,
             'excluded_chunk_types': excluded}
    got = _port('chunk_eval', ins, attrs)
    _equal(got, _ref('chunk_eval', ins, attrs))
    assert int(got['NumLabelChunks'][0][0]) > 0


def test_chunk_eval_on_the_srl_labels():
    """The SRL test split's labels (19 tags, 'O' at 0) against a noisy
    copy, IOB with 9 chunk types, as the SRL ChunkEvaluator runs it."""
    rows = [s[-1] for s in list(conll05.test()())[:32]]
    t = max(len(r) for r in rows)
    label = np.zeros((32, t, 1), np.int64)
    for i, r in enumerate(rows):
        label[i, :len(r), 0] = r
    rng = np.random.default_rng(4)
    inference = np.where(rng.random(label.shape) < 0.2,
                         rng.integers(0, 19, label.shape), label)
    ins = {'Inference': [inference], 'Label': [label],
           'XLen': [np.asarray([len(r) for r in rows], np.int64)]}
    attrs = {'chunk_scheme': 'IOB', 'num_chunk_types': 9,
             'excluded_chunk_types': []}
    _equal(_port('chunk_eval', ins, attrs), _ref('chunk_eval', ins, attrs))


@pytest.mark.parametrize('case', list(EDIT_CASES))
@pytest.mark.parametrize('normalized', [True, False])
def test_edit_distance_matches_the_reference(case, normalized):
    ins = edit_case(case)
    attrs = {'normalized': normalized}
    _equal(_port('edit_distance', ins, attrs),
           _ref('edit_distance', ins, attrs))


def _edit_program(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        hyp = pkg.layers.data(name='hyp', shape=[], dtype='int64',
                              lod_level=1)
        ref = pkg.layers.data(name='ref', shape=[], dtype='int64',
                              lod_level=1)
        dist, num = pkg.layers.edit_distance(hyp, ref, normalized=False,
                                             ignored_tokens=[0, 9])
    return main, [dist, num]


def test_edit_distance_layer_with_ignored_tokens_matches_the_reference():
    feed = {'hyp': (np.asarray([[9, 1, 2, 3], [4, 0, 5, 0], [9, 9, 0, 0]],
                               np.int64), np.asarray([4, 3, 2])),
            'ref': (np.asarray([[1, 3, 3], [4, 5, 6], [9, 0, 0]], np.int64),
                    np.asarray([3, 3, 1]))}
    with jprog.reset_unique_name_guard():
        jmain, jf = _edit_program(fluid)
    with tprog.reset_unique_name_guard():
        tmain, tf = _edit_program(tfl)
    assert tmain.to_dict() == jmain.to_dict()
    want = fluid.Executor(fluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=jf, scope=fluid.Scope())
    got = tfl.Executor(tfl.CPUPlace()).run(
        tmain, feed=feed, fetch_list=tf, scope=tfl.Scope())
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(got[0]).ravel().tolist() == [1.0, 1.0, 0.0]


@pytest.mark.parametrize('classes', [3, 5])
def test_precision_recall_matches_the_reference(classes):
    ins, attrs = precision_recall_case(classes)   # one class never seen
    got = _port('precision_recall', ins, attrs)
    want = _ref('precision_recall', ins, attrs)
    _equal(got, want, tol=1e-6)
    # the micro figures and the counts: bitwise
    assert np.array_equal(got['BatchMetrics'][0].numpy()[:, 3:],
                          np.asarray(want['BatchMetrics'][0])[:, 3:])
    assert np.array_equal(got['AccumStatesInfo'][0].numpy(),
                          np.asarray(want['AccumStatesInfo'][0]))


def test_positive_negative_pair_matches_the_reference():
    ins = pos_neg_case()   # scores with ties
    got = _port('positive_negative_pair', ins, {})
    _equal(got, _ref('positive_negative_pair', ins, {}))
    assert float(got['NeutralPair'][0][0]) > 0


def _named(build, pkg):
    """``build(pkg)``'s main program as a dict, names counted from 0."""
    prog = tprog if pkg is tfl else jprog
    with prog.reset_unique_name_guard():
        return build(pkg)[0].to_dict()


def _accuracy_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        scores = pkg.layers.data(name='scores', shape=[4], dtype='float32')
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        acc = pkg.evaluator.Accuracy(input=scores, label=label)
    return main, startup, acc


def test_accuracy_evaluator_streams_as_the_reference():
    """tests/test_evaluator.py's batches through both packages."""
    s = np.eye(4, dtype=np.float32)
    batches = [np.asarray([[0], [1], [0], [1]], np.int64),
               np.asarray([[0], [1], [2], [3]], np.int64)]
    results = []
    for pkg in (fluid, tfl):
        main, startup, acc = _accuracy_program(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            acc.reset(exe)
            got = [float(np.ravel(exe.run(main, feed={'scores': s,
                                                      'label': lb},
                                          fetch_list=acc.metrics)[0])[0])
                   for lb in batches]
            got.append(float(acc.eval(exe)[0]))
            acc.reset(exe)
            exe.run(main, feed={'scores': s, 'label': batches[0]},
                    fetch_list=acc.metrics)
            got.append(float(acc.eval(exe)[0]))
        results.append(got)
    assert results[1] == results[0] == [0.5, 1.0, 0.75, 0.5]
    assert _named(_accuracy_program, tfl) == _named(_accuracy_program,
                                                    fluid)


def _chunk_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        inf = pkg.layers.data(name='inf', shape=[1], dtype='int64',
                              lod_level=1)
        lab = pkg.layers.data(name='lab', shape=[1], dtype='int64',
                              lod_level=1)
        ev = pkg.evaluator.ChunkEvaluator(inf, lab, 'IOB', 9)
    return main, startup, ev


def test_chunk_evaluator_streams_as_the_reference():
    samples = list(conll05.test()())[:24]
    rng = np.random.default_rng(12)
    feeds = []
    for i in range(3):
        rows = [s[-1] for s in samples[8 * i:8 * i + 8]]
        t = max(len(r) for r in rows)
        lab = np.zeros((8, t, 1), np.int64)
        for j, r in enumerate(rows):
            lab[j, :len(r), 0] = r
        inf = np.where(rng.random(lab.shape) < 0.25,
                       rng.integers(0, 19, lab.shape), lab)
        ln = np.asarray([len(r) for r in rows])
        feeds.append({'inf': (inf, ln), 'lab': (lab, ln)})
    results = []
    for pkg in (fluid, tfl):
        main, startup, ev = _chunk_program(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            ev.reset(exe)
            batch = [np.concatenate([np.ravel(v) for v in exe.run(
                main, feed=f, fetch_list=ev.metrics)]) for f in feeds]
            results.append((batch, ev.eval(exe)))
    for a, b in zip(results[1][0], results[0][0]):
        assert np.array_equal(a, b)
    assert np.array_equal(results[1][1], results[0][1])
    assert 0 < results[1][1][2] < 1
    assert _named(_chunk_program, tfl) == _named(_chunk_program, fluid)


def test_streaming_auc_matches_the_reference():
    parts = []
    for pkg in (fluid, tfl):
        whole = pkg.evaluator.StreamingAUC(bins=64)
        a = pkg.evaluator.StreamingAUC(bins=64)
        b = pkg.evaluator.StreamingAUC(bins=64)
        r = np.random.default_rng(13)
        for i in range(4):
            s, y = r.random(50), r.integers(0, 2, 50)
            whole.update(s, y)
            (a if i % 2 else b).update(s, y)
        parts.append((whole.eval(), a.merge(b).eval(), whole.count,
                      whole.positives, whole.negatives,
                      whole.reset().eval()))
    assert parts[1] == parts[0]
    assert parts[1][0] == parts[1][1] and parts[1][-1] == 0.5
    with pytest.raises(ValueError):
        tfl.evaluator.StreamingAUC(bins=8).merge(
            tfl.evaluator.StreamingAUC(bins=16))

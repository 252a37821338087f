"""The SRL BiLSTM-CRF through the port (paddle_tpu_torch/models/srl.py,
datasets/conll05.py), against the reference, on the CPU.

- The synthetic CoNLL-2005 test split, the dicts and the embedding table
  equal the reference's, sample for sample.
- Program parity: ``srl.build`` + ``SGDOptimizer.minimize`` serialise to
  exactly the reference's main and startup programs, at the book's widths
  (hidden 512, depth 4) and at the test's small ones.
- Training parity: at hidden 32 and depth 2 (module attributes set on
  both packages and restored), the reference builds and initialises, the
  port loads ``to_dict`` and every persistable, and both run 3 SGD steps
  (lr 0.01) on batches of 4 sentences through each package's
  ``DataFeeder``: the loss, the Viterbi paths and every parameter after
  the steps; ``word_emb`` (``trainable=False``) does not move, and
  ``crfw`` learns at 1e-3 of the rate.  The LSTMs' relu / sigmoid
  activations take the scan on both sides, so no kernel launches.
- tests/book/test_label_semantic_roles.py through the port, its gate
  unchanged.

Tolerances: the loss 1e-5 relative (a CRF NLL of O(10-60) summed over up
to 30 steps in float32); parameters after 3 steps 1e-5 absolute (SGD at
0.01 moves them by lr * g, g a few units at most, and the two packages'
gradients differ by float32 rounding).
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.datasets import conll05 as jconll05
from paddle_tpu.models import srl as jsrl

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.datasets import conll05
from paddle_tpu_torch.models import srl
from paddle_tpu_torch.ops.kernels import dense_update as tdu
from paddle_tpu_torch.ops.kernels import lstm as tlstm

TOL_LOSS_REL = 1e-5
TOL_PARAM = 1e-5
SMALL = dict(hidden_dim=32, depth=2)


@pytest.fixture
def small_widths(monkeypatch):
    for m in (jsrl, srl):
        for k, v in SMALL.items():
            monkeypatch.setattr(m, k, v)


def _dims():
    word_dict, verb_dict, label_dict = conll05.get_dict()
    return len(word_dict), len(verb_dict), 2, len(label_dict)


def _build(pkg, model, prog):
    with prog.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.program_guard(main, startup):
            feeds, _, decode, cost = model.build(*_dims())
            pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(cost)
    return main, startup, feeds, decode, cost


def test_conll05_matches_the_reference():
    assert list(conll05.test()()) == list(jconll05.test()())
    assert conll05.get_dict() == jconll05.get_dict()
    assert np.array_equal(conll05.get_embedding(), jconll05.get_embedding())
    assert conll05.word_dict_size() == jconll05.word_dict_size() == 4427
    assert _dims() == (4427, 300, 2, 19)


@pytest.mark.parametrize('widths', ['book', 'small'])
def test_port_build_serialises_to_the_reference_program(widths,
                                                        monkeypatch):
    if widths == 'small':
        for m in (jsrl, srl):
            for k, v in SMALL.items():
                monkeypatch.setattr(m, k, v)
    jm, js = _build(fluid, jsrl, jprog)[:2]
    tm, ts = _build(tfl, srl, tprog)[:2]
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    ops = [op.type for op in tm.global_block().ops]
    assert ops.count('lstm') == srl.depth
    assert 'linear_chain_crf' in ops and 'crf_decoding' in ops
    # every trainable parameter has one sgd apply, word_emb none
    sgd = [op.input('Param')[0] for op in tm.global_block().ops
           if op.type == 'sgd']
    params = [p.name for p in tm.all_parameters()]
    assert 'word_emb' in params and 'word_emb' not in sgd
    assert sorted(sgd) == sorted(p for p in params if p != 'word_emb')


def test_three_sgd_steps_match_the_reference(small_widths):
    jmain, jstartup, jfeeds, jdecode, jcost = _build(fluid, jsrl, jprog)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.array(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tmain = tfl.Program.from_dict(jmain.to_dict())
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    names = [v.name for v in jfeeds]
    jfeeder = fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=jfeeds,
                               program=jmain)
    tfeeder = tfl.DataFeeder(place=tfl.CPUPlace(), feed_list=names,
                             program=tmain)
    samples = list(conll05.test()())[:12]
    fetch = [jcost.name, jdecode.name]
    tdu.launches = tlstm.launches = tlstm.bwd_launches = 0
    for i in range(3):
        batch = samples[4 * i:4 * i + 4]
        want = jexe.run(jmain, feed=jfeeder.feed(batch), fetch_list=fetch,
                        scope=jscope)
        got = texe.run(tmain, feed=tfeeder.feed(batch), fetch_list=fetch,
                       scope=tscope)
        loss, ref = float(np.ravel(got[0])[0]), float(np.ravel(want[0])[0])
        assert np.isfinite(loss)
        assert abs(loss - ref) <= TOL_LOSS_REL * abs(ref), (i, loss, ref)
        assert np.array_equal(np.asarray(got[1]), np.asarray(want[1])), i
    for n in persist:
        a, b = tscope.get_numpy(n), np.asarray(jscope.get(n))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL_PARAM, n
    assert np.array_equal(tscope.get_numpy('word_emb'), persist['word_emb'])
    assert not np.array_equal(tscope.get_numpy('crfw'), persist['crfw'])
    # the CPU run took the plain versions; the LSTMs the scan
    assert tdu.launches == tlstm.launches == tlstm.bwd_launches == 0


def test_label_semantic_roles_trains():
    """tests/book/test_label_semantic_roles.py through the port."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 7
    with tfl.program_guard(main, startup):
        feeds, _, _, avg_cost = srl.build(*_dims())
        tfl.optimizer.SGDOptimizer(learning_rate=0.01).minimize(avg_cost)
    place = tfl.CPUPlace()
    exe, scope = tfl.Executor(place), tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=place, feed_list=feeds, program=main)
    reader = tfl.batch(tfl.reader.firstn(conll05.test(), 128),
                       batch_size=16, drop_last=True)
    costs = []
    for epoch in range(2):
        for batch in reader():
            c, = exe.run(main, feed=feeder.feed(batch),
                         fetch_list=[avg_cost], scope=scope)
            costs.append(float(np.ravel(c)[0]))
            assert np.isfinite(costs[-1])
    # the reference test's gate
    assert np.mean(costs[-4:]) < 18.0, \
        (np.mean(costs[:4]), np.mean(costs[-4:]))

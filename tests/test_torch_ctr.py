"""The CTR family through the port (paddle_tpu_torch/models/{ctr,
word2vec,recommender}.py and sentiment.py's ``convolution_net``), against
the reference, on the CPU.

- Program parity: each model's ``build`` + its optimizer's ``minimize``
  serialises to exactly the reference's main and startup programs
  (wide&deep with Adam, DeepFM with Adagrad, both at the Criteo-class
  layout and the small one; word2vec and the recommender with SGD; the
  convolution net with Adagrad).  Every table of the CTR models takes the
  SelectedRows path.
- Training parity, with the harness of tests/test_torch_seq2seq.py: the
  reference builds and initialises, the port loads ``to_dict`` and every
  persistable, both run 3 steps on the same seeded batches: wide&deep
  (lazy Adam 0.003) and DeepFM (Adagrad 0.01) at 4 slots of 97-row tables
  with ragged slots of 1-3 ids (padding id 0), word2vec (SGD 0.1; four
  lookups of one shared table, so one SelectedRows holds every lookup's
  rows) at dict 50, the recommender (SGD 0.2) on the synthetic MovieLens
  through each package's ``DataFeeder``, the convolution net (Adagrad 0.1)
  on ragged words.  Compared: the loss (and the CTR models' batch AUC)
  each step, every gradient (SelectedRows densified) each step, every
  parameter and moment after the 3 steps; rows no id touched are
  bitwise unchanged on both sides.
- The ports of tests/book/test_ctr.py (both archs, Adam 0.003),
  test_word2vec.py (SGD 0.1) and test_recommender_system.py (SGD 0.2,
  ``reader.firstn``), through ``batch`` and ``DataFeeder``, with the
  reference tests' gates.

Tolerances: the loss 1e-5 absolute (O(1), float32) and the AUC 1e-6
(count ratios of the same scores: only a score within rounding of a
threshold can differ); gradients 1e-5 of max(1e-2, the largest entry);
parameters and moments after 3 steps 1e-4 absolute (a lazy Adam step is
lr * m / (sqrt(v) + eps), sign-like where a gradient sits near float32
noise of zero, the bound of tests/test_torch_seq2seq.py; Adagrad's first
step is lr * g / (|g| + 1e-6), alike).
"""
import types

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.datasets import movielens as jmovielens
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import recommender as jrec
from paddle_tpu.models import sentiment as jsent
from paddle_tpu.models import word2vec as jw2v

import paddle_tpu_torch as tfl
from paddle_tpu_torch import datasets
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import ctr, recommender, sentiment, word2vec
from paddle_tpu_torch.ops.kernels import dense_update as tdu
from paddle_tpu_torch.ops.kernels import table_update as ttu

TOL_LOSS = 1e-5
TOL_AUC = 1e-6
TOL_GRAD_REL = 1e-5
TOL_STATE = 1e-4

REF = types.SimpleNamespace(ctr=jctr, word2vec=jw2v, recommender=jrec,
                            sentiment=jsent, prog=jprog)
PORT = types.SimpleNamespace(ctr=ctr, word2vec=word2vec,
                             recommender=recommender, sentiment=sentiment,
                             prog=tprog)
SMALL = dict(sparse_dim=97, num_slots=4, embed_dim=4)
CRITEO = dict(sparse_dim=1000003, num_slots=26)
W2V_DICT = 50
SENT_V = 40


def _models(pkg):
    return REF if pkg is fluid else PORT


def _ctr_fetch(m, arch, layout):
    _, _, avg_cost, auc = m.ctr.build(arch, **layout)
    return [avg_cost, auc]


MODELS = {
    # name: (fetch builder (models) -> [loss, ...], optimizer (pkg))
    'wide_and_deep': (lambda m: _ctr_fetch(m, 'wide_and_deep', SMALL),
                      lambda p: p.optimizer.AdamOptimizer(0.003)),
    'deepfm': (lambda m: _ctr_fetch(m, 'deepfm', SMALL),
               lambda p: p.optimizer.AdagradOptimizer(0.01)),
    'word2vec': (lambda m: [m.word2vec.build(W2V_DICT)[3]],
                 lambda p: p.optimizer.SGDOptimizer(0.1)),
    'recommender': (lambda m: [m.recommender.build()[2]],
                    lambda p: p.optimizer.SGDOptimizer(0.2)),
    'convolution_net': (
        lambda m: list(m.sentiment.build(SENT_V, net='conv')[2:4]),
        lambda p: p.optimizer.AdagradOptimizer(0.1)),
}


def _build(pkg, fetch_fn, opt_fn):
    m = _models(pkg)
    with m.prog.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.program_guard(main, startup):
            fetch = fetch_fn(m)
            opt_fn(pkg).minimize(fetch[0])
    return main, startup, fetch


def _sparse_tables(main):
    return [op.outputs['Out'][0][:-len('@GRAD')]
            for op in main.global_block().ops
            if op.type == 'sparse_grad_assemble']


@pytest.mark.parametrize('name,layout', [
    ('wide_and_deep', CRITEO), ('deepfm', CRITEO),
    ('wide_and_deep', SMALL), ('deepfm', SMALL), ('word2vec', None),
    ('recommender', None), ('convolution_net', None)])
def test_port_build_serialises_to_the_reference_program(name, layout):
    fetch_fn, opt_fn = MODELS[name]
    if layout is not None:
        arch = name

        def fetch_fn(m):
            return _ctr_fetch(m, arch, layout)
    jm, js, _ = _build(fluid, fetch_fn, opt_fn)
    tm, ts, _ = _build(tfl, fetch_fn, opt_fn)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    tables = _sparse_tables(tm)
    if layout is not None:   # every table of a CTR model is row-sparse
        n = layout['num_slots']
        prefix = {'wide_and_deep': ('embed_', 'wide_'),
                  'deepfm': ('fm_embed_', 'fm_w_')}[name]
        assert sorted(tables) == sorted(
            '%s%d' % (p, i) for p in prefix for i in range(n))
        assert not any(op.type == 'lookup_table' and
                       not op.attrs['is_sparse']
                       for op in tm.global_block().ops)
    elif name == 'word2vec':
        assert tables == ['shared_w']
        asm = [op for op in tm.global_block().ops
               if op.type == 'sparse_grad_assemble']
        assert len(asm[0].inputs['Ids']) == 4
    elif name == 'recommender':
        assert len(tables) == 7 and 'gender_table' in tables


def _ragged_ids(rng, b, height, lo=1, hi=3):
    lengths = rng.integers(lo, hi + 1, b)
    ids = np.zeros((b, int(lengths.max()), 1), np.int64)
    for r, n in enumerate(lengths):
        ids[r, :n, 0] = rng.integers(0, height, n)
    return ids, lengths


def _feeds(name, rng, b=16):
    """Three seeded batches for ``name`` as host feed dicts; the
    recommender's come through each package's DataFeeder instead."""
    out = []
    for _ in range(3):
        if name in ('wide_and_deep', 'deepfm'):
            f = {'dense': rng.standard_normal((b, 13)).astype(np.float32),
                 'label': rng.integers(0, 2, (b, 1)).astype(np.int64)}
            for i in range(SMALL['num_slots']):
                f['sparse_%d' % i] = _ragged_ids(rng, b,
                                                 SMALL['sparse_dim'])
        elif name == 'word2vec':
            f = {n: rng.integers(0, W2V_DICT, (b, 1)).astype(np.int64)
                 for n in ('firstw', 'secondw', 'thirdw', 'forthw',
                           'nextw')}
        elif name == 'convolution_net':
            f = {'words': _ragged_ids(rng, b, SENT_V, 1, 9),
                 'label': rng.integers(0, 2, (b, 1)).astype(np.int64)}
        out.append(f)
    return out


def _dense(a):
    if a.dtype == object:   # a SelectedRows fetch
        return np.asarray(a.item().to_dense())
    return np.asarray(a)


def _touched(name, main, feeds, table):
    """Rows of ``table`` some id of the 3 batches looked up."""
    block = main.global_block()
    ids = [op.inputs['Ids'][0] for op in block.ops
           if op.type == 'lookup_table' and op.inputs['W'][0] == table]
    rows = set()
    for f in feeds:
        for n in ids:
            v = f[n]
            v = v[0] if isinstance(v, tuple) else v
            rows.update(np.asarray(v).reshape(-1).tolist())
    return rows


@pytest.mark.parametrize('name', list(MODELS))
def test_three_steps_match_the_reference(name):
    fetch_fn, opt_fn = MODELS[name]
    jmain, jstartup, jfetch = _build(fluid, fetch_fn, opt_fn)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.array(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tmain = tfl.Program.from_dict(jmain.to_dict())
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    params = [p.name for p in jmain.all_parameters()]
    sparse = set(_sparse_tables(jmain))
    fetch = [v.name for v in jfetch] + [p + '@GRAD' for p in params]
    nf = len(jfetch)
    rng = np.random.default_rng(11)
    if name == 'recommender':
        samples = list(jmovielens.train()())[:48]
        batches = [samples[i:i + 16] for i in (0, 16, 32)]
        block = jmain.global_block()
        names = ['user_id', 'gender_id', 'age_id', 'job_id', 'movie_id',
                 'category_id', 'movie_title', 'score']
        jfeeder = fluid.DataFeeder(
            place=fluid.CPUPlace(), feed_list=[block.var(n) for n in names],
            program=jmain)
        tfeeder = tfl.DataFeeder(place=tfl.CPUPlace(), feed_list=names,
                                 program=tmain)
        jfeeds = [jfeeder.feed(b) for b in batches]
        tfeeds = [tfeeder.feed(b) for b in batches]
        ids_feeds = [{n: (np.asarray(f[n].padded()) if n in (
            'category_id', 'movie_title') else f[n]) for n in names[:-1]}
            for f in tfeeds]
    else:
        jfeeds = tfeeds = ids_feeds = _feeds(name, rng)
    for jf, tf in zip(jfeeds, tfeeds):
        want = jexe.run(jmain, feed=jf, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=tf, fetch_list=fetch, scope=tscope)
        assert np.isfinite(got[0]).all()
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL_LOSS
        if name in ('wide_and_deep', 'deepfm'):
            assert abs(float(got[1][0]) - float(want[1][0])) <= TOL_AUC
        for pn, a, b in zip(params, got[nf:], want[nf:]):
            assert (a.dtype == object) == (pn in sparse), pn
            a, b = _dense(a), _dense(b)
            tol = TOL_GRAD_REL * max(1e-2, float(np.abs(b).max()))
            assert np.abs(a - b).max() <= tol, pn
    for n in persist:   # parameters, moments, beta pows, lr
        a, b = tscope.get_numpy(n), np.asarray(jscope.get(n))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL_STATE, n
    for table in sparse:   # untouched rows and their moments, bitwise
        rows = _touched(name, jmain, ids_feeds, table)
        for n in persist:
            if n == table or n.startswith(table + '_'):
                a, b = tscope.get_numpy(n), np.asarray(jscope.get(n))
                assert a.shape[0] == persist[table].shape[0]
                keep = np.ones(a.shape[0], bool)
                keep[sorted(rows)] = False
                assert keep.any() or name == 'recommender'
                assert np.array_equal(a[keep], persist[n][keep]), n
                assert np.array_equal(b[keep], persist[n][keep]), n
    # the CPU run took the kernels' plain versions: no launch
    assert ttu.launches == tdu.launches == 0


def _book_exe(startup):
    place = tfl.CPUPlace()
    exe = tfl.Executor(place)
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    return place, exe, scope


@pytest.mark.parametrize('arch', ['wide_and_deep', 'deepfm'])
def test_ctr_trains(arch):
    """tests/book/test_ctr.py through the port."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 7
    with tfl.program_guard(main, startup):
        feeds, predict, avg_cost, auc = ctr.build(arch)
        tfl.optimizer.AdamOptimizer(learning_rate=0.003).minimize(avg_cost)
    assert any('embed_' in t for t in _sparse_tables(main))
    place, exe, scope = _book_exe(startup)
    feeder = tfl.DataFeeder(place=place, feed_list=feeds, program=main)
    reader = tfl.batch(tfl.reader.firstn(ctr.synthetic_reader(), 512),
                       batch_size=64, drop_last=True)
    costs = []
    for epoch in range(3):
        for batch in reader():
            c, = exe.run(main, feed=feeder.feed(batch),
                         fetch_list=[avg_cost], scope=scope)
            costs.append(float(np.ravel(c)[0]))
    # the reference test's gate
    assert np.mean(costs[-4:]) < 0.35, \
        (np.mean(costs[:4]), np.mean(costs[-4:]))


def test_word2vec_trains():
    """tests/book/test_word2vec.py through the port."""
    word_dict = datasets.imikolov.build_dict()
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 7
    with tfl.program_guard(main, startup):
        words, next_word, predict, avg_cost = word2vec.build(len(word_dict))
        tfl.optimizer.SGDOptimizer(learning_rate=0.1).minimize(avg_cost)
    place, exe, scope = _book_exe(startup)
    feeder = tfl.DataFeeder(place=place, feed_list=words + [next_word],
                            program=main)
    reader = tfl.batch(datasets.imikolov.train(word_dict, 5),
                       batch_size=64, drop_last=True)
    costs = []
    for epoch in range(2):
        for data in reader():
            c, = exe.run(main, feed=feeder.feed(data),
                         fetch_list=[avg_cost], scope=scope)
            costs.append(float(np.ravel(c)[0]))
    assert np.mean(costs[-20:]) < 7.1, \
        (np.mean(costs[:20]), np.mean(costs[-20:]))


def test_recommender_system():
    """tests/book/test_recommender_system.py through the port."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 7
    with tfl.program_guard(main, startup):
        feed_order, scale_infer, avg_cost = recommender.build()
        tfl.optimizer.SGDOptimizer(learning_rate=0.2).minimize(avg_cost)
    place, exe, scope = _book_exe(startup)
    feeder = tfl.DataFeeder(place=place, feed_list=feed_order, program=main)
    reader = tfl.batch(tfl.reader.firstn(datasets.movielens.train(), 512),
                       batch_size=64, drop_last=True)
    costs = []
    for epoch in range(4):
        for batch in reader():
            c, = exe.run(main, feed=feeder.feed(batch),
                         fetch_list=[avg_cost], scope=scope)
            costs.append(float(np.ravel(c)[0]))
    assert np.mean(costs[-4:]) < 4.8, \
        (np.mean(costs[:4]), np.mean(costs[-4:]))

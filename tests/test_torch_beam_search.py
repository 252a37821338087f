"""Beam search and seq2seq's beam decode in the port
(paddle_tpu_torch/ops/beam_search.py, layers/beam_search.py,
models/seq2seq.py ``decode``) against the reference, on the CPU.

- The four cases of tests/test_beam_search_op.py on both packages (the
  step against the numpy enumeration, the backtrack, the exhaustive
  search on a Markov chain, the layer program run by both), and planted
  ties: step 1's NEG_INF rows (beams 1..K-1 of the start lattice, which
  round to exactly -1e9 in float32), all beams finished, and equal
  log-probs within a live beam.  Ids and parents equal the reference's
  (``lax.top_k``: the lower flat index first among equals).
- ``beam_search_init`` and ``beam_gather`` against the reference's ops.
- The decode program built by the port serialises to exactly the
  reference's, as built and after the pass pipeline at levels 0-2, for
  K=4 and K=1 (the K == 1 reshape that restores the beam axis).
- Decode at a small width (V=50, word 8, hidden 8, max_len 6) from the
  reference's initial weights copied in: ids equal, scores within 1e-5,
  K=4 and K=1.  The test asserts its premise: at every tick the gap
  between the K-th and the (K+1)-th candidate of each source exceeds
  1e-4, so that equal ids mean something.
- The book's machine-translation test (train, then decode with K=4 and
  K=1) with its gates, on the port.
- The port's ``save_inference_model`` of the decode program, reloaded by
  the port, gives the live program's ids; the reference's own round trip
  drops the loop (its ``prune`` counts only declared outputs, and
  ``while`` declares none) and raises: recorded here, not repaired.
- Rescoring: each hypothesis the decode returns, fed teacher-forced to
  the training program (``seq2seq.rescoring_feed``), has a per-row summed
  cross entropy equal to minus its score within 1e-4 relative.

Tolerances: scores 1e-5 absolute (sums of max_len float32 log-probs of
O(1)); ops 1e-6 absolute; rescoring 1e-4 relative (log(softmax) against
the fused log-softmax, over up to max_len tokens).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.models import seq2seq as js2s
from paddle_tpu.ops import beam_search as jbs
from paddle_tpu.transpiler import pass_manager as jpm

import paddle_tpu_torch as tfl
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.datasets import wmt14
from paddle_tpu_torch.models import seq2seq as ts2s
from paddle_tpu_torch.ops import beam_search as tbs
from paddle_tpu_torch.transpiler import pass_manager as tpm

TOL = 1e-6
TOL_SCORE = 1e-5
TOL_RESCORE = 1e-4
MARGIN = 1e-4
V = 50
CFG = dict(word_dim=8, hidden_dim=8)
MAX_LEN = 6


def _np_step(pre_ids, pre_scores, scores, K, end_id):
    """tests/test_beam_search_op.py's numpy enumeration of K * V."""
    B, _, Vs = scores.shape
    ids = np.zeros((B, K), np.int32)
    out_scores = np.zeros((B, K), np.float32)
    parents = np.zeros((B, K), np.int32)
    for b in range(B):
        total = np.empty((K, Vs), np.float32)
        for k in range(K):
            if pre_ids[b, k] == end_id:
                total[k] = jbs.NEG_INF
                total[k, end_id] = pre_scores[b, k]
            else:
                total[k] = pre_scores[b, k] + scores[b, k]
        flat = total.reshape(-1)
        top = np.argsort(-flat, kind='stable')[:K]
        ids[b] = top % Vs
        parents[b] = top // Vs
        out_scores[b] = flat[top]
    return ids, out_scores, parents


def _both_steps(pre_ids, pre_scores, scores, K, end_id):
    want = [np.asarray(v) for v in jbs.beam_search_step(
        jnp.asarray(pre_ids), jnp.asarray(pre_scores), jnp.asarray(scores),
        K, end_id)]
    got = [v.numpy() for v in tbs.beam_search_step(
        torch.tensor(pre_ids), torch.tensor(pre_scores),
        torch.tensor(scores), K, end_id)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[2],
                                                              want[2])
    assert np.abs(got[1] - want[1]).max() <= TOL
    return got


@pytest.mark.parametrize('seed', [0, 1])
def test_beam_search_step_matches_the_reference(seed):
    rng = np.random.RandomState(seed)
    B, K, Vs, end_id = 3, 4, 11, 1
    pre_ids = rng.randint(0, Vs, (B, K)).astype(np.int32)
    pre_ids[0, 1] = end_id   # one finished beam
    pre_scores = rng.randn(B, K).astype(np.float32)
    scores = np.log(rng.dirichlet(np.ones(Vs), (B, K)).astype(np.float32)
                    + 1e-9)
    ids, sc, parents = _both_steps(pre_ids, pre_scores, scores, K, end_id)
    ref = _np_step(pre_ids, pre_scores, scores, K, end_id)
    assert np.array_equal(ids, ref[0]) and np.array_equal(parents, ref[2])
    assert np.abs(sc - ref[1]).max() <= TOL


@pytest.mark.parametrize('case', ['start_lattice', 'all_finished',
                                  'equal_logprobs', 'finished_and_start'])
def test_planted_ties_break_as_the_reference(case):
    """Equal candidates go to the lower flat index, as lax.top_k's do."""
    rng = np.random.RandomState(11)
    B, K, Vs, end_id = 3, 4, 3, 1
    pre_ids = np.zeros((B, K), np.int32)
    pre_scores = np.full((B, K), jbs.NEG_INF, np.float32)
    pre_scores[:, 0] = 0.0
    scores = np.log(rng.dirichlet(np.ones(Vs), (B, K)).astype(np.float32))
    if case == 'all_finished':
        pre_ids[:] = end_id
        pre_scores[:] = jbs.NEG_INF   # every candidate is -1e9
    elif case == 'equal_logprobs':
        pre_scores[:] = rng.randn(B, K).astype(np.float32)
        pre_scores[:, 2] = pre_scores[:, 1]
        scores[:, 2] = scores[:, 1]
        scores[:, :, 2] = scores[:, :, 0]
    elif case == 'finished_and_start':
        pre_ids[:, 0] = end_id   # the one live beam has finished
    total = pre_scores[:, :, None] + scores
    assert (total[:, 1:] == np.float32(jbs.NEG_INF)).all() or \
        case == 'equal_logprobs'
    ids, sc, parents = _both_steps(pre_ids, pre_scores, scores, K, end_id)
    ref = _np_step(pre_ids, pre_scores, scores, K, end_id)
    assert np.array_equal(ids, ref[0]) and np.array_equal(parents, ref[2])
    if case == 'all_finished':
        assert parents.tolist() == [[0, 0, 0, 1]] * B
        assert ids.tolist() == [[0, 1, 2, 0]] * B


def test_beam_search_backtrack_matches_the_reference():
    rng = np.random.RandomState(7)
    T, B, K, Vs, end_id = 5, 2, 3, 10, 1
    ids = rng.randint(0, Vs, (T, B, K)).astype(np.int32)
    parents = rng.randint(0, K, (T, B, K)).astype(np.int32)
    for steps in (T, 3, 0):
        want = np.asarray(jbs.beam_search_backtrack(ids, parents, steps,
                                                    end_id))
        got = tbs.beam_search_backtrack(
            torch.tensor(ids), torch.tensor(parents),
            torch.tensor(steps, dtype=torch.int32), end_id).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_full_search_is_exact_on_a_markov_chain():
    rng = np.random.RandomState(3)
    B, K, T, end_id = 2, 6, 4, 5
    step_logp = np.log(rng.dirichlet(np.ones(6), (B,)).astype(np.float32))
    step_logp[:, end_id] = -100.0
    pre_ids = np.zeros((B, K), np.int32)
    pre_scores = np.full((B, K), jbs.NEG_INF, np.float32)
    pre_scores[:, 0] = 0.0
    ids_l, par_l = [], []
    for _ in range(T):
        scores = np.repeat(step_logp[:, None, :], K, axis=1)
        pre_ids, pre_scores, parents = _both_steps(pre_ids, pre_scores,
                                                   scores, K, end_id)
        ids_l.append(pre_ids)
        par_l.append(parents)
    seqs = tbs.beam_search_backtrack(
        torch.tensor(np.stack(ids_l)), torch.tensor(np.stack(par_l)),
        torch.tensor(T), end_id).numpy()
    for b in range(B):
        assert list(seqs[b, 0]) == [int(np.argmax(step_logp[b]))] * T
        assert abs(pre_scores[b, 0] - T * step_logp[b].max()) <= 1e-5


def test_init_and_gather_match_the_reference():
    rng = np.random.default_rng(2)
    ref = rng.standard_normal((3, 5)).astype(np.float32)
    x = rng.standard_normal((3, 4, 6, 2)).astype(np.float32)
    idx = rng.integers(0, 4, (3, 4)).astype(np.int32)
    cases = [('beam_search_init', {'X': [ref]},
              {'beam_size': 4, 'start_id': 0}, ('Ids', 'Scores')),
             ('beam_gather', {'X': [x], 'Index': [idx]}, {}, ('Out',)),
             ('beam_gather', {'X': [x[..., 0]], 'Index': [idx]}, {},
              ('Out',))]
    for op, ins, attrs, slots in cases:
        want = jget_op(op).compute(
            None, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
            dict(attrs))
        got = tget_op(op).compute(
            None, {k: [torch.tensor(v) for v in vs] for k, vs in ins.items()},
            dict(attrs))
        for slot in slots:
            a, b = got[slot][0].numpy(), np.asarray(want[slot][0])
            assert a.shape == b.shape and a.dtype == b.dtype, (op, slot)
            assert np.abs(a - b).max() <= TOL, (op, slot)


def _layer_program(pkg, B=2, K=3, Vs=7, T=4, end_id=1):
    """tests/test_beam_search_op.py's layer program: beam_search over fed
    log-probs in a While loop, then the decode."""
    layers = pkg.layers
    logits = layers.data(name='logp', shape=[K, Vs], dtype='float32')
    ref = layers.reduce_sum(logits, dim=[1, 2])
    pre_ids, pre_scores = layers.beam_search_init(ref, K, start_id=0)
    counter = layers.zeros(shape=[1], dtype='int64')
    limit = layers.fill_constant(shape=[1], dtype='int64', value=T)
    cond = layers.less_than(x=counter, y=limit)
    ids_arr = layers.create_array('int64')
    par_arr = layers.create_array('int64')
    sc_arr = layers.create_array('float32')
    w = layers.While(cond=cond, max_iters=T)
    with w.block():
        sel_ids, sel_scores, parents = layers.beam_search(
            pre_ids=pre_ids, pre_scores=pre_scores, scores=logits,
            beam_size=K, end_id=end_id)
        layers.array_write(sel_ids, counter, ids_arr, capacity=T)
        layers.array_write(parents, counter, par_arr, capacity=T)
        layers.array_write(sel_scores, counter, sc_arr, capacity=T)
        layers.assign(sel_ids, pre_ids)
        layers.assign(sel_scores, pre_scores)
        layers.increment(x=counter, value=1, in_place=True)
        layers.less_than(x=counter, y=limit, cond=cond)
    return layers.beam_search_decode(ids_arr, par_arr, sc_arr,
                                     end_id=end_id)


def test_layer_program_runs_as_the_reference():
    progs = {}
    for name, pkg, pm in (('ref', fluid, jprog), ('port', tfl, tprog)):
        with pm.reset_unique_name_guard():
            main = pkg.Program()
            with pkg.program_guard(main, pkg.Program()):
                outs = _layer_program(pkg)
        progs[name] = (main, [v.name for v in outs])
    assert progs['port'][0].to_dict() == progs['ref'][0].to_dict()
    logp = np.log(np.random.RandomState(0).dirichlet(
        np.ones(7), (2, 3)).astype(np.float32))
    want = fluid.Executor(fluid.CPUPlace()).run(
        progs['ref'][0], feed={'logp': logp}, fetch_list=progs['ref'][1])
    got = tfl.Executor(tfl.CPUPlace()).run(
        progs['port'][0], feed={'logp': logp}, fetch_list=progs['port'][1])
    assert got[0].shape == (2, 3, 4)
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.abs(got[1] - np.asarray(want[1])).max() <= TOL
    assert np.all(np.diff(got[1], axis=1) <= 1e-5)


# -- seq2seq decode -------------------------------------------------------

def _decode_program(pkg, pm, mod, K, seed=3):
    with pm.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup):
            src = pkg.layers.data(name='src_word_id', shape=[1],
                                  dtype='int64', lod_level=1)
            ids, scores = mod.decode(src, V, beam_size=K, max_len=MAX_LEN,
                                     **CFG)
    return main, startup, ids.name, scores.name


@pytest.mark.parametrize('K', [4, 1])
def test_decode_program_serialises_to_the_reference(K):
    jmain, jstart, jids, _ = _decode_program(fluid, jprog, js2s, K)
    tmain, tstart, _, _ = _decode_program(tfl, tprog, ts2s, K)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    assert len(tmain.blocks) == 2
    for level in (0, 1, 2):
        feeds = ['src_word_id', 'src_word_id@LEN']
        jout, jrep = jpm.run_pipeline(jmain, fetch_names=[jids],
                                      feed_names=feeds, level=level,
                                      verify='boundary', mesh='')
        tout, trep = tpm.run_pipeline(tmain, fetch_names=[jids],
                                      feed_names=feeds, level=level,
                                      verify='boundary')
        assert tout.to_dict() == jout.to_dict(), level
        assert trep['eliminated'] == jrep['eliminated']


def _reference_decode(K, feed, seed=3):
    jmain, jstart, ids, scores = _decode_program(fluid, jprog, js2s, K,
                                                 seed)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    want = jexe.run(jmain, feed=feed, fetch_list=[ids, scores],
                    scope=jscope)
    return jmain, persist, [np.asarray(w) for w in want], (ids, scores)


def _source_feed(rng, B, T):
    lens = rng.integers(2, T + 1, B)
    lens[0] = T
    ids = np.zeros((B, T, 1), np.int64)
    for b in range(B):
        ids[b, :lens[b], 0] = rng.integers(3, V, lens[b])
    return {'src_word_id': (ids, lens.astype(np.int32))}


@pytest.mark.parametrize('K', [4, 1])
def test_decode_matches_the_reference(K, monkeypatch):
    feed = _source_feed(np.random.default_rng(K + 10), 3, 7)
    jmain, persist, want, names = _reference_decode(K, feed)
    margins = []
    top_k = tbs._top_k

    def recording_top_k(x, k):
        values = torch.sort(x, dim=1, descending=True, stable=True)[0]
        margins.append((values[:, k - 1] - values[:, k]).min().item())
        return top_k(x, k)
    monkeypatch.setattr(tbs, '_top_k', recording_top_k)
    tmain = tfl.Program.from_dict(jmain.to_dict())
    got = tfl.Executor(tfl.CPUPlace()).run(
        tmain, feed=feed, fetch_list=list(names),
        scope=scope_from_numpy(persist, 'cpu'))
    # the premise: the K-th candidate clears the (K+1)-th at every tick
    assert len(margins) == MAX_LEN and min(margins) > MARGIN, margins
    assert got[0].shape == (3, K, MAX_LEN) and got[0].dtype == np.int32
    assert np.array_equal(got[0], want[0])
    assert np.abs(got[1] - want[1]).max() <= TOL_SCORE
    assert np.all(np.diff(got[1], axis=1) <= 0)


def _port_decode(K, feed, persist):
    main, _, ids, scores = _decode_program(tfl, tprog, ts2s, K)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = scope_from_numpy(persist, 'cpu')
    return main, exe, scope, exe.run(main, feed=feed,
                                     fetch_list=[ids, scores], scope=scope)


def test_inference_model_of_the_decode_gives_the_live_ids(tmp_path):
    feed = _source_feed(np.random.default_rng(5), 3, 7)
    _, persist, _, _ = _reference_decode(4, feed)
    main, exe, scope, live = _port_decode(4, feed, persist)
    ids = main.global_block().var(main.global_block().ops[-1].output(
        'SentenceIds')[0])
    with tfl.scope_guard(scope):
        pruned = tio.save_inference_model(str(tmp_path), ['src_word_id'],
                                          [ids], exe, main)
    assert 'while' in [op.type for op in pruned.global_block().ops]
    assert len(pruned.blocks[1].ops) == len(main.blocks[1].ops)
    fresh = tfl.Scope()
    with tfl.scope_guard(fresh):
        prog, feeds, fetch = tio.load_inference_model(str(tmp_path), exe)
        got = exe.run(prog, feed=feed, fetch_list=fetch)
    assert feeds == ['src_word_id']
    assert np.array_equal(got[0], live[0])


def test_reference_inference_model_of_the_decode_drops_the_loop(tmp_path):
    """The reference's round trip fails (a recorded caveat, not repaired):
    its prune keeps an op only for its declared outputs, so the while and
    everything it computes go, and the decode reads an unwritten array."""
    feed = _source_feed(np.random.default_rng(5), 3, 7)
    jmain, jstart, ids, _ = _decode_program(fluid, jprog, js2s, 2)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(jstart)
        exe.run(jmain, feed=feed, fetch_list=[ids])   # the live program runs
        fluid.io.save_inference_model(
            str(tmp_path), ['src_word_id'],
            [jmain.global_block().var(ids)], exe, jmain)
        prog, _, fetch = fluid.io.load_inference_model(str(tmp_path), exe)
        assert sorted(op.type for op in prog.global_block().ops) == [
            'beam_search_decode'] + ['create_array'] * 3
        with pytest.raises(AttributeError, match='EmptyTArray'):
            exe.run(prog, feed=feed, fetch_list=fetch)


def _training_program(seed=3):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = seed
    with tfl.program_guard(main, startup):
        ts2s.build(V, **CFG)
    row_ce, = [op.output('Out')[0] for op in main.global_block().ops
               if op.type == 'sequence_pool' and
               op.attrs['pooltype'] == 'SUM']
    return main, row_ce


@pytest.mark.parametrize('K', [4, 1])
def test_rescoring_gives_minus_the_decode_scores(K):
    feed = _source_feed(np.random.default_rng(9), 4, 7)
    _, persist, _, _ = _reference_decode(K, feed)
    _, exe, scope, (ids, scores) = _port_decode(K, feed, persist)
    main, row_ce = _training_program()
    tf = ts2s.rescoring_feed(*feed['src_word_id'], ids)
    assert tf['target_language_word'][0].shape[0] == 4 * K
    ce, = exe.run(main, feed=tf, fetch_list=[row_ce], scope=scope)
    want = -scores.reshape(-1)
    assert np.all(np.abs(ce.reshape(-1) - want) <= TOL_RESCORE * np.abs(want))


def test_book_machine_translation_trains_then_decodes():
    """tests/book/test_machine_translation.py on the port: 3 epochs of 16
    batches of 16 (Adam 0.002, dict 1000), the reference's gate on the
    last 8 sum-pooled costs, then beam decode (K=4) and greedy (K=1) from
    the trained scope."""
    dict_size, max_len = 1000, 8
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 7
    with tfl.program_guard(main, startup):
        src, trg, label, _, avg_cost = ts2s.build(dict_size)
        tfl.optimizer.AdamOptimizer(learning_rate=0.002).minimize(avg_cost)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=tfl.CPUPlace(), feed_list=[src, trg, label],
                            program=main)
    reader = tfl.batch(tfl.reader.firstn(wmt14.train(dict_size), 256),
                       batch_size=16, drop_last=True)
    costs = []
    for _ in range(3):
        for batch in reader():
            c, = exe.run(main, feed=feeder.feed(batch),
                         fetch_list=[avg_cost], scope=scope)
            costs.append(float(np.ravel(c)[0]))
    assert np.mean(costs[-8:]) < 110.0, (np.mean(costs[:8]),
                                         np.mean(costs[-8:]))
    src_batch = [([2, 3, 4, 5],), ([6, 7],), ([8, 9, 10],)]
    for beam in (4, 1):
        prog = tfl.Program()
        with tfl.program_guard(prog, tfl.Program()):
            src_d = tfl.layers.data(name='src_word_id', shape=[1],
                                    dtype='int64', lod_level=1)
            seq_ids, seq_scores = ts2s.decode(
                src_d, dict_size, beam_size=beam, max_len=max_len,
                start_id=0, end_id=1)
        dec_feeder = tfl.DataFeeder(place=tfl.CPUPlace(), feed_list=[src_d],
                                    program=prog)
        ids, scores = exe.run(prog, feed=dec_feeder.feed(src_batch),
                              fetch_list=[seq_ids, seq_scores], scope=scope)
        assert ids.shape == (3, beam, max_len) and ids.dtype.kind in 'iu'
        assert np.all(np.isfinite(scores))
        assert np.all(np.diff(scores, axis=1) <= 1e-5)


def test_wmt14_reader_matches_the_reference():
    """The book test's reader: the reference's samples, bitwise."""
    from paddle_tpu.datasets import wmt14 as jwmt14
    assert list(wmt14.train(1000)()) == list(jwmt14.train(1000)())

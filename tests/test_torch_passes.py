"""The port's graph-optimization passes and pass manager
(paddle_tpu_torch/transpiler/passes.py, pass_manager.py) against the
reference's (paddle_tpu/transpiler/...).

Each golden program of the reference's tests/test_passes.py is built by
both packages; both pipelines run over it and the port's output must
serialise (``Program.to_dict``) to exactly the reference's, besides the
reference test's own assertions on the surviving ops.  The same holds for
the model programs (transformer, MNIST mlp and convnet, LSTM LM,
seq2seq, ResNet) at levels 0, 1 and 2 with AMP off, bf16 and f16.  Then
fetch equivalence through the port's executor: level 1 is exact (the
dropout stream included), level 2 within 1e-5 (folding and CSE reorder
no arithmetic here, so the bound is float32 noise); the level-0 bypass,
plan invalidation on a flag flip, memory_optimize / release_memory and
the donation analysis.  Programs are data: equality is exact.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.transpiler import pass_manager as jpm
from paddle_tpu.models import (mnist as jmnist, resnet as jresnet,
                               rnn_lm as jrnn, seq2seq as js2s,
                               transformer as jtr)
from paddle_tpu.models import fit_a_line as jfit, gan as jgan

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.models import (mnist as tmnist, resnet as tresnet,
                                     rnn_lm as trnn, seq2seq as ts2s,
                                     transformer as ttr)
from paddle_tpu_torch.models import fit_a_line as tfit, gan as tgan
from paddle_tpu_torch.transpiler import pass_manager as tpm
from paddle_tpu_torch.transpiler import passes as tpasses

PKGS = {'ref': (fluid, jprog, jpm), 'port': (tfl, tprog, tpm)}


@pytest.fixture(autouse=True)
def _fresh_names():
    """Every test builds under fresh name counters in both packages, so
    no name it draws shifts another test's in the same process."""
    with jprog.reset_unique_name_guard(), tprog.reset_unique_name_guard():
        yield


def _op_types(program):
    return [op.type for op in program.global_block().ops]


def _build(side, body):
    """``body(pkg) -> fetch names`` built into a fresh program under a
    fresh name counter."""
    pkg, prog_mod, _ = PKGS[side]
    with prog_mod.reset_unique_name_guard():
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            fetch = body(pkg, main)
    return main, fetch


def _pipelines(body, feed_names=(), **kw):
    """Both pipelines over ``body``'s program: (port out, port report,
    port main, fetch names); the two outputs must serialise equal."""
    outs = {}
    for side in PKGS:
        main, fetch = _build(side, body)
        pm = PKGS[side][2]
        extra = {'mesh': ''} if side == 'ref' else {}
        kw_side = dict(verify='off', amp_mode='0')
        kw_side.update(kw)
        out, rep = pm.run_pipeline(main, fetch_names=fetch,
                                   feed_names=feed_names, **kw_side,
                                   **extra)
        outs[side] = (out, rep, main, fetch)
    assert outs['port'][0].to_dict() == outs['ref'][0].to_dict()
    return outs['port']


def _dead_ops(pkg, main):
    x = pkg.layers.data(name='x', shape=[4], dtype='float32')
    live = pkg.layers.scale(x, scale=2.0)
    pkg.layers.scale(x, scale=9.0)
    pkg.layers.elementwise_add(live, live)
    return (live.name,)


def test_dce_removes_dead_ops_exact_list():
    opt, rep, main, _ = _pipelines(_dead_ops, ('x',), level=1)
    assert _op_types(opt) == ['scale']
    assert rep['eliminated'] == {'dce': 2}
    assert rep['ops_before'] == 3 and rep['ops_after'] == 1
    assert len(main.global_block().ops) == 3   # the user's program


def _counter(pkg, main):
    x = pkg.layers.data(name='x', shape=[4], dtype='float32')
    g = main.global_block().create_var(name='counter', shape=[1],
                                       dtype='float32', persistable=True)
    c = pkg.layers.fill_constant(shape=[1], dtype='float32', value=1.0)
    main.global_block().append_op(type='assign', inputs={'X': [c]},
                                  outputs={'Out': [g]})
    return (pkg.layers.scale(x, scale=2.0).name,)


def test_dce_keeps_persistable_writers():
    opt, rep, _, _ = _pipelines(_counter, ('x',), level=1)
    assert _op_types(opt) == ['fill_constant', 'assign', 'scale']
    assert rep['eliminated'] == {'dce': 0}


def _unknown_effect(pkg, main):
    x = pkg.layers.data(name='x', shape=[4], dtype='float32')
    y = pkg.layers.scale(x, scale=2.0)
    main.global_block().append_op(type='print', inputs={'In': [y]},
                                  outputs={'Out': ['print_out']},
                                  attrs={'message': 'dbg '})
    return (y.name,)


def test_dce_keeps_effectful_ops():
    """``print`` is effectful in both packages (and unregistered in the
    port, which the passes treat as effectful too)."""
    opt, _, _, _ = _pipelines(_unknown_effect, ('x',), level=2)
    assert 'print' in _op_types(opt)


def _const_chain(pkg, main):
    c = pkg.layers.fill_constant(shape=[2], dtype='float32', value=2.0)
    c2 = pkg.layers.scale(c, scale=3.0)
    return (pkg.layers.elementwise_add(c2, c2).name,)


def test_constant_fold_collapses_chain():
    opt, _, _, _ = _pipelines(_const_chain, level=2)
    assert _op_types(opt) == ['assign_value']
    av, = opt.global_block().ops
    np.testing.assert_array_equal(
        np.asarray(av.attrs['values'], np.float32),
        np.array([12.0, 12.0], np.float32))


def test_folded_constant_runs_from_assign_value():
    """The folded program runs in the port's executor, and its
    assign_value serves one device tensor for every step."""
    main, fetch = _build('port', _const_chain)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    a, = exe.run(main, fetch_list=list(fetch), scope=scope,
                 return_numpy=False)
    b, = exe.run(main, fetch_list=list(fetch), scope=scope,
                 return_numpy=False)
    assert a.data_ptr() == b.data_ptr()
    assert np.array_equal(a.numpy(), [12.0, 12.0])


def _mixed_consumer(pkg, main):
    x = pkg.layers.data(name='x', shape=[2], dtype='float32')
    c = pkg.layers.fill_constant(shape=[2], dtype='float32', value=2.0)
    c2 = pkg.layers.scale(c, scale=3.0)
    return (pkg.layers.elementwise_add(x, c2).name,)


def test_constant_fold_materializes_for_mixed_consumer():
    opt, _, _, _ = _pipelines(_mixed_consumer, ('x',), level=2)
    assert _op_types(opt) == ['assign_value', 'elementwise_add']


def _persist_fill(pkg, main):
    p = main.global_block().create_var(name='p', shape=[2],
                                       dtype='float32', persistable=True)
    main.global_block().append_op(
        type='fill_constant', outputs={'Out': [p]},
        attrs={'shape': [2], 'dtype': 'float32', 'value': 1.0})
    return ()


def test_constant_fold_skips_persistable_and_feed_writers():
    opt, rep, _, _ = _pipelines(_persist_fill, level=2)
    assert _op_types(opt) == ['fill_constant']
    assert rep['eliminated']['fold'] == 0


def _dupes(pkg, main):
    x = pkg.layers.data(name='x', shape=[4], dtype='float32')
    a1 = pkg.layers.scale(x, scale=2.0)
    a2 = pkg.layers.scale(x, scale=2.0)
    a3 = pkg.layers.scale(x, scale=5.0)
    y = pkg.layers.elementwise_add(a1, a2)
    return (pkg.layers.elementwise_add(y, a3).name,)


def test_cse_dedupes_identical_subexpressions():
    opt, rep, main, _ = _pipelines(_dupes, ('x',), level=2)
    assert rep['eliminated']['cse'] == 1
    assert _op_types(opt) == ['scale', 'scale', 'elementwise_add',
                              'elementwise_add']
    add = opt.global_block().ops[2]
    a1 = main.global_block().ops[0].output('Out')[0]
    assert add.inputs['X'] == [a1] and add.inputs['Y'] == [a1]


def _redefined(pkg, main):
    x = pkg.layers.data(name='x', shape=[4], dtype='float32')
    a1 = pkg.layers.scale(x, scale=2.0)
    main.global_block().append_op(type='scale', inputs={'X': [x]},
                                  outputs={'Out': [x]},
                                  attrs={'scale': 10.0})
    a2 = pkg.layers.scale(x, scale=2.0)
    return (pkg.layers.elementwise_add(a1, a2).name,)


def _run_port(main, feed_fn, fetch, level, monkeypatch, steps=1,
              startup=None):
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', str(level))
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    if startup is not None:
        exe.run(startup, scope=scope)
    outs = [exe.run(main, feed=feed_fn(i), fetch_list=list(fetch),
                    scope=scope) for i in range(steps)]
    return outs, exe.last_graph_opt_report


def test_cse_respects_name_redefinition(monkeypatch):
    opt, rep, main, fetch = _pipelines(_redefined, ('x',), level=2)
    assert rep['eliminated']['cse'] == 0
    assert len(_op_types(opt)) == 4
    feed = {'x': np.arange(4, dtype=np.float32).reshape(1, 4)}
    r0, _ = _run_port(main, lambda i: feed, fetch, 0, monkeypatch)
    r2, _ = _run_port(main, lambda i: feed, fetch, 2, monkeypatch)
    np.testing.assert_array_equal(r0[0][0], r2[0][0])
    np.testing.assert_array_equal(r0[0][0], 2 * feed['x'] + 20 * feed['x'])


def test_cse_skips_fetched_and_persistable_outputs():
    def body(pkg, main):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        a1 = pkg.layers.scale(x, scale=2.0)
        a2 = pkg.layers.scale(x, scale=2.0)
        return (pkg.layers.elementwise_add(a1, a2).name, a2.name)
    opt, rep, _, _ = _pipelines(body, ('x',), level=2)
    assert rep['eliminated']['cse'] == 0
    assert len(_op_types(opt)) == 3


def test_rng_ops_never_folded_or_deduped():
    def body(pkg, main):
        b = main.global_block()
        us = [b.create_var(name=n, shape=[2, 2], dtype='float32')
              for n in ('u1', 'u2')]
        for u in us:
            b.append_op(type='uniform_random', outputs={'Out': [u]},
                        attrs={'shape': [2, 2], 'dtype': 'float32',
                               'min': 0.0, 'max': 1.0})
        return (pkg.layers.elementwise_add(*us).name,)
    opt, rep, _, _ = _pipelines(body, level=2)
    assert _op_types(opt).count('uniform_random') == 2
    assert rep['eliminated']['fold'] == 0
    assert rep['eliminated']['cse'] == 0


def _mnist_sized(dropout):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed, startup.random_seed = 7, 11
    with tfl.program_guard(main, startup):
        img = tfl.layers.data(name='img', shape=[784], dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int32')
        h = tfl.layers.fc(input=img, size=32, act='relu')
        if dropout:
            h = tfl.layers.dropout(h, dropout_prob=0.3)
        dead = tfl.layers.fc(input=h, size=16, act='tanh')
        tfl.layers.scale(dead, scale=3.0)
        pred = tfl.layers.fc(input=h, size=10, act='softmax')
        avg = tfl.layers.mean(
            x=tfl.layers.cross_entropy(input=pred, label=label))
        tfl.optimizer.SGDOptimizer(learning_rate=0.1).minimize(avg)
    return main, startup, avg


def _mnist_feed(i):
    rng = np.random.RandomState(100 + i)
    return {'img': rng.randn(16, 784).astype('float32'),
            'label': rng.randint(0, 10, (16, 1)).astype('int32')}


@pytest.mark.parametrize('dropout', [False, True])
def test_fetch_equivalence_mnist_sized(dropout, monkeypatch):
    main, startup, avg = _mnist_sized(dropout)
    runs = {lv: _run_port(main, _mnist_feed, [avg.name], lv, monkeypatch,
                          steps=3, startup=startup) for lv in (0, 1, 2)}
    assert runs[0][1] is None
    # level 1 is exact, the dropout stream included (op_seq stamps)
    np.testing.assert_array_equal(np.ravel(runs[0][0]),
                                  np.ravel(runs[1][0]))
    np.testing.assert_allclose(np.ravel(runs[0][0]), np.ravel(runs[2][0]),
                               rtol=1e-5, atol=1e-6)
    assert runs[1][1]['eliminated']['dce'] >= 2
    assert runs[2][1]['ops_after'] < runs[2][1]['ops_before']


def test_fetch_equivalence_rnn_sized(monkeypatch):
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed, startup.random_seed = 3, 9
    with tfl.program_guard(main, startup):
        _, _, avg = trnn.build(vocab_size=50, emb_dim=16, hidden_dim=16)
        tfl.optimizer.AdagradOptimizer(0.1).minimize(avg)

    def feed(i):
        rng = np.random.RandomState(i)
        ln = np.full((2,), 6, np.int32)
        return {'src': (rng.randint(1, 50, (2, 6, 1)), ln),
                'target': (rng.randint(1, 50, (2, 6, 1)), ln)}
    runs = {lv: _run_port(main, feed, [avg.name], lv, monkeypatch,
                          steps=2, startup=startup)[0] for lv in (0, 1, 2)}
    np.testing.assert_array_equal(np.ravel(runs[0]), np.ravel(runs[1]))
    np.testing.assert_allclose(np.ravel(runs[0]), np.ravel(runs[2]),
                               rtol=1e-4, atol=1e-5)


def _dead_scale(pkg, main):
    x = pkg.layers.data(name='x', shape=[2], dtype='float32')
    pkg.layers.scale(x, scale=9.0)
    return (pkg.layers.scale(x, scale=2.0).name,)


def test_level0_bypass(monkeypatch):
    main, fetch = _build('port', _dead_scale)
    opt, rep = tpm.run_pipeline(main, fetch_names=fetch, level=0,
                                amp_mode='0', verify='off')
    assert opt is main
    assert rep['level'] == 0 and rep['eliminated'] == {}
    feed = {'x': np.ones((1, 2), np.float32)}
    outs, report = _run_port(main, lambda i: feed, fetch, 0, monkeypatch)
    assert report is None
    np.testing.assert_array_equal(outs[0][0], np.full((1, 2), 2.0))


def test_flag_flip_invalidates_plan_cache(monkeypatch):
    main, fetch = _build('port', _dead_scale)
    feed = {'x': np.ones((1, 2), np.float32)}
    exe = tfl.Executor(tfl.CPUPlace())
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '2')
    exe.run(main, feed=feed, fetch_list=list(fetch))
    assert exe.last_graph_opt_report['eliminated']['dce'] == 1
    n_plans = len(exe._plans)
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '0')
    exe.run(main, feed=feed, fetch_list=list(fetch))
    assert len(exe._plans) > n_plans
    assert exe.last_graph_opt_report is None
    exe.reset_cache()
    assert exe._plans == {}
    exe.run(main, feed=feed, fetch_list=list(fetch))


def test_skip_opt_set_roots_dce():
    def body(pkg, main):
        x = pkg.layers.data(name='x', shape=[2], dtype='float32')
        aux = pkg.layers.scale(x, scale=3.0)
        main._aux = aux.name
        return (pkg.layers.scale(x, scale=2.0).name,)
    main, fetch = _build('port', body)
    opt, rep = tpm.run_pipeline(main, fetch_names=fetch, feed_names=('x',),
                                level=2, amp_mode='0', verify='boundary',
                                extra_protected=(main._aux,))
    assert _op_types(opt) == ['scale', 'scale']
    assert rep['eliminated']['dce'] == 0
    _, rep2 = tpm.run_pipeline(main, fetch_names=fetch, feed_names=('x',),
                               level=2, amp_mode='0', verify='boundary')
    assert rep2['eliminated']['dce'] == 1


def test_run_steps_respects_flag_flip(monkeypatch):
    main, fetch = _build('port', _dead_scale)
    feed = {'x': np.ones((1, 2), np.float32)}
    exe = tfl.Executor(tfl.CPUPlace())
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '2')
    exe.run_steps(main, feed=feed, fetch_list=list(fetch), repeat=2)
    n_plans = len(exe._plans)
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '0')
    out = exe.run_steps(main, feed=feed, fetch_list=list(fetch), repeat=2)
    assert len(exe._plans) > n_plans
    np.testing.assert_array_equal(out[0][-1], np.full((1, 2), 2.0))


def _two_scales(pkg, main):
    x = pkg.layers.data(name='x', shape=[4], dtype='float32')
    h = pkg.layers.scale(x, scale=2.0)
    main._h = h.name
    return (pkg.layers.scale(h, scale=3.0).name,)


def test_memory_optimize_wires_pipeline():
    main, _ = _build('port', _two_scales)
    out = tfl.memory_optimize(main, skip_opt_set={main._h},
                              print_log=False)
    assert out is main
    assert main._graph_opt_requested
    assert main._h in main._graph_opt_skip_set
    rep = main._donation_report
    assert set(rep) == {'intermediates', 'donatable', 'short_lived',
                        'bytes_known'}
    assert main._h in rep['donatable']
    # the default level is the reference's 'dots': it arms remat and
    # bumps the version; an unknown level raises
    assert main._remat_level == 'dots'
    version = main.version
    tfl.memory_optimize(main, level='full')
    assert main._remat_level == 'full' and main.version > version
    with pytest.raises(ValueError, match='level must be one of'):
        tfl.memory_optimize(main, level='everything')


def test_release_memory_reports_instead_of_noop():
    main, _ = _build('port', _two_scales)
    version = main.version
    assert tfl.release_memory(main) is main
    assert main._graph_opt_requested and main.version > version
    assert main._donation_report['intermediates'] >= 1


def test_memory_optimize_floors_level_at_dce(monkeypatch):
    main, fetch = _build('port', _dead_scale)
    tfl.memory_optimize(main)
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '0')
    exe = tfl.Executor(tfl.CPUPlace())
    exe.run(main, feed={'x': np.ones((1, 2), np.float32)},
            fetch_list=list(fetch))
    rep = exe.last_graph_opt_report
    assert rep is not None and rep['level'] == 1
    assert rep['eliminated']['dce'] == 1
    assert exe.skipped_ops == [(0, 'scale')]


def test_donation_analysis_lifetimes():
    def body(pkg, main):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        a = pkg.layers.scale(x, scale=2.0)
        b = pkg.layers.scale(a, scale=3.0)
        c = pkg.layers.elementwise_add(b, b)
        main._names = (a.name, b.name)
        return (pkg.layers.elementwise_add(c, b).name,)
    reps = {}
    for side, mod in (('ref', jpm.passes), ('port', tpasses)):
        main, fetch = _build(side, body)
        reps[side] = mod.analyze_donation(main, fetch_names=fetch,
                                          feed_names=('x',))
    assert reps['port'] == reps['ref']
    rep = reps['port']
    a, b = main._names
    assert a in rep['short_lived']
    assert b in rep['donatable'] and b not in rep['short_lived']
    assert fetch[0] not in rep['donatable']
    assert rep['bytes_known'] > 0


def test_registered_passes_surface():
    """The port's registry: the reference's passes it ports, in the
    reference's orders, and build_plan's gates."""
    assert [(p.name, p.order) for p in tpm.registered_passes()] == [
        (p.name, p.order) for p in jpm.registered_passes()
        if p.name in ('dce', 'constant_fold', 'cse', 'dce_sweep', 'amp',
                      'donation', 'cost_model', 'memory_model')]
    assert [p.name for p in tpm.build_plan(1, None)] == [
        'dce', 'donation', 'cost_model', 'memory_model']
    assert [p.name for p in tpm.build_plan(0, 'bf16')] == ['amp']
    assert [p.name for p in tpm.build_plan(2, 'bf16')] == [
        'dce', 'constant_fold', 'cse', 'dce_sweep', 'amp', 'donation',
        'cost_model', 'memory_model']
    assert tpm.build_plan(0, None) == []


# ---------------------------------------------------------------------------
# the model programs through both pipelines
# ---------------------------------------------------------------------------

def _transformer(pkg, mod):
    _, _, cost = mod.build(vocab_size=64, seq_len=32, n_layers=2,
                           d_model=64, n_heads=4)
    pkg.optimizer.AdamOptimizer(1e-3).minimize(cost)
    return cost


def _mnist(kind):
    def build(pkg, mod):
        cost = mod.build(kind)[3]
        pkg.optimizer.AdamOptimizer(1e-3).minimize(cost)
        return cost
    return build


def _lstm_lm(pkg, mod):
    _, _, cost = mod.build(vocab_size=50, emb_dim=16, hidden_dim=16,
                           num_layers=2)
    pkg.optimizer.AdagradOptimizer(0.1).minimize(cost)
    return cost


def _seq2seq(pkg, mod):
    cost = mod.build(dict_size=30)[-1]
    pkg.optimizer.AdamOptimizer(1e-3).minimize(cost)
    return cost


def _resnet(pkg, mod):
    cost = mod.build_imagenet(depth=18, num_classes=10,
                              image_shape=(32, 32, 3), layout='NHWC')[3]
    pkg.optimizer.MomentumOptimizer(0.1, 0.9).minimize(cost)
    return cost


MODELS = {
    'transformer': (_transformer, jtr, ttr),
    'mnist_mlp': (_mnist('mlp'), jmnist, tmnist),
    'mnist_conv': (_mnist('conv'), jmnist, tmnist),
    'lstm_lm': (_lstm_lm, jrnn, trnn),
    'seq2seq': (_seq2seq, js2s, ts2s),
    'resnet': (_resnet, jresnet, tresnet),
}


def _model_program(side, name):
    fn, jmod, tmod = MODELS[name]
    pkg, prog_mod, _ = PKGS[side]
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            cost = fn(pkg, jmod if side == 'ref' else tmod)
    feeds = sorted(v.name for v in main.global_block().vars.values()
                   if v.is_data)
    return main, cost.name, feeds


@pytest.mark.parametrize('amp_mode', ['0', 'bf16', 'f16'])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_model_pipelines_serialise_to_the_reference(name, amp_mode):
    """run_pipeline at levels 0, 1 and 2 under the AMP mode, verified at
    the boundary on both sides: the port's output equals the
    reference's, op for op (cast names, cast CSE, the grey pull-down, the
    loss-scaling wiring), var for var."""
    jmain, jcost, feeds = _model_program('ref', name)
    tmain, tcost, _ = _model_program('port', name)
    assert tmain.to_dict() == jmain.to_dict()
    for level in (0, 1, 2):
        jout, jrep = jpm.run_pipeline(jmain, fetch_names=[jcost],
                                      feed_names=feeds, level=level,
                                      amp_mode=amp_mode, verify='boundary',
                                      mesh='')
        tout, trep = tpm.run_pipeline(tmain, fetch_names=[tcost],
                                      feed_names=feeds, level=level,
                                      amp_mode=amp_mode, verify='boundary')
        assert tout.to_dict() == jout.to_dict(), (name, level)
        assert trep['eliminated'] == jrep['eliminated']
        if amp_mode != '0':
            for k in ('casts', 'ops_lowered', 'loss_scaling'):
                assert trep['amp'][k] == jrep['amp'][k], k


def _gan(pkg, mod):
    _, _, d_loss, g_loss, _ = mod.build(img_dim=64)
    return [d_loss, g_loss]


def _fit_a_line(pkg, mod):
    cost = mod.build()[3]
    pkg.optimizer.SGDOptimizer(0.01).minimize(cost)
    return [cost]


# programs with several minimize passes (the GAN: two autodiff ops), and
# the book's fit_a_line
MULTI = {'gan': (_gan, jgan, tgan), 'fit_a_line': (_fit_a_line, jfit, tfit)}


@pytest.mark.parametrize('amp_mode', ['0', 'bf16', 'f16'])
@pytest.mark.parametrize('name', sorted(MULTI))
def test_gan_and_fit_a_line_pipelines_serialise_to_the_reference(
        name, amp_mode):
    """As ``test_model_pipelines_serialise_to_the_reference``, for the
    GAN (fetching both losses) and fit_a_line."""
    out = {}
    for side in ('ref', 'port'):
        fn, jmod, tmod = MULTI[name]
        pkg, prog_mod, _ = PKGS[side]
        with prog_mod.reset_unique_name_guard():
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup):
                costs = fn(pkg, jmod if side == 'ref' else tmod)
        feeds = sorted(v.name for v in main.global_block().vars.values()
                       if v.is_data)
        out[side] = (main, [c.name for c in costs], feeds)
    (jmain, fetch, feeds), (tmain, _, _) = out['ref'], out['port']
    assert tmain.to_dict() == jmain.to_dict()
    n_ad = sum(op.type == 'autodiff' for op in tmain.global_block().ops)
    assert n_ad == (2 if name == 'gan' else 1)
    for level in (0, 1, 2):
        jout, jrep = jpm.run_pipeline(jmain, fetch_names=fetch,
                                      feed_names=feeds, level=level,
                                      amp_mode=amp_mode, verify='boundary',
                                      mesh='')
        tout, trep = tpm.run_pipeline(tmain, fetch_names=fetch,
                                      feed_names=feeds, level=level,
                                      amp_mode=amp_mode, verify='boundary')
        assert tout.to_dict() == jout.to_dict(), (name, level)
        assert trep['eliminated'] == jrep['eliminated']
        if amp_mode != '0':
            for k in ('casts', 'ops_lowered', 'loss_scaling'):
                assert trep['amp'][k] == jrep['amp'][k], k

"""The cost and memory models in the port (paddle_tpu_torch/transpiler/
cost_model.py, memory_model.py) against the reference's, and the
executor's ``last_step_report``.

- The reference's golden programs (tests/test_cost_model.py: the MNIST
  MLP, its metrics tower, a VGG conv block, an LSTM cell;
  tests/test_memory_model.py: the fc forward, the train step under each
  remat level, the bf16 chain, feed donation, a fetched intermediate),
  built by both packages, give equal ``analyze_cost`` /
  ``analyze_memory`` reports, and the hand-derived goldens of the
  reference's tests hold on the port's.
- The pipeline's analysis passes (orders 95, 96) reach
  ``last_graph_opt_report['cost']`` with the executor's feed shapes,
  equal to the reference's; level 0 runs neither.
- Coverage: every op type the port registers gets a cost verdict and
  sizes its outputs, or has a waiver: from the port's model programs at
  small sizes, and, for the rest, a single-op program of (3, 4) float32
  inputs as the reference's sweep builds them.
- ``last_step_report`` on the CPU: the phases with the modelled FLOPs,
  ``memory`` with the modelled peak and a measured block of None (never
  0), ``mfu`` only when PADDLE_TPU_TORCH_PEAK_TFLOPS is set, the headroom
  block under PADDLE_TPU_TORCH_PEAK_HBM_BYTES.

Every number is exact: the models count from shapes.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.transpiler import cost_model as jcm
from paddle_tpu.transpiler import memory_model as jmm
from paddle_tpu.transpiler import pass_manager as jpm

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.transpiler import cost_model as tcm
from paddle_tpu_torch.transpiler import memory_model as tmm
from paddle_tpu_torch.transpiler import pass_manager as tpm

B = 32


@pytest.fixture(autouse=True)
def _fresh_names():
    with jprog.reset_unique_name_guard(), tprog.reset_unique_name_guard():
        yield


def _both(build):
    """(reference program, port program, fetch names) of ``build(pkg)``,
    each under fresh name counters."""
    out = []
    for pkg, pm in ((fluid, jprog), (tfl, tprog)):
        with pm.reset_unique_name_guard():
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup):
                fetch = build(pkg)
        out.append((main, tuple(v.name for v in fetch)))
    (jmain, jf), (tmain, tf) = out
    assert jf == tf
    return jmain, tmain, tf


def _mlp(pkg):
    img = pkg.layers.data(name='img', shape=[784], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    h = pkg.layers.fc(input=img, size=128, act='relu')
    pred = pkg.layers.fc(input=h, size=10, act='softmax')
    loss = pkg.layers.mean(x=pkg.layers.cross_entropy(input=pred,
                                                      label=label))
    pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return [loss]


def _tower(pkg):
    img = pkg.layers.data(name='img', shape=[16], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    pred = pkg.layers.fc(input=img, size=10, act='softmax')
    side = pkg.layers.fc(input=img, size=10, act='softmax')
    acc = pkg.layers.accuracy(input=side, label=label)
    loss = pkg.layers.mean(x=pkg.layers.cross_entropy(input=pred,
                                                      label=label))
    pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return [loss, acc]


def _vgg_block(pkg):
    img = pkg.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
    c1 = pkg.layers.conv2d(input=img, num_filters=64, filter_size=3,
                           padding=1, act='relu')
    c2 = pkg.layers.conv2d(input=c1, num_filters=64, filter_size=3,
                           padding=1, act='relu')
    p = pkg.layers.pool2d(input=c2, pool_size=2, pool_stride=2,
                          pool_type='max')
    return [pkg.layers.mean(x=p)]


def _lstm_cell(pkg):
    x = pkg.layers.data(name='x', shape=[5, 16], dtype='float32')
    proj = pkg.layers.fc(input=x, size=32, num_flatten_dims=2)
    hid, _cell = pkg.layers.dynamic_lstm(input=proj, size=32)
    return [pkg.layers.mean(x=hid)]


def _fwd(pkg):
    x = pkg.layers.data(name='x', shape=[4], dtype='float32')
    return [pkg.layers.mean(x=pkg.layers.fc(input=x, size=8))]


def _fwd_pinned(pkg):
    """_fwd fetching the mul's output too: it lives to the end."""
    out = _fwd(pkg)
    block = pkg.default_main_program().global_block()
    return out + [block.var(block.ops[0].outputs['Out'][0])]


def _train(pkg):
    img = pkg.layers.data(name='img', shape=[32], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    h = pkg.layers.fc(input=img, size=64, act='relu')
    pred = pkg.layers.fc(input=h, size=10, act='softmax')
    loss = pkg.layers.mean(x=pkg.layers.cross_entropy(input=pred,
                                                      label=label))
    pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return [loss]


COST_CASES = {
    'mlp': (_mlp, {'img': ((B, 784), 'float32'),
                   'label': ((B, 1), 'int32')}),
    'tower': (_tower, {'img': ((B, 16), 'float32'),
                       'label': ((B, 1), 'int32')}),
    'vgg_block': (_vgg_block, {'img': ((8, 3, 32, 32), 'float32')}),
    'lstm_cell': (_lstm_cell, {'x': ((4, 5, 16), 'float32')}),
    'fwd': (_fwd, {'x': ((4, 4), 'float32')}),
    'fwd_pinned': (_fwd_pinned, {'x': ((4, 4), 'float32')}),
    'train': (_train, {'img': ((4, 32), 'float32'),
                       'label': ((4, 1), 'int32')}),
}


@pytest.mark.parametrize('case', sorted(COST_CASES))
def test_analyze_cost_equals_the_reference(case):
    build, specs = COST_CASES[case]
    jmain, tmain, fetch = _both(build)
    want = jcm.analyze_cost(jmain, fetch_names=fetch, feed_specs=specs)
    got = tcm.analyze_cost(tmain, fetch_names=fetch, feed_specs=specs)
    assert got == want
    assert got['coverage']['no_verdict'] == []
    assert got['coverage']['unknown_dims'] == 0


@pytest.mark.parametrize('level', [None, 'dots', 'full'])
@pytest.mark.parametrize('case', sorted(COST_CASES))
def test_analyze_memory_equals_the_reference(case, level):
    build, specs = COST_CASES[case]
    jmain, tmain, fetch = _both(build)
    if level is not None:
        fluid.memory_optimize(jmain, level=level)
        tfl.memory_optimize(tmain, level=level)
    for kw in ({}, {'donate_feeds': False}):
        want = jmm.analyze_memory(jmain, fetch_names=fetch,
                                  feed_specs=specs, **kw)
        got = tmm.analyze_memory(tmain, fetch_names=fetch,
                                 feed_specs=specs, **kw)
        assert got == want
        assert got['remat_level'] == level
        assert got['coverage']['no_verdict'] == []


def _role_flops(rep, role):
    return rep['per_role'].get(role, {}).get('flops', 0)


def test_the_reference_goldens_hold_on_the_port():
    _, tmain, fetch = _both(_mlp)
    rep = tcm.analyze_cost(tmain, fetch, COST_CASES['mlp'][1])
    fwd_macs = B * 784 * 128 + B * 128 * 10
    assert _role_flops(rep, 'forward') == 2 * fwd_macs
    assert _role_flops(rep, 'backward') == 4 * fwd_macs
    assert _role_flops(rep, 'optimize') == 0
    assert rep['total']['flops'] == 6 * fwd_macs
    relu, = [e for e in rep['per_op'] if e['type'] == 'relu']
    assert relu['bytes'] == 2 * B * 128 * 4
    assert rep['feed_bytes'] == B * 784 * 4 + B * 4
    _, tmain, fetch = _both(_tower)
    rep = tcm.analyze_cost(tmain, fetch, COST_CASES['tower'][1])
    assert _role_flops(rep, 'forward') == 2 * (2 * B * 16 * 10)
    assert _role_flops(rep, 'backward') == 2 * (2 * B * 16 * 10)
    _, tmain, fetch = _both(_vgg_block)
    rep = tcm.analyze_cost(tmain, fetch, COST_CASES['vgg_block'][1])
    assert sorted(e['macs'] for e in rep['per_op'] if e['class'] == 'mac'
                  ) == [8 * 64 * 32 * 32 * 27, 8 * 64 * 32 * 32 * 576]
    _, tmain, fetch = _both(_lstm_cell)
    rep = tcm.analyze_cost(tmain, fetch, COST_CASES['lstm_cell'][1])
    lstm, = [e for e in rep['per_op'] if e['type'] == 'lstm']
    assert lstm['macs'] == 4 * 5 * 32 * 8   # B*T*4H*H
    # the memory model's hand walk of x[4,4] -> fc(8) -> mean
    _, tmain, fetch = _both(_fwd)
    rep = tmm.analyze_memory(tmain, fetch, COST_CASES['fwd'][1])
    persist, feed, tmp = (4 * 8 + 8) * 4, 4 * 4 * 4, 4 * 8 * 4
    assert [e['live_bytes'] for e in rep['timeline']] == [
        persist + feed + tmp, persist + 2 * tmp, persist + tmp + 4]
    assert rep['watermark'][0]['type'] == 'elementwise_add'
    # remat shrinks the modelled working set of a train step
    peaks = {}
    for level in (None, 'dots', 'full'):
        _, tmain, fetch = _both(_train)
        tfl.memory_optimize(tmain, level=level)
        peaks[level] = tmm.analyze_memory(
            tmain, fetch, COST_CASES['train'][1])['peak_bytes']
    assert peaks[None] >= peaks['dots'] >= peaks['full']
    assert peaks[None] > peaks['full']


@pytest.mark.parametrize('dt', ['float32', 'bfloat16'])
def test_bf16_values_count_two_bytes(dt):
    reps = []
    for pkg in (fluid, tfl):
        p = pkg.Program()
        b = p.global_block()
        b.create_var(name='mmx', shape=(4, 8), dtype=dt)
        b.append_op(type='scale', inputs={'X': ['mmx']},
                    outputs={'Out': ['mmy']}, attrs={'scale': 2.0})
        b.append_op(type='scale', inputs={'X': ['mmy']},
                    outputs={'Out': ['mmz']}, attrs={'scale': 0.5})
        mod = jmm if pkg is fluid else tmm
        reps.append(mod.analyze_memory(p, fetch_names=('mmz',),
                                       feed_specs={'mmx': ((4, 8), dt)}))
    assert reps[1] == reps[0]
    assert reps[1]['peak_bytes'] == 2 * 4 * 8 * (4 if dt == 'float32'
                                                 else 2)


@pytest.mark.parametrize('amp', ['0', 'bf16'])
def test_pipeline_reports_equal_the_reference(amp):
    jmain, tmain, fetch = _both(_mlp)
    specs = COST_CASES['mlp'][1]
    _, jrep = jpm.run_pipeline(jmain, fetch_names=fetch,
                               feed_names=tuple(specs), level=2,
                               amp_mode=amp, verify='off', mesh='',
                               feed_specs=specs)
    _, trep = tpm.run_pipeline(tmain, fetch_names=fetch,
                               feed_names=tuple(specs), level=2,
                               amp_mode=amp, verify='off',
                               feed_specs=specs)
    assert trep['cost'] == jrep['cost']
    names = [e['name'] for e in trep['passes']]
    assert names[-2:] == ['cost_model', 'memory_model']
    _, rep0 = tpm.run_pipeline(tmain, fetch_names=fetch,
                               feed_names=tuple(specs), level=0,
                               amp_mode='0', verify='off')
    assert 'cost' not in rep0


# -- coverage ------------------------------------------------------------

def _model_programs():
    """The port's models at small sizes, each with its optimizer: their
    programs and feed specs (-1 bound to 2)."""
    from paddle_tpu_torch.models import (ctr, mnist, recommender, resnet,
                                         rnn_lm, sentiment, seq2seq,
                                         transformer, vgg, word2vec)

    def vgg_book():
        img = tfl.layers.data(name='img', shape=[3, 32, 32],
                              dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        pred = vgg.vgg16_bn_drop(img, 10)
        return tfl.layers.mean(x=tfl.layers.cross_entropy(input=pred,
                                                          label=label))

    builds = [
        (lambda: transformer.build(50, 16, 1, 32, 2)[2], tfl.AdamOptimizer),
        (lambda: mnist.build('conv')[3], tfl.MomentumOptimizer),
        (lambda: resnet.build_imagenet(18, 10, (3, 32, 32))[3],
         tfl.MomentumOptimizer),
        (vgg_book, tfl.AdamOptimizer),
        (lambda: rnn_lm.build(60, 16, 32, fuse_vocab_loss=False)[2],
         tfl.AdagradOptimizer),
        (lambda: seq2seq.build(60, 16, 32)[4], tfl.AdamOptimizer),
        (lambda: sentiment.build(60, 'stacked_lstm')[2], tfl.AdamOptimizer),
        (lambda: sentiment.build(60, 'conv')[2], tfl.SGDOptimizer),
        (lambda: word2vec.build(60)[3], tfl.SGDOptimizer),
        (lambda: recommender.build()[2], tfl.SGDOptimizer),
        (lambda: ctr.build('deepfm', sparse_dim=1003, num_slots=4)[2],
         tfl.AdagradOptimizer),
    ]
    out = []
    for build, opt in builds:
        main, startup = tfl.Program(), tfl.Program()
        with tfl.program_guard(main, startup):
            cost = build()
            kw = {'momentum': 0.9} if opt is tfl.MomentumOptimizer else {}
            opt(learning_rate=0.01, **kw).minimize(cost)
        specs = {v.name: (tuple(2 if d == -1 else d for d in v.shape),
                          v.dtype)
                 for v in main.list_vars() if v.is_data}
        out.append((main, specs))
    return out


def _slot_semantic_programs():
    """Programs for the ops whose slots want shapes the generic sweep's
    (3, 4) inputs do not give: real layers, an assign_value as constant
    folding writes it, and the f16 AMP rewrite (the loss-scaling ops)."""
    out = []
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[12], dtype='float32')
        h0 = tfl.layers.data(name='h0', shape=[4], dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        tfl.layers.softmax_with_cross_entropy(x, label)
        tfl.layers.pad(x, paddings=[0, 0, 1, 1])
        tfl.layers.gru_unit(input=x, hidden=h0, size=12)
        tfl.layers.transpose(x, perm=[1, 0])
    main.global_block().create_var(name='cst', shape=(2,),
                                   dtype='float32')
    main.global_block().append_op(
        type='assign_value', outputs={'Out': ['cst']},
        attrs={'values': np.zeros(2, np.float32), 'shape': [2],
               'dtype': 'float32'})
    out.append((main, {'x': ((2, 12), 'float32'), 'h0': ((2, 4),
                                                         'float32'),
                       'label': ((2, 1), 'int64')}))
    _, tmain, fetch = _both(_train)
    specs = COST_CASES['train'][1]
    f16, _ = tpm.run_pipeline(tmain, fetch_names=fetch,
                              feed_names=tuple(specs), level=1,
                              amp_mode='f16', verify='off')
    out.append((f16, specs))
    return out


def _single_op_program(t):
    """The reference sweep's single-op program of op type ``t``, through
    the port's op signature, with (3, 4) float32 inputs."""
    from tests.test_zz_op_coverage import _SWEEP_ATTR_VALUES
    sig = treg.op_signature(t)
    in_slots = sorted(sig.in_slots) or ([] if not sig.in_open else ['X'])
    out_slots = sorted(sig.out_slots) or ['Out']
    p = tfl.Program()
    attrs = {k: _SWEEP_ATTR_VALUES[k] for k in sorted(sig.required_attrs)}
    inputs = {s: ['swp_%s_%s' % (t, s)] for s in in_slots}
    outputs = {s: ['swpout_%s_%s' % (t, s)] for s in out_slots}
    p.global_block().append_op(type=t, inputs=inputs, outputs=outputs,
                               attrs=attrs)
    feeds = {n: ((3, 4), 'float32') for ns in inputs.values() for n in ns}
    fetches = tuple(n for ns in outputs.values() for n in ns)
    return p, fetches, feeds


def test_every_registered_op_has_a_verdict_or_a_waiver():
    """Each op type the port registers is costed and sized in some
    program (no no-verdict, no unsized output), or waived."""
    ok, bad = set(), {}

    def take(main, fetches, specs):
        cost = tcm.analyze_cost(main, fetches, specs)
        mem = tmm.analyze_memory(main, fetches, specs)
        waived = set(cost['coverage']['waived'])
        unsized = set(mem['coverage']['unsized_vars'])
        for e in cost['per_op']:
            op = main.global_block().ops[e['index']]
            if e['type'] == 'autodiff' or \
                    unsized.isdisjoint(op.output_arg_names):
                ok.add(e['type'])
        ok.update(waived)
        for t in cost['coverage']['no_verdict']:
            bad.setdefault(t, 'no cost verdict')
        for t in mem['coverage']['no_verdict']:
            bad.setdefault(t, 'unsized outputs')

    for main, specs in _model_programs() + _slot_semantic_programs():
        take(main, (), specs)
    for t in treg.registered_ops():
        if t not in ok:
            take(*_single_op_program(t))
    missing = {t: bad.get(t, 'never costed')
               for t in treg.registered_ops() if t not in ok}
    assert missing == {}
    assert len(treg.registered_ops()) == 80
    # the class invariants: a mac op has its formula; waivers are real
    for t in treg.registered_ops():
        assert treg.op_traits(t).cost == treg.cost_class(t)
        if t in treg.COST_MAC:
            assert t in tcm.MAC_FORMULAS
    assert set(tcm.MAC_FORMULAS) <= treg.COST_MAC
    assert treg.COST_MAC == treg.AMP_WHITE
    for t in tcm.WAIVED_OPS:
        assert t == 'autodiff' or treg.has_op(t)
    assert 'autodiff' not in tmm.WAIVED_OPS


def test_closed_forms_equal_the_reference():
    args = dict(n_layers=2, d_model=32, n_heads=4, d_ff=128, vocab_size=64)
    assert tcm.decode_step_cost(streams=4, ctx_len=24, **args) == \
        jcm.decode_step_cost(streams=4, ctx_len=24, **args)
    for cached in (0, 7, 20):
        assert tcm.prefill_cost(prompt_len=20, cached_len=cached, **args) \
            == jcm.prefill_cost(prompt_len=20, cached_len=cached, **args)
    ins = {'Q': [((3, 2, 8), 'float32')],
           'KPool': [((17, 4, 2, 8), 'float32')],
           'VPool': [((17, 4, 2, 8), 'float32')],
           'PT': [((3, 4), 'int32')], 'CtxLen': [((3,), 'int32')]}
    outs = {'Out': [((3, 2, 8), 'float32')]}
    assert tcm.op_cost('paged_attention', ins, outs, {}) == \
        jcm.op_cost('paged_attention', ins, outs, {})


# -- the executor's step report ------------------------------------------

def _train_run(monkeypatch, env=None, runner='run_steps', level=None):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    _, tmain, fetch = _both(_train)
    if level is not None:
        tfl.memory_optimize(tmain, level=level)
    startup = tfl.Program()
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    from paddle_tpu_torch.core.scope import scope_from_numpy
    rng = np.random.default_rng(0)
    state = {p.name: rng.standard_normal(p.shape).astype(np.float32) * 0.1
             for p in tmain.all_parameters()}
    lr = [v.name for v in tmain.list_vars()
          if v.persistable and v.name not in state]
    state.update({n: np.full((1,), 0.1, np.float32) for n in lr})
    scope_from_numpy(state, 'cpu', scope)
    del startup
    feed = {'img': rng.standard_normal((4, 32)).astype(np.float32),
            'label': rng.integers(0, 10, (4, 1))}
    if runner == 'run_steps':
        exe.run_steps(tmain, feed=feed, repeat=3, fetch_list=list(fetch),
                      scope=scope)
    else:
        exe.run(tmain, feed=feed, fetch_list=list(fetch), scope=scope)
    return exe


@pytest.mark.parametrize('runner', ['run', 'run_steps'])
def test_last_step_report_on_the_cpu(monkeypatch, runner):
    exe = _train_run(monkeypatch, runner=runner)
    rep = exe.last_step_report
    k = 3 if runner == 'run_steps' else 1
    assert rep['k'] == k and rep['synced']
    assert rep['wall_s'] >= rep['compute_s'] >= 0.0
    assert abs(rep['wall_s'] - rep['feed_s'] - rep['update_s'] -
               rep['compute_s']) < 1e-9
    comp = rep['phases']['compute']
    fwd_macs = 4 * 32 * 64 + 4 * 64 * 10
    assert comp['flops_per_step'] == 6 * fwd_macs
    assert comp['flops'] == 6 * fwd_macs * k
    assert comp['flops_per_s'] > 0 and 'mfu' not in comp
    mem = rep['memory']
    assert mem['measured'] is None and 'measured_peak_bytes' not in mem
    assert mem['modeled_peak_bytes'] > 0
    assert mem['watermark_op']['type'] == 'autodiff'
    assert mem['remat_level'] is None and 'headroom' not in mem
    assert rep['cost'] is exe.last_graph_opt_report['cost']


def test_mfu_and_headroom_follow_their_flags(monkeypatch):
    exe = _train_run(monkeypatch, env={
        'PADDLE_TPU_TORCH_PEAK_TFLOPS': '2.0',
        'PADDLE_TPU_TORCH_PEAK_HBM_BYTES': str(1 << 30)}, level='dots')
    rep = exe.last_step_report
    comp = rep['phases']['compute']
    assert comp['mfu'] == comp['flops_per_s'] / 2e12
    head = rep['memory']['headroom']
    assert head['budget_bytes'] == 1 << 30
    assert 0 < head['modeled_ratio'] < 1 and 'measured_ratio' not in head
    assert rep['memory']['remat_level'] == 'dots'
    # the reference's switch leaves the port alone
    monkeypatch.delenv('PADDLE_TPU_TORCH_PEAK_TFLOPS')
    monkeypatch.setenv('PADDLE_TPU_PEAK_TFLOPS', '2.0')
    exe = _train_run(monkeypatch)
    assert 'mfu' not in exe.last_step_report['phases']['compute']


def test_level0_has_no_modelled_numbers(monkeypatch):
    exe = _train_run(monkeypatch,
                     env={'PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL': '0'})
    rep = exe.last_step_report
    assert exe.last_graph_opt_report is None and rep['cost'] is None
    assert 'flops' not in rep['phases']['compute']
    assert rep['memory']['modeled_peak_bytes'] is None
    assert rep['memory']['measured'] is None

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
  small sizes, a control-flow program, a program of the dense op
  library's slot-shaped ops and seq2seq's beam decode, and,
  for the rest, a single-op program of (3, 4) float32 inputs as the
  reference's sweep builds them; ``create_array`` alone has neither, as
  in the reference.  Each op the control-flow slice brings is classed
  as the reference classes it (the same reports on the reference
  sweep's program), and the decode program's reports equal the
  reference's.
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
    out.append(_control_flow_program())
    out.append(_sequence_labelling_program())
    out.append(_op_library_program())
    out.append(_serving_attention_program())
    (_, decode), _, specs = _decode_programs()
    out.append((decode, specs))
    return out


def _control_flow_program():
    """A StaticRNN, a ConditionalBlock, the IfElse row split and merge, a
    rank table and a shrunk memory: the control-flow ops on the shapes
    their slots want."""
    main = tfl.Program()
    layers = tfl.layers
    with tfl.program_guard(main, tfl.Program()):
        x = layers.data(name='x', shape=[5, 3], dtype='float32')
        h = layers.data(name='h', shape=[3], dtype='float32')
        mask = layers.data(name='mask', shape=[1], dtype='bool')
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[-1, 3], batch_ref=x)
            acc = layers.elementwise_add(x=mem, y=xt)
            rnn.update_memory(mem, acc)
            rnn.step_output(acc)
        rnn()
        with layers.ConditionalBlock([layers.reduce_sum(mask)]).block():
            layers.scale(x=h, scale=2.0)
        t, f = layers.split_lod_tensor(h, mask)
        layers.merge_lod_tensor(t, f, h, mask)
        table = layers.lod_rank_table(x)
        layers.max_sequence_len(table)
        layers.shrink_memory(h, layers.zeros(shape=[1], dtype='int64'),
                             table)
    return main, {'x': ((2, 5, 3), 'float32'), 'h': ((2, 3), 'float32'),
                  'mask': ((2, 1), 'bool')}


def _sequence_labelling_program():
    """The sequence-labelling slice's ops on the shapes their slots want:
    the CRF pair, chunk_eval, edit_distance (sequence_erase under it),
    warpctc, the LoD ops, one_hot, im2sequence, row_conv and a
    sequence_reshape."""
    main = tfl.Program()
    layers = tfl.layers
    with tfl.program_guard(main, tfl.Program()):
        x = layers.data(name='x', shape=[4], dtype='float32', lod_level=1)
        ids = layers.data(name='ids', shape=[1], dtype='int64', lod_level=1)
        tok = layers.data(name='tok', shape=[], dtype='int64', lod_level=1)
        img = layers.data(name='img', shape=[2, 4, 4], dtype='float32')
        off = layers.data(name='off', shape=[1], dtype='int64')
        layers.linear_chain_crf(x, ids, param_attr='crfw')
        path = layers.crf_decoding(x, param_attr='crfw')
        layers.chunk_eval(path, ids, 'IOB', 1)
        layers.edit_distance(tok, tok, ignored_tokens=[0])
        layers.warpctc(x, tok)
        layers.one_hot(ids, depth=4)
        layers.im2sequence(img, filter_size=2)
        layers.row_conv(x, future_context_size=1)
        layers.sequence_expand(layers.sequence_pool(x, 'sum'), x)
        cat = layers.sequence_concat([x, x])
        layers.sequence_slice(cat, off, off)
        layers.lod_reset(x, target_lod=[1, 2])
    block = main.global_block()
    block.create_var(name='seq_reshaped', dtype='float32')
    block.append_op(type='sequence_reshape', inputs={'X': [x]},
                    outputs={'Out': ['seq_reshaped']},
                    attrs={'new_dim': 2})
    return main, {'x': ((2, 3, 4), 'float32'), 'x@LEN': ((2,), 'int32'),
                  'ids': ((2, 3, 1), 'int32'), 'ids@LEN': ((2,), 'int32'),
                  'tok': ((2, 3), 'int32'), 'tok@LEN': ((2,), 'int32'),
                  'img': ((2, 2, 4, 4), 'float32'),
                  'off': ((2, 1), 'int32')}


def _op_library_program():
    """The dense op library's ops whose slots want shapes the generic
    sweep's (3, 4) inputs do not give: its layers, and the ops without a
    layer appended directly."""
    main = tfl.Program()
    layers = tfl.layers
    with tfl.program_guard(main, tfl.Program()):
        x = layers.data(name='x', shape=[6], dtype='float32')
        ids = layers.data(name='ids', shape=[1], dtype='int64')
        img = layers.data(name='img', shape=[4, 6, 6], dtype='float32')
        vol = layers.data(name='vol', shape=[2, 4, 4, 4], dtype='float32')
        rois = layers.data(name='rois', shape=[5], dtype='float32')
        loc = layers.data(name='loc', shape=[8, 4], dtype='float32')
        conf = layers.data(name='conf', shape=[8, 3], dtype='float32')
        prior = layers.data(name='prior', shape=[8], dtype='float32')
        layers.nce(x, ids, num_total_classes=7, num_neg_samples=3)
        layers.bilinear_tensor_product(x, x, size=3)
        layers.multiplex([x, x], layers.cast(ids, 'int32'))
        layers.conv3d(vol, num_filters=2, filter_size=2)
        layers.conv2d_transpose(img, num_filters=2, filter_size=3)
        layers.pool3d(vol, pool_size=2, pool_stride=2)
        layers.lrn(img)
        layers.roi_pool(img, rois, pooled_height=2, pooled_width=2)
        layers.detection_output(loc, conf, prior, num_classes=3)
    block = main.global_block()

    def append(op, inputs, outs, attrs):
        for n in outs.values():
            block.create_var(name=n, dtype='float32')
        block.append_op(type=op, inputs=inputs,
                        outputs={k: [n] for k, n in outs.items()},
                        attrs=attrs)
    append('maxout', {'X': [img]}, {'Out': 'lib_maxout'}, {'groups': 2})
    append('fill', {}, {'Out': 'lib_fill'},
           {'value': [1.0, 2.0], 'shape': [2], 'dtype': 'float32'})
    append('scatter', {'X': [x], 'Ids': [ids], 'Updates': [x]},
           {'Out': 'lib_scatter'}, {})
    append('conv3d_transpose',
           {'Input': [vol], 'Filter': [block.create_parameter(
               name='lib_w3t', shape=[2, 3, 2, 2, 2], dtype='float32')]},
           {'Output': 'lib_conv3d_t'}, {})
    append('max_pool2d_with_index', {'X': [img]},
           {'Out': 'lib_mp', 'Mask': 'lib_mp_mask'}, {'ksize': [2, 2]})
    append('unpool', {'X': ['lib_mp'], 'Indices': ['lib_mp_mask']},
           {'Out': 'lib_unpool'},
           {'unpooled_height': 6, 'unpooled_width': 6})
    append('spp', {'X': [img]}, {'Out': 'lib_spp'}, {'pyramid_height': 2})
    return main, {'x': ((2, 6), 'float32'), 'ids': ((2, 1), 'int32'),
                  'img': ((2, 4, 6, 6), 'float32'),
                  'vol': ((2, 2, 4, 4, 4), 'float32'),
                  'rois': ((3, 5), 'float32'),
                  'loc': ((2, 8, 4), 'float32'),
                  'conf': ((2, 8, 3), 'float32'),
                  'prior': ((8, 8), 'float32')}


def _serving_attention_program():
    """The serving attention ops on a page pool, page tables, context
    lengths and a chunk start, the shapes the decode engine gives them."""
    s, h, d, p, n, mpp, c = 3, 2, 8, 4, 16, 4, 5
    specs = {'sv_q': ((s, h, d), 'float32'),
             'sv_kp': ((n + 1, p, h, d), 'float32'),
             'sv_vp': ((n + 1, p, h, d), 'float32'),
             'sv_pt': ((s, mpp), 'int32'), 'sv_ctx': ((s,), 'int32'),
             'sv_cq': ((c, h, d), 'float32'), 'sv_pt1': ((mpp,), 'int32'),
             'sv_pos0': ((), 'int32')}
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        for name, (shape, dtype) in specs.items():
            tfl.layers.data(name=name, shape=list(shape), dtype=dtype,
                            append_batch_size=False)
    block = main.global_block()
    for op, ins in (('paged_attention',
                     {'Q': ['sv_q'], 'KPool': ['sv_kp'], 'VPool': ['sv_vp'],
                      'PT': ['sv_pt'], 'CtxLen': ['sv_ctx']}),
                    ('chunked_prefill_attention',
                     {'Q': ['sv_cq'], 'KPool': ['sv_kp'], 'VPool': ['sv_vp'],
                      'PT': ['sv_pt1'], 'Pos0': ['sv_pos0']})):
        block.create_var(name='sv_' + op, dtype='float32')
        block.append_op(type=op, inputs=ins, outputs={'Out': ['sv_' + op]},
                        attrs={})
    return main, specs


def _decode_programs(K=2):
    """seq2seq's beam decode at a small width, built by both packages."""
    from paddle_tpu.models import seq2seq as js2s
    from paddle_tpu_torch.models import seq2seq as ts2s
    out = []
    for pkg, pm, mod in ((fluid, jprog, js2s), (tfl, tprog, ts2s)):
        with pm.reset_unique_name_guard():
            main = pkg.Program()
            with pkg.program_guard(main, pkg.Program()):
                src = pkg.layers.data(name='src_word_id', shape=[1],
                                      dtype='int64', lod_level=1)
                ids, scores = mod.decode(src, 60, word_dim=8, hidden_dim=16,
                                         beam_size=K, max_len=4)
        out.append(main)
    specs = {'src_word_id': ((2, 5, 1), 'int32'),
             'src_word_id@LEN': ((2,), 'int32')}
    return out, (ids.name, scores.name), specs


def _single_op_program(t):
    """The reference sweep's single-op program of op type ``t``, through
    the port's op signature, with (3, 4) float32 inputs (a sub-block op
    gets an empty block, a while its condition fed)."""
    from tests.test_zz_op_coverage import _SWEEP_ATTR_VALUES
    sig = treg.op_signature(t)
    in_slots = sorted(sig.in_slots) or ([] if not sig.in_open else ['X'])
    out_slots = sorted(sig.out_slots) or ['Out']
    p = tfl.Program()
    attrs = {}
    for k in sorted(sig.required_attrs):
        if k == 'sub_block':
            p.create_block()
            p.current_block_idx = 0
            attrs[k] = 1
        elif k == 'condition':
            attrs[k] = 'swp_cond'
        else:
            attrs[k] = _SWEEP_ATTR_VALUES[k]
    inputs = {s: ['swp_%s_%s' % (t, s)] for s in in_slots}
    outputs = {s: ['swpout_%s_%s' % (t, s)] for s in out_slots}
    p.global_block().append_op(type=t, inputs=inputs, outputs=outputs,
                               attrs=attrs)
    feeds = {n: ((3, 4), 'float32') for ns in inputs.values() for n in ns}
    if 'condition' in attrs:
        feeds['swp_cond'] = ((3, 4), 'float32')
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
    # an array's handle has no dense extent and no waiver: the reference
    # reports create_array as a no-verdict op too
    assert missing == {'create_array': 'no cost verdict'}
    from tests.test_zz_op_coverage import _sweep_program
    p, fetches, feeds = _sweep_program('create_array')
    assert jcm.analyze_cost(p, fetches, {})['coverage']['no_verdict'] == [
        'create_array']
    assert len(treg.registered_ops()) == 190
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


# the op types the control-flow slice brings
CONTROL_FLOW_OPS = [
    'while', 'conditional_block', 'recurrent', 'create_array',
    'write_to_array', 'read_from_array', 'array_length',
    'lod_tensor_to_array', 'array_to_lod_tensor', 'lod_rank_table',
    'max_sequence_len', 'shrink_rnn_memory', 'print', 'is_empty',
    'split_lod_tensor', 'merge_lod_tensor', 'expand', 'fill_zeros_like',
    'fill_constant_batch_size_like', 'logical_and', 'logical_or',
    'logical_xor', 'logical_not', 'reorder_lod_tensor_by_rank', 'log',
    'beam_search', 'beam_search_init', 'beam_gather', 'beam_search_decode']


@pytest.mark.parametrize('op', CONTROL_FLOW_OPS)
def test_control_flow_ops_are_classed_as_the_reference(op):
    """The reference sweep's single-op program of each op the slice
    brings, costed and sized by both packages: the same waivers,
    no-verdicts, unsized outputs and numbers."""
    from tests.test_zz_op_coverage import _sweep_program
    p, fetches, feeds = _sweep_program(op)
    specs = {n: ((3, 4), 'float32') for n in feeds}
    tp = tfl.Program.from_dict(p.to_dict())
    assert tcm.analyze_cost(tp, fetches, specs) == jcm.analyze_cost(
        p, fetches, specs)
    assert tmm.analyze_memory(tp, fetches, specs) == jmm.analyze_memory(
        p, fetch_names=fetches, feed_specs=specs)


@pytest.mark.parametrize('level', [None, 'dots', 'full'])
def test_decode_reports_equal_the_reference(level):
    """seq2seq's beam decode: neither model descends into the loop's
    block, so the while is waived and the reports are the global
    block's."""
    (jmain, tmain), fetch, specs = _decode_programs()
    assert tmain.to_dict() == jmain.to_dict()
    if level is not None:
        fluid.memory_optimize(jmain, level=level)
        tfl.memory_optimize(tmain, level=level)
    want = jcm.analyze_cost(jmain, fetch_names=fetch, feed_specs=specs)
    got = tcm.analyze_cost(tmain, fetch_names=fetch, feed_specs=specs)
    assert got == want
    assert 'while' in got['coverage']['waived']
    assert got['coverage']['no_verdict'] == ['create_array']
    assert tmm.analyze_memory(tmain, fetch, specs) == jmm.analyze_memory(
        jmain, fetch_names=fetch, feed_specs=specs)


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

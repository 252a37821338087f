"""ResNet through the port's Program / Executor (paddle_tpu_torch/models/
resnet.py) against the reference's (paddle_tpu/models/resnet.py), on the
CPU.

- Program parity: ``build_imagenet(depth=50)`` + ``MomentumOptimizer``
  (``bench.py``'s program) serialises to exactly the reference's main
  and startup programs, in both layouts and with both stems, the
  reference's quirk included: ``bias_attr=False`` is read as a learning
  rate of 0.0, so each of the 53 convs keeps a bias, scaled to lr 0 by
  one of 53 ``scale`` ops, and 214 ``momentum`` ops update 161 weights
  and the 53 biases.
- Training parity, with the harness of tests/test_torch_rnn.py: the
  reference builds and initialises, the port loads ``to_dict`` and every
  persistable (``scope_from_numpy``), both run 3 Momentum steps (lr 0.1,
  mu 0.9) on the same seeded batches: ``resnet_cifar10(depth=8)`` at
  32x32 NCHW and a ``layer_warp(bottleneck, ...)`` stack at 32x32 NHWC,
  B=4.  Compared: the loss and every gradient at each step; after the
  steps every parameter, velocity and BN running statistic.
- ``run_steps`` (K feeds, and one feed with ``repeat``) against K calls
  of ``run`` from the same state: fetches and state bitwise equal.
- ``clone(for_test=True)`` after training: batch_norm on the running
  statistics, which the evaluation leaves as they are; outputs against
  the reference's.

Tolerances.  Loss 1e-5 absolute (O(2) losses, float32).  Gradients 1e-4
of max(1e-2, the largest entry) per parameter: both sides sum conv and
BN reductions in other orders, and a relu whose input sits within float32
noise of 0 can flip, moving single entries by a whole contribution (the
largest gap measured was 5.8e-6 of its scale).  The
lr-0 conv biases (each before a batch_norm that subtracts its channel's
mean) have a gradient that is zero but for rounding on both
sides (both read up to 1.7e-7): held instead to 1e-5 absolute.  State
after 3 steps (parameters, velocities, running statistics): 1e-4
absolute (Momentum adds no amplifier; the largest gap measured was
3.7e-7).  Evaluation outputs 1e-5.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.models import resnet as jres

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.ops.kernels import dense_update as tdu

TOL_LOSS = 1e-5
TOL_GRAD_REL = 1e-4
TOL_ZERO_GRAD = 1e-5
TOL_STATE = 1e-4
TOL_EVAL = 1e-5
B = 4


def _imagenet(pkg, layout, stem):
    mod = jres if pkg is fluid else tres
    shape = (3, 224, 224) if layout == 'NCHW' else (224, 224, 3)
    return mod.build_imagenet(depth=50, image_shape=shape, layout=layout,
                              stem=stem)[3]


def _programs(pkg, model, seed=7):
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup):
            fetch = model(pkg)
            test = main.clone(for_test=True)
            pkg.optimizer.MomentumOptimizer(
                learning_rate=0.1, momentum=0.9).minimize(fetch[0])
    return main, startup, test, fetch


@pytest.mark.parametrize('layout,stem', [
    ('NCHW', '7x7'), ('NCHW', 'space_to_depth'), ('NHWC', '7x7'),
    ('NHWC', 'space_to_depth')])
def test_resnet50_serialises_to_the_reference_program(layout, stem):
    jm, js, _, _ = _programs(fluid, lambda p: (_imagenet(p, layout, stem),))
    tm, ts, _, _ = _programs(tfl, lambda p: (_imagenet(p, layout, stem),))
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    ops = [op.type for op in tm.global_block().ops]
    counts = {t: ops.count(t) for t in ('conv2d', 'batch_norm', 'scale',
                                        'momentum', 'pool2d', 'relu')}
    assert counts == dict(conv2d=53, batch_norm=53, scale=53, momentum=214,
                          pool2d=2, relu=49)
    init = [op.type for op in ts.global_block().ops]
    assert (init.count('fill_constant'), init.count('gaussian_random'),
            init.count('uniform_random')) == (481, 53, 1)
    zero_lr = [p for p in tm.all_parameters()
               if p.optimize_attr['learning_rate'] == 0.0]
    assert len(zero_lr) == 53 and all(p.name.startswith('conv2d')
                                      for p in zero_lr)


def _cifar8(pkg):
    mod = jres if pkg is fluid else tres
    img = pkg.layers.data(name='img', shape=[3, 32, 32], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    pred = mod.resnet_cifar10(img, depth=8)
    cost = pkg.layers.mean(x=pkg.layers.cross_entropy(input=pred,
                                                      label=label))
    return cost, pred


def _bottleneck_nhwc(pkg):
    mod = jres if pkg is fluid else tres
    img = pkg.layers.data(name='img', shape=[32, 32, 3], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    x = mod.conv_bn_layer(img, 16, 3, 2, 1, layout='NHWC')
    x = mod.layer_warp(mod.bottleneck, x, 16, 8, 2, 2, layout='NHWC')
    x = pkg.layers.pool2d(input=x, pool_size=8, pool_type='avg',
                          global_pooling=True, data_format='NHWC')
    pred = pkg.layers.fc(input=x, size=10, act='softmax')
    cost = pkg.layers.mean(x=pkg.layers.cross_entropy(input=pred,
                                                      label=label))
    return cost, pred


MODELS = {'cifar_depth8_nchw': (_cifar8, (3, 32, 32)),
          'bottleneck_stack_nhwc': (_bottleneck_nhwc, (32, 32, 3))}


def _batches(shape, n=3, seed=1):
    rng = np.random.default_rng(seed)
    return [{'img': rng.standard_normal((B,) + shape).astype(np.float32),
             'label': rng.integers(0, 10, (B, 1)).astype(np.int64)}
            for _ in range(n)]


def _setup(name):
    model, shape = MODELS[name]
    jmain, jstartup, jtest, jfetch = _programs(fluid, model)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    return dict(jmain=jmain, jtest=jtest, jscope=jscope, jexe=jexe,
                jfetch=jfetch, persist=persist, shape=shape,
                tmain=tfl.Program.from_dict(jmain.to_dict()),
                ttest=tfl.Program.from_dict(jtest.to_dict()))


def _zero_lr_biases(main):
    return {p.name for p in main.all_parameters()
            if p.optimize_attr['learning_rate'] == 0.0}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_momentum_steps_match_the_reference(name):
    h = _setup(name)
    tscope = scope_from_numpy(h['persist'], 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    params = [p.name for p in h['jmain'].all_parameters()]
    zero = _zero_lr_biases(h['jmain'])
    assert zero and zero < set(params)
    fetch = [h['jfetch'][0].name] + [p + '@GRAD' for p in params]
    losses = []
    for feed in _batches(h['shape']):
        want = h['jexe'].run(h['jmain'], feed=feed, fetch_list=fetch,
                             scope=h['jscope'])
        got = texe.run(h['tmain'], feed=feed, fetch_list=fetch,
                       scope=tscope)
        assert np.isfinite(got[0]).all()
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL_LOSS
        for pname, a, b in zip(params, got[1:], want[1:]):
            b = np.asarray(b)
            gap = np.abs(a - b).max()
            if pname in zero:
                assert gap <= TOL_ZERO_GRAD, pname
            else:
                assert gap <= TOL_GRAD_REL * max(1e-2, np.abs(b).max()), \
                    pname
        losses.append(float(got[0][0]))
    kinds = {'velocity': 0, 'mean': 0, 'var': 0}
    for n in h['persist']:
        a, b = tscope.get_numpy(n), np.asarray(h['jscope'].get(n))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL_STATE, n
        for k in kinds:
            kinds[k] += n.endswith('_' + k + '_0') or n.endswith('.' + k)
    # every parameter's velocity and every BN's running statistics
    assert kinds['velocity'] == len(params)
    assert kinds['mean'] == kinds['var'] > 0
    for n in h['persist']:
        if n.endswith('.mean'):   # moved off their init of 0
            assert np.abs(tscope.get_numpy(n)).max() > 0
    # the lr-0 biases kept their init, on both sides
    for n in zero:
        assert np.array_equal(tscope.get_numpy(n), h['persist'][n])
    assert tdu.launches == 0


def test_run_steps_is_bitwise_k_calls_of_run():
    h = _setup('cifar_depth8_nchw')
    feeds = _batches(h['shape'], n=3, seed=2)
    fetch = [h['jfetch'][0].name, 'conv2d_0.w_0@GRAD']
    runs = {}
    for mode in ('run', 'run_steps', 'repeat_run', 'repeat_run_steps'):
        scope = scope_from_numpy(h['persist'], 'cpu')
        exe = tfl.Executor(tfl.CPUPlace())
        h['tmain'].random_seed = 7
        if mode == 'run':
            outs = [exe.run(h['tmain'], feed=f, fetch_list=fetch,
                            scope=scope) for f in feeds]
            outs = [np.stack(z) for z in zip(*outs)]
        elif mode == 'run_steps':
            outs = exe.run_steps(h['tmain'], feed=feeds, fetch_list=fetch,
                                 scope=scope)
        elif mode == 'repeat_run':
            outs = [exe.run(h['tmain'], feed=feeds[0], fetch_list=fetch,
                            scope=scope) for _ in range(3)]
            outs = [np.stack(z) for z in zip(*outs)]
        else:
            outs = exe.run_steps(h['tmain'], feed=feeds[0],
                                 fetch_list=fetch, scope=scope, repeat=3)
        state = {n: scope.get_numpy(n) for n in h['persist']}
        runs[mode] = (outs, state, exe._step_count)
    for a, b in (('run', 'run_steps'), ('repeat_run', 'repeat_run_steps')):
        (oa, sa, ka), (ob, sb, kb) = runs[a], runs[b]
        assert ka == kb == 3
        for x, y in zip(oa, ob):
            assert x.shape == y.shape and x.shape[0] == 3
            assert np.array_equal(x, y)
        assert all(np.array_equal(sa[n], sb[n]) for n in sa)
    # the losses moved from step to step
    assert len(set(runs['run'][0][0].ravel().tolist())) == 3


def test_run_steps_checks_its_feeds():
    exe = tfl.Executor(tfl.CPUPlace())
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[2], dtype='float32')
        y = tfl.layers.mean(x=x)
    feed = {'x': np.ones((3, 2), np.float32)}
    with pytest.raises(ValueError, match='repeat'):
        exe.run_steps(main, feed=feed, fetch_list=[y])
    with pytest.raises(ValueError, match='repeat'):
        exe.run_steps(main, feed=[feed], fetch_list=[y], repeat=2)
    with pytest.raises(ValueError, match='key set'):
        exe.run_steps(main, feed=[feed, {'y': 1}], fetch_list=[y])
    assert exe.run_steps(main, feed=[], fetch_list=[y]) == []
    out, = exe.run_steps(main, feed=feed, fetch_list=[y], repeat=2,
                         scope=tfl.Scope())
    assert out.shape == (2, 1) and np.all(out == 1.0)


def test_test_clone_evaluates_on_the_running_statistics():
    h = _setup('cifar_depth8_nchw')
    tscope = scope_from_numpy(h['persist'], 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    feeds = _batches(h['shape'], n=2, seed=3)
    cost, pred = h['jfetch']
    for f in feeds:
        h['jexe'].run(h['jmain'], feed=f, fetch_list=[cost],
                      scope=h['jscope'])
        texe.run(h['tmain'], feed=f, fetch_list=[cost.name], scope=tscope)
    bn = [op for op in h['ttest'].global_block().ops
          if op.type == 'batch_norm']
    assert bn and all(op.attrs['is_test'] for op in bn)
    assert not any(op.type == 'momentum'
                   for op in h['ttest'].global_block().ops)
    before = {n: tscope.get_numpy(n).copy() for n in h['persist']}
    ev = _batches(h['shape'], n=1, seed=4)[0]
    want = h['jexe'].run(h['jtest'], feed=ev,
                         fetch_list=[cost.name, pred.name],
                         scope=h['jscope'])
    got = texe.run(h['ttest'], feed=ev, fetch_list=[cost.name, pred.name],
                   scope=tscope)
    for a, b in zip(got, want):
        assert np.abs(a - np.asarray(b)).max() <= TOL_EVAL
    # evaluation reads the running statistics and writes nothing back
    assert all(np.array_equal(tscope.get_numpy(n), before[n])
               for n in before)
    # a batch of one evaluates the same row as it does in the batch
    one, = texe.run(h['ttest'], feed={k: v[:1] for k, v in ev.items()},
                    fetch_list=[pred.name], scope=tscope)
    assert np.abs(one[0] - got[1][0]).max() <= TOL_EVAL

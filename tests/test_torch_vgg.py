"""VGG through the port's Program / Executor (paddle_tpu_torch/models/
vgg.py, nets.img_conv_group, the dropout op) against the reference's
(paddle_tpu/models/vgg.py), on the CPU.

- Program parity: ``vgg16_bn_drop`` under Adam and ``vgg_imagenet`` at
  depths 16 and 19, NCHW and NHWC, under Momentum (hw=32) serialise to
  exactly the reference's main and startup programs.
- Training parity, with the harness of tests/test_torch_resnet.py: the
  reference builds and initialises, the port loads every persistable
  (``scope_from_numpy``), both run 3 steps on the same seeded batches
  (B=4, 32x32), each step from the reference's state:
  ``vgg_imagenet(depth=16)`` in NHWC under Momentum 0.01 / 0.9
  (``benchmarks/bench_vgg.py``'s optimizer) and ``vgg16_bn_drop``
  under Adam 0.001 (the book's).  The two sides draw different dropout
  masks (Philox against Threefry), so the reference's ``Mask`` outputs
  are fetched each step and the port's ``dropout`` implementation is
  replaced, for the test only, by one that applies them.  Compared each
  step: the loss, every gradient, and after it every parameter,
  accumulator and BN running statistic.
- The VGG half of tests/book/test_image_classification.py, ported:
  ``vgg16_bn_drop`` on 256 synthetic CIFAR-10 samples in batches of 32,
  Adam 0.001, 3 epochs through ``batch`` and ``DataFeeder``; the cost of
  the ``clone(for_test=True)`` program (dropout off, BN on the running
  statistics) over the batches must fall.

Tolerances.  Loss 1e-5 absolute (O(2) losses, float32).  Gradients 1e-4
of max(1e-2, the largest entry) per parameter, the bound and reasons of
tests/test_torch_resnet.py: conv, fc and BN sums in other orders, and a
relu whose input sits within float32 noise of 0 can flip.  State after each
step: 1e-4 absolute under Momentum; 2e-4 under Adam, whose step is
lr * m / (sqrt(v) + eps), sign-like where a gradient sits near float32
noise of zero, so a last-bit difference there can move that entry by up
to 2 * lr (tests/test_torch_mnist.py).  A relu input within float32
noise of zero (1e-5 of its tensor's largest entry) can be gated one way
by one side and the other by the other: that element's whole gradient
moves, and with it every gradient below.  In ``vgg_imagenet``'s first
step one of the 8192 inputs of the last conv block's relus flips; below
it every gradient moved by 1.8% of its norm (1/sqrt(the ~4000 live
elements), 1.9% at most).  The test finds such relus (both sides' relu
inputs fetched), requires each flipped input to be float32 noise, and
lets the gradients and accumulators of the parameters below the last
one pass at 5e-2 of their norm instead; the rest keep the bounds above.
The biases added just before a batch_norm (``vgg16_bn_drop``'s convs and
fc1), whose channel mean the batch_norm subtracts, have a gradient that
is zero but for rounding on both sides (both read up to ~3e-7): held to
1e-5 absolute.  Adam's step is about lr * sign(g): where a gradient lies
within twice its bound of zero (those biases, dead channels) the two
sides may step either way, so those entries of a parameter are held to
2 * lr, the rest to the state bound.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.models import vgg as jvgg

import paddle_tpu_torch as tfl
from paddle_tpu_torch import datasets
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op_impl
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import vgg as tvgg

TOL_LOSS = 1e-5
TOL_GRAD_REL = 1e-4
TOL_STATE = {'momentum': 1e-4, 'adam': 2e-4}
TOL_ZERO_GRAD = 1e-5
TOL_FLIP_INPUT = 1e-5
TOL_FLIP = 5e-2
B = 4
LR = {'momentum': 0.01, 'adam': 0.001}


def _model(net, layout='NCHW', depth=16):
    def build(pkg):
        mod = jvgg if pkg is fluid else tvgg
        shape = [3, 32, 32] if layout == 'NCHW' else [32, 32, 3]
        img = pkg.layers.data(name='img', shape=shape, dtype='float32')
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        if net == 'vgg16_bn_drop':
            pred = mod.vgg16_bn_drop(img)
        else:
            pred = mod.vgg_imagenet(img, num_classes=10, depth=depth,
                                    layout=layout)
        cost = pkg.layers.mean(x=pkg.layers.cross_entropy(input=pred,
                                                          label=label))
        return cost, pred
    return build


def _programs(pkg, build, opt, seed=7):
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup):
            fetch = build(pkg)
            test = main.clone(for_test=True)
            if opt == 'adam':
                pkg.optimizer.AdamOptimizer(
                    learning_rate=LR['adam']).minimize(fetch[0])
            else:
                pkg.optimizer.MomentumOptimizer(
                    learning_rate=LR['momentum'],
                    momentum=0.9).minimize(fetch[0])
    return main, startup, test, fetch


@pytest.mark.parametrize('net,layout,depth', [
    ('vgg16_bn_drop', 'NCHW', 16), ('vgg_imagenet', 'NCHW', 16),
    ('vgg_imagenet', 'NHWC', 16), ('vgg_imagenet', 'NCHW', 19),
    ('vgg_imagenet', 'NHWC', 19)])
def test_vgg_serialises_to_the_reference_program(net, layout, depth):
    opt = 'adam' if net == 'vgg16_bn_drop' else 'momentum'
    build = _model(net, layout, depth)
    jm, js, jt, _ = _programs(fluid, build, opt)
    tm, ts, tt, _ = _programs(tfl, build, opt)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert tt.to_dict() == jt.to_dict()
    ops = [op.type for op in tm.global_block().ops]
    convs = 13 if depth == 16 else 16
    if net == 'vgg16_bn_drop':
        want = dict(conv2d=13, batch_norm=14, dropout=10, pool2d=5, adam=60)
    else:
        want = dict(conv2d=convs, batch_norm=0, dropout=2, pool2d=5,
                    momentum=2 * convs + 6)
    assert {k: ops.count(k) for k in want} == want


def _dropout_masks(main):
    """{op position: Mask name} of the main program's dropout ops."""
    return {i: op.output('Mask')[0]
            for i, op in enumerate(main.global_block().ops)
            if op.type == 'dropout'}


def _replaying(masks_now):
    """A dropout compute that applies the masks of ``masks_now()`` (by
    the op's position) in training and keeps the op's other modes."""
    plain = get_op_impl('dropout').compute

    def compute(ctx, ins, attrs):
        if attrs.get('is_test', False) or attrs.get('dropout_prob') == 0:
            return plain(ctx, ins, attrs)
        x = ins['X'][0]
        m = torch.from_numpy(masks_now()[ctx.op_index]).to(x.dtype)
        return {'Out': [x * m], 'Mask': [m]}
    return compute


def _batches(shape, n=3, seed=1):
    rng = np.random.default_rng(seed)
    return [{'img': rng.standard_normal((B,) + shape).astype(np.float32),
             'label': rng.integers(0, 10, (B, 1)).astype(np.int64)}
            for _ in range(n)]


def _flipped_below(ops, relu_ins, got, want):
    """The parameters whose gradient passes through a relu that the two
    sides gate differently.  Each such relu input must sit within float32
    noise of zero (``TOL_FLIP_INPUT`` of its tensor's largest entry): a
    flip moves that one element's whole gradient, and everything below it
    carries the change.  Returns the names of the parameters read by ops
    before the last flipped relu."""
    last = -1
    for name, a, b in zip(relu_ins, got, want):
        b = np.asarray(b)
        flip = (a > 0) != (b > 0)
        if flip.any():
            assert np.abs(b[flip]).max() <= TOL_FLIP_INPUT * np.abs(b).max()
            last = max(last, next(i for i, op in enumerate(ops)
                                  if op.type == 'relu' and
                                  op.input('X')[0] == name))
    return {n for op in ops[:last] for n in op.input_arg_names}


@pytest.mark.parametrize('net,layout,opt', [
    ('vgg_imagenet', 'NHWC', 'momentum'),
    ('vgg16_bn_drop', 'NCHW', 'adam')])
def test_steps_match_the_reference(monkeypatch, net, layout, opt):
    build = _model(net, layout)
    jm, js, _, jfetch = _programs(fluid, build, opt)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    persist = [v.name for v in jm.list_vars()
               if v.persistable and jscope.has(v.name)]
    tm = tfl.Program.from_dict(jm.to_dict())
    texe = tfl.Executor('cpu')
    ops = tm.global_block().ops
    masks = _dropout_masks(jm)
    now = {}
    monkeypatch.setattr(get_op_impl('dropout'), 'compute',
                        _replaying(lambda: now))
    params = [p.name for p in jm.all_parameters()]
    owner = {op.input(slot)[0]: op.input('Param')[0] for op in ops
             for slot in ('Velocity', 'Moment1', 'Moment2')
             if op.type in ('momentum', 'adam') and op.input(slot)}
    relu_ins = [op.input('X')[0] for op in ops if op.type == 'relu']
    bn_ins = {op.input('X')[0] for op in ops if op.type == 'batch_norm'}
    pre_bn = {op.input('Y')[0] for op in ops
              if op.type == 'elementwise_add' and
              op.output('Out')[0] in bn_ins}
    fetch = [jfetch[0].name] + [p + '@GRAD' for p in params]
    shape = (3, 32, 32) if layout == 'NCHW' else (32, 32, 3)
    for feed in _batches(shape):
        # each step from the reference's state, so that a relu flip in
        # one step (below) does not carry into the next
        tscope = scope_from_numpy(
            {n: np.asarray(jscope.get(n)) for n in persist}, 'cpu')
        want = jexe.run(jm, feed=feed, fetch_list=fetch + relu_ins + list(
            masks.values()), scope=jscope)
        now.clear()
        now.update({i: np.asarray(m) for i, m in
                    zip(masks, want[len(fetch) + len(relu_ins):])})
        got = texe.run(tm, feed=feed, fetch_list=fetch + relu_ins,
                       scope=tscope)
        assert np.isfinite(got[0]).all()
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL_LOSS
        flipped = _flipped_below(ops, relu_ins, got[len(fetch):],
                                 want[len(fetch):])
        gtol = {}
        for pname, a, b in zip(params, got[1:], want[1:len(fetch)]):
            b = np.asarray(b)
            gtol[pname] = (b, TOL_GRAD_REL * max(1e-2, np.abs(b).max()))
            if pname in pre_bn:
                assert np.abs(a).max() <= TOL_ZERO_GRAD and \
                    np.abs(b).max() <= TOL_ZERO_GRAD, pname
                continue
            assert np.abs(a - b).max() <= gtol[pname][1] or (
                pname in flipped and _norm_rel(a, b) <= TOL_FLIP), pname
        for n in persist:
            a, b = tscope.get_numpy(n), np.asarray(jscope.get(n))
            gap = np.abs(a - b)
            if opt == 'adam' and n in gtol:
                # Adam's step is about lr * sign(g) where g sits near
                # zero: there the two sides may step either way
                g, tol = gtol[n]
                near0 = np.abs(g) <= 2 * tol
                assert gap[near0].max(initial=0) <= 2 * LR[opt] + \
                    TOL_STATE[opt], n
                gap = gap[~near0]
            assert gap.max(initial=0) <= TOL_STATE[opt] or (
                owner.get(n) in flipped and _norm_rel(a, b) <= TOL_FLIP), n
    # every dropout op drew a mask that dropped something
    assert all(0 < m.mean() < 1 for m in now.values()) and len(now) == (
        2 if net == 'vgg_imagenet' else 10)


def _norm_rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_book_vgg_eval_cost_falls():
    """tests/book/test_image_classification.py, its VGG half."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 9
    with tfl.program_guard(main, startup):
        images = tfl.layers.data(name='pixel', shape=[3, 32, 32],
                                 dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        predict = tvgg.vgg16_bn_drop(images)
        avg_cost = tfl.layers.mean(
            x=tfl.layers.cross_entropy(input=predict, label=label))
        test_prog = main.clone(for_test=True)
        tfl.optimizer.AdamOptimizer(learning_rate=0.001).minimize(avg_cost)
    place = tfl.CPUPlace()
    exe, scope = tfl.Executor(place), tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=place, feed_list=[images, label],
                            program=main)
    batches = list(tfl.batch(tfl.reader.firstn(datasets.cifar.train10(),
                                               256),
                             batch_size=32, drop_last=True)())

    def eval_cost():
        return float(np.mean([
            exe.run(test_prog, feed=feeder.feed(b), fetch_list=[avg_cost],
                    scope=scope)[0][0] for b in batches]))

    pre = eval_cost()
    costs = [float(exe.run(main, feed=feeder.feed(b),
                           fetch_list=[avg_cost], scope=scope)[0][0])
             for _ in range(3) for b in batches]
    assert np.all(np.isfinite(costs))
    post = eval_cost()
    assert post < pre, (pre, post)

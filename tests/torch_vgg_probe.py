"""CPU probes of chip_smoke.py's VGG phases, at sizes this machine takes.

    python tests/torch_vgg_probe.py loss [batch] [hw] [steps]
    python tests/torch_vgg_probe.py book [batches] [epochs] [batch] [seed]
    JAX_PLATFORMS=cpu python tests/torch_vgg_probe.py conditioning [batch]
    JAX_PLATFORMS=cpu python tests/torch_vgg_probe.py loss_reference \
        [batch] [hw] [steps]
    JAX_PLATFORMS=cpu python tests/torch_vgg_probe.py book_reference \
        [batches] [epochs] [batch]
    JAX_PLATFORMS=cpu python tests/torch_vgg_probe.py flip

- ``loss`` (defaults 4, 224, 24): the VGG-16 phase's program
  (``chip_smoke._vgg_programs``: ``bench_vgg.py``'s float32 row,
  Momentum 0.01 / 0.9) trained by ``run_steps`` on one batch of
  ``default_rng(0)`` normal images and integer labels at a reduced
  batch and image size; each step's loss and the means of the first and
  last four, the reading the card phase's loss check compares.  ~4 GB
  and a few minutes at the defaults on 4 threads.
- ``book`` (defaults 32, 3, 128, chip_smoke's seed): the book-VGG phase
  (``chip_smoke.book_vgg``: ``vgg16_bn_drop``, Adam 0.001) on the CPU;
  its training losses and its test clone's cost before training and
  after each epoch.  ~2 s a step at batch 128.
- ``conditioning`` (default batch 2): how far two float32
  implementations of one VGG-16 step at 224x224 drift apart: the
  reference (paddle_tpu on XLA) against the port (paddle_tpu_torch on
  torch, at 8 threads and at 1), from the reference's initial state, the
  reference's dropout masks applied to the port's step.  Per parameter
  in program order the norm-relative gap of its gradient, with the
  median and the worst: the yardstick for the gradient bound of the card
  phase's parity step.  A couple of minutes (the JAX compile most of it).
- ``loss_reference`` (defaults 4, 224, 6): ``loss``'s program built by
  the reference, initialised by it and copied to the port; both train on
  the same batch, the reference's dropout masks applied to the port's
  step; each step's loss on both sides.
- ``book_reference`` (defaults 32, 3, 128): ``book`` run by the
  reference (paddle_tpu on XLA) from its own initial state: its test
  clone's cost before training and after each epoch.
- ``flip``: the first step of tests/test_torch_vgg.py's ``vgg_imagenet``
  case (B=4, 32x32 NHWC): the relu inputs whose sign differs between the
  reference and the port, and each gradient's norm-relative gap.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as tfl  # noqa: E402


def loss(batch=4, hw=224, steps=24):
    torch.set_num_threads(4)
    c = dict(cs.VGG, B=batch, hw=hw)
    main_p, startup, cost = cs._vgg_programs(c)
    exe, scope = tfl.Executor('cpu'), tfl.Scope()
    exe.run(startup, scope=scope)
    feed = cs._image_feed(batch, 0, c)
    losses = []
    for _ in range(steps):
        out, = exe.run_steps(main_p, feed=feed, fetch_list=[cost],
                             scope=scope, repeat=1)
        losses.append(float(out.ravel()[0]))
        print("step %d loss %.4f" % (len(losses), losses[-1]), flush=True)
    print(json.dumps(dict(batch=batch, hw=hw, steps=steps, losses=losses,
                          first4_mean=sum(losses[:4]) / 4,
                          last4_mean=sum(losses[-4:]) / 4)))


def book(batches=32, epochs=3, batch=128, seed=cs.SEED):
    torch.set_num_threads(4)
    cs.SEED = seed
    res = cs.book_vgg(dict(cs.BOOK_VGG, batches=batches, epochs=epochs,
                           B=batch), 'cpu')
    print(json.dumps({k: res[k] for k in ('config', 'losses',
                                          'eval_costs', 'seconds')}))


def _norm_rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def conditioning(batch=2):
    import paddle_tpu as fluid
    from paddle_tpu.core import program as jprog
    from paddle_tpu.models import vgg as jvgg
    from paddle_tpu_torch.core.registry import get_op_impl
    from paddle_tpu_torch.core.scope import scope_from_numpy

    c = cs.VGG
    with jprog.reset_unique_name_guard():
        main_p, startup = fluid.Program(), fluid.Program()
        main_p.random_seed = startup.random_seed = cs.SEED
        with fluid.program_guard(main_p, startup):
            img = fluid.layers.data(name='img', shape=[c['hw'], c['hw'], 3],
                                    dtype='float32')
            label = fluid.layers.data(name='label', shape=[1],
                                      dtype='int64')
            pred = jvgg.vgg_imagenet(img, num_classes=c['classes'],
                                     depth=c['depth'], layout=c['layout'])
            cost = fluid.layers.mean(
                x=fluid.layers.cross_entropy(input=pred, label=label))
            fluid.optimizer.MomentumOptimizer(c['lr'], c['mu']).minimize(
                cost)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in main_p.list_vars()
               if v.persistable and jscope.has(v.name)}
    params = [p.name for p in main_p.all_parameters()]
    masks = cs._dropout_masks(main_p)
    feed = cs._image_feed(batch, cs.SEED + 40, c)
    fetch = [cost.name] + [n + '@GRAD' for n in params]
    want = jexe.run(main_p, feed=feed, fetch_list=fetch + list(
        masks.values()), scope=jscope)
    drawn = {i: torch.from_numpy(np.array(m))
             for i, m in zip(masks, want[len(fetch):])}
    impl = get_op_impl('dropout')

    def replay(ctx, ins, attrs):
        x = ins['X'][0]
        m = drawn[ctx.op_index].to(x.dtype)
        return {'Out': [x * m], 'Mask': [m]}

    impl.compute = replay
    tmain = tfl.Program.from_dict(main_p.to_dict())
    rows = {}
    for threads in (8, 1):
        torch.set_num_threads(threads)
        got = tfl.Executor('cpu').run(tmain, feed=feed, fetch_list=fetch,
                                      scope=scope_from_numpy(persist, 'cpu'))
        gaps = [(_norm_rel(a, np.asarray(b)), n)
                for n, a, b in zip(params, got[1:], want[1:len(fetch)])]
        rows[threads] = dict(
            loss_gap=abs(float(got[0][0]) - float(want[0][0])),
            grad_norm_rel={n: g for g, n in gaps},
            median=float(np.median([g for g, _ in gaps])),
            worst=max(gaps))
        print("port at %d threads vs reference: %s" % (threads, json.dumps(
            {k: v for k, v in rows[threads].items()
             if k != 'grad_norm_rel'})), flush=True)
    print(json.dumps(dict(batch=batch, runs=rows)))


def _replay(drawn):
    """Make the port's dropout apply ``drawn`` ({op position: mask})."""
    from paddle_tpu_torch.core.registry import get_op_impl

    def replay(ctx, ins, attrs):
        x = ins['X'][0]
        m = drawn[ctx.op_index].to(x.dtype)
        return {'Out': [x * m], 'Mask': [m]}
    get_op_impl('dropout').compute = replay


def loss_reference(batch=4, hw=224, steps=6):
    import paddle_tpu as fluid
    from paddle_tpu.core import program as jprog
    from paddle_tpu.models import vgg as jvgg
    from paddle_tpu_torch.core.scope import scope_from_numpy

    c = dict(cs.VGG, B=batch, hw=hw)
    with jprog.reset_unique_name_guard():
        main_p, startup = fluid.Program(), fluid.Program()
        main_p.random_seed = startup.random_seed = cs.SEED
        with fluid.program_guard(main_p, startup):
            img = fluid.layers.data(name='img', shape=[hw, hw, 3],
                                    dtype='float32')
            label = fluid.layers.data(name='label', shape=[1],
                                      dtype='int64')
            pred = jvgg.vgg_imagenet(img, num_classes=c['classes'],
                                     depth=c['depth'], layout=c['layout'])
            cost = fluid.layers.mean(
                x=fluid.layers.cross_entropy(input=pred, label=label))
            fluid.optimizer.MomentumOptimizer(c['lr'], c['mu']).minimize(
                cost)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    tscope = scope_from_numpy(
        {v.name: np.asarray(jscope.get(v.name)) for v in main_p.list_vars()
         if v.persistable and jscope.has(v.name)}, 'cpu')
    tmain, texe = tfl.Program.from_dict(main_p.to_dict()), tfl.Executor('cpu')
    masks = cs._dropout_masks(main_p)
    drawn = {}
    _replay(drawn)
    feed = cs._image_feed(batch, 0, c)
    rows = []
    for step in range(steps):
        want = jexe.run(main_p, feed=feed, fetch_list=[cost] + list(
            masks.values()), scope=jscope)
        drawn.update({i: torch.from_numpy(np.array(m))
                      for i, m in zip(masks, want[1:])})
        got, = texe.run(tmain, feed=feed, fetch_list=[cost.name],
                        scope=tscope)
        rows.append((float(want[0][0]), float(got[0])))
        print("step %d reference %.4f port %.4f" % ((step + 1,) + rows[-1]),
              flush=True)
    print(json.dumps(dict(batch=batch, hw=hw, losses=rows)))


def book_reference(batches=32, epochs=3, batch=128):
    import paddle_tpu as fluid
    from paddle_tpu import datasets
    from paddle_tpu.models import vgg as jvgg

    main_p, startup = fluid.Program(), fluid.Program()
    main_p.random_seed = startup.random_seed = cs.SEED
    with fluid.program_guard(main_p, startup):
        images = fluid.layers.data(name='pixel', shape=[3, 32, 32],
                                   dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        avg_cost = fluid.layers.mean(x=fluid.layers.cross_entropy(
            input=jvgg.vgg16_bn_drop(images), label=label))
        test_prog = main_p.clone(for_test=True)
        fluid.optimizer.AdamOptimizer(
            learning_rate=cs.BOOK_VGG['lr']).minimize(avg_cost)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feeder = fluid.DataFeeder(place=fluid.CPUPlace(),
                              feed_list=[images, label])
    data = list(fluid.batch(fluid.reader.firstn(
        datasets.cifar.train10(), batch * batches), batch_size=batch,
        drop_last=True)())

    def eval_cost():
        return float(np.mean([
            np.ravel(exe.run(test_prog, feed=feeder.feed(b),
                             fetch_list=[avg_cost], scope=scope)[0])[0]
            for b in data]))

    evals = [eval_cost()]
    for _ in range(epochs):
        for b in data:
            exe.run(main_p, feed=feeder.feed(b), fetch_list=[avg_cost],
                    scope=scope)
        evals.append(eval_cost())
        print("epoch %d eval cost %.4f" % (len(evals) - 1, evals[-1]),
              flush=True)
    print(json.dumps(dict(batch=batch, batches=batches, eval_costs=evals)))


def flip():
    import paddle_tpu as fluid
    from paddle_tpu_torch.core.scope import scope_from_numpy

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_vgg as tv

    jm, js, _, jfetch = tv._programs(fluid, tv._model(
        'vgg_imagenet', 'NHWC'), 'momentum')
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jm.list_vars() if v.persistable and jscope.has(v.name)}
    tm = tfl.Program.from_dict(jm.to_dict())
    masks = tv._dropout_masks(jm)
    params = [p.name for p in jm.all_parameters()]
    relu_ins = [op.input('X')[0] for op in tm.global_block().ops
                if op.type == 'relu']
    fetch = [jfetch[0].name] + [n + '@GRAD' for n in params] + relu_ins
    feed = tv._batches((32, 32, 3))[0]
    want = jexe.run(jm, feed=feed, fetch_list=fetch + list(masks.values()),
                    scope=jscope)
    _replay({i: torch.from_numpy(np.array(m))
             for i, m in zip(masks, want[len(fetch):])})
    got = tfl.Executor('cpu').run(tm, feed=feed, fetch_list=fetch,
                                  scope=scope_from_numpy(persist, 'cpu'))
    k = 1 + len(params)
    flips = {n: int(((a > 0) != (np.asarray(b) > 0)).sum())
             for n, a, b in zip(relu_ins, got[k:], want[k:len(fetch)])}
    print(json.dumps(dict(
        relu_inputs={n: int(np.asarray(b).size)
                     for n, b in zip(relu_ins, want[k:len(fetch)])},
        flips={n: f for n, f in flips.items() if f},
        grad_norm_rel={n: _norm_rel(a, np.asarray(b)) for n, a, b in
                       zip(params, got[1:k], want[1:k])})))


if __name__ == '__main__':
    {'loss': loss, 'book': book, 'conditioning': conditioning,
     'loss_reference': loss_reference, 'book_reference': book_reference,
     'flip': flip}[sys.argv[1]](*[int(a) for a in sys.argv[2:]])

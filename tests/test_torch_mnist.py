"""The book's image tests through the port (paddle_tpu_torch/models/
mnist.py, models/resnet.py, DataFeeder, batch, reader, datasets), on the
CPU.

- The port of tests/book/test_recognize_digits.py: the MLP and the
  convnet, Adam lr 0.003, batches of 64 from the synthetic MNIST through
  ``batch`` and ``DataFeeder``; the mean accuracy of the last 10 batches
  must pass the same 0.9 bar within 3 epochs.
- Three Adam steps of each net from the reference's initial state
  (programs built by both packages, equal as data; state copied by
  ``scope_from_numpy``) on the same DataFeeder batches: the loss and
  every gradient each step, every parameter and moment after.
- The port of the ResNet half of tests/book/test_image_classification.py:
  ``resnet_cifar10(depth=8)``, Adam lr 0.001, 256 synthetic CIFAR-10
  samples (``reader.firstn``) in batches of 32, 3 epochs; its own bars:
  finite costs, the mean of the last 4 below 2.0, their accuracy above
  0.6.

Tolerances: loss 1e-5 absolute (O(2), float32); gradients 1e-5 of
max(1e-2, the largest entry); parameters and moments after 3 steps 2e-4
absolute: Adam's step is lr * m / (sqrt(v) + eps), sign-like where a
gradient sits near float32 noise of zero, so a last-bit difference there
can move that entry's step by up to 2 * lr (the reasoning and bound of
tests/test_torch_train.py).
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as tfl
from paddle_tpu_torch import datasets
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import resnet as tres

TOL_LOSS = 1e-5
TOL_GRAD_REL = 1e-5
TOL_STATE = 2e-4


def _mnist_programs(pkg, nn_type):
    prog_mod, mod = (jprog, jmnist) if pkg is fluid else (tprog, tmnist)
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup):
            img, label, _, avg_cost, acc = mod.build(nn_type)
            pkg.optimizer.AdamOptimizer(learning_rate=0.003).minimize(
                avg_cost)
    return main, startup, img, label, avg_cost, acc


@pytest.mark.parametrize('nn_type', ['mlp', 'conv'])
def test_recognize_digits(nn_type):
    main, startup, img, label, avg_cost, acc = _mnist_programs(tfl,
                                                               nn_type)
    place = tfl.CPUPlace()
    exe = tfl.Executor(place)
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=place, feed_list=[img, label],
                            program=main)
    train_reader = tfl.batch(datasets.mnist.train(), batch_size=64,
                             drop_last=True)
    accs = []
    for epoch in range(3):
        for data in train_reader():
            cost_v, acc_v = exe.run(main, feed=feeder.feed(data),
                                    fetch_list=[avg_cost, acc], scope=scope)
            accs.append(float(np.ravel(acc_v)[0]))
        if np.mean(accs[-10:]) > 0.9:
            break
    assert np.mean(accs[-10:]) > 0.9, \
        "accuracy %.3f below threshold" % np.mean(accs[-10:])


@pytest.mark.parametrize('nn_type', ['mlp', 'conv'])
def test_adam_steps_match_the_reference(nn_type):
    jmain, jstartup, jimg, jlabel, jcost, jacc = _mnist_programs(fluid,
                                                                 nn_type)
    tmain, _, timg, tlabel, _, _ = _mnist_programs(tfl, nn_type)
    assert tmain.to_dict() == jmain.to_dict()
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    feeder = tfl.DataFeeder(place=tfl.CPUPlace(), feed_list=[timg, tlabel],
                            program=tmain)
    params = [p.name for p in jmain.all_parameters()]
    fetch = [jcost.name, jacc.name] + [p + '@GRAD' for p in params]
    batches = tfl.batch(tfl.reader.firstn(datasets.mnist.train(), 96),
                        batch_size=32)
    for data in batches():
        feed = feeder.feed(data)
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL_LOSS
        assert float(got[1][0]) == float(want[1][0])
        for name, a, b in zip(params, got[2:], want[2:]):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= TOL_GRAD_REL * max(
                1e-2, np.abs(b).max()), name
    for name in persist:
        a, b = tscope.get_numpy(name), np.asarray(jscope.get(name))
        assert np.abs(a - b).max() <= TOL_STATE, name
    assert sum(n.endswith('_moment1_0') for n in persist) == len(params)


def test_image_classification_resnet():
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 9
    with tfl.program_guard(main, startup):
        images = tfl.layers.data(name='pixel', shape=[3, 32, 32],
                                 dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        predict = tres.resnet_cifar10(images, depth=8)
        cost = tfl.layers.cross_entropy(input=predict, label=label)
        avg_cost = tfl.layers.mean(x=cost)
        acc = tfl.layers.accuracy(input=predict, label=label)
        tfl.optimizer.AdamOptimizer(learning_rate=0.001).minimize(avg_cost)
    place = tfl.CPUPlace()
    exe = tfl.Executor(place)
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=place, feed_list=[images, label],
                            program=main)
    reader = tfl.batch(tfl.reader.firstn(datasets.cifar.train10(), 256),
                       batch_size=32, drop_last=True)
    batches = list(reader())
    costs, accs = [], []
    for epoch in range(3):
        for batch in batches:
            c, a = exe.run(main, feed=feeder.feed(batch),
                           fetch_list=[avg_cost, acc], scope=scope)
            costs.append(float(np.ravel(c)[0]))
            accs.append(float(np.ravel(a)[0]))
    assert np.all(np.isfinite(costs))
    assert np.mean(costs[-4:]) < 2.0, (np.mean(costs[:4]),
                                       np.mean(costs[-4:]))
    assert np.mean(accs[-4:]) > 0.6, np.mean(accs[-4:])

"""What one gating decision does to a step's gradients: a relu whose
input sits at float32 noise of 0, or a max pool whose two largest inputs
do, can decide one way on one device and the other way on another.

``chip_smoke.py`` phase 33 measured it on VGG-16 (B=2, 224x224, an
H100): the card's gradients read 0.86% (worst parameter, norm-relative;
median 0.23%) from the CPU's; with the card's relu signs handed to the
CPU step 0.50% (median 3.0e-6); with its max-pool choices handed over
too, 9.7e-6 (median 1.3e-6).  The gap was the decisions, not the
arithmetic.

Here, on a small conv net on the CPU (conv-relu-conv-relu-maxpool-fc),
each decision is planted: the first relu's input nearest 0 gated the
other way, or the max of the pool window whose two largest (live) inputs
are closest taken from its runner-up.  Every weight gradient below the
planted op moves by a share of its norm that one element's whole
contribution makes (measured here: 7.7e-3 below the relu; 4.5e-3 and
2.3e-3 below the pool; held to 1e-3 to 0.2), while those above it move
only by what the forward's change makes, the flipped input's or the
switched pair's own small size (1.4e-6 above the relu, 6.3e-5 above the
pool; held to 1e-4).  The biases are left out: a switch moves a
gradient within its channel, so the channel's bias gradient barely
moves.  Unplanted, the replacement ops reproduce the plain ones
bitwise.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core.program import reset_unique_name_guard
from paddle_tpu_torch.core.registry import get_op_impl

BELOW = (1e-3, 0.2)
ABOVE = 1e-4


def _net():
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 3
    with reset_unique_name_guard(), tfl.program_guard(main, startup):
        img = tfl.layers.data(name='img', shape=[3, 16, 16],
                              dtype='float32')
        label = tfl.layers.data(name='label', shape=[1], dtype='int64')
        c1 = tfl.layers.conv2d(img, num_filters=8, filter_size=3,
                               padding=1, act='relu')
        c2 = tfl.layers.conv2d(c1, num_filters=8, filter_size=3,
                               padding=1, act='relu')
        p = tfl.layers.pool2d(c2, pool_size=2, pool_type='max',
                              pool_stride=2)
        pred = tfl.layers.fc(input=p, size=10, act='softmax')
        cost = tfl.layers.mean(
            x=tfl.layers.cross_entropy(input=pred, label=label))
        tfl.optimizer.SGDOptimizer(0.1).minimize(cost)
    return main, startup, cost


def _grads(plant=None, monkeypatch=None):
    """The step's gradients by parameter, with ``plant`` = ('relu' |
    'pool2d', fn) replacing that op's compute for the step."""
    main, startup, cost = _net()
    if plant is not None:
        monkeypatch.setattr(get_op_impl(plant[0]), 'compute', plant[1])
    scope = tfl.Scope()
    exe = tfl.Executor(tfl.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    feed = {'img': rng.normal(size=(2, 3, 16, 16)).astype(np.float32),
            'label': rng.integers(0, 10, (2, 1))}
    params = [p.name for p in main.all_parameters()]
    out = exe.run(main, feed=feed, scope=scope,
                  fetch_list=[cost] + [n + '@GRAD' for n in params])
    return dict(zip(params, out[1:]))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _first_relu(ctx, ins, attrs, flip):
    x = ins['X'][0]
    keep = x > 0
    if flip and ctx.op_index == _first_relu.index:
        i = torch.argmin(x.abs())
        keep.view(-1)[i] = ~keep.view(-1)[i]
    return {'Out': [x * keep]}


def _runner_up_pool(ctx, ins, attrs, switch):
    x = ins['X'][0]
    y, idx = F.max_pool2d(x, attrs['ksize'], attrs['strides'],
                          attrs['paddings'], return_indices=True)
    if switch:
        win = F.unfold(x.reshape(-1, 1, *x.shape[2:]), attrs['ksize'],
                       stride=attrs['strides'])
        top = torch.topk(win, 2, dim=1)
        # the closest pair that both passed their relu (a tie of zeros
        # routes a zero gradient either way)
        gap = torch.where(top.values[:, 1] > 0,
                          top.values[:, 0] - top.values[:, 1],
                          torch.tensor(float('inf'))).flatten()
        w = int(torch.argmin(gap))
        # the runner-up's flat position in its plane
        plane, col = divmod(w, win.shape[2])
        kh, kw = attrs['ksize']
        r, c = divmod(int(top.indices[plane, 1, col]), kw)
        oh, ow = divmod(col, y.shape[3])
        pos = (oh * attrs['strides'][0] + r) * x.shape[3] + \
            ow * attrs['strides'][1] + c
        idx = idx.clone()
        idx.view(-1, idx.shape[2] * idx.shape[3])[plane, col] = pos
    y = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
    return {'Out': [y]}


def _planted(kind, plant):
    """(the op compute that plants ``kind``'s decision when ``plant``,
    the number of parameters read before the planted op: the first relu,
    the pool)."""
    main, _, _ = _net()
    ops = main.global_block().ops
    at = next(i for i, op in enumerate(ops) if op.type == kind)
    _first_relu.index = at
    params = {p.name for p in main.all_parameters()}
    n_below = len({n for op in ops[:at] for n in op.input_arg_names} &
                  params)
    if kind == 'relu':
        return (lambda ctx, ins, attrs: _first_relu(ctx, ins, attrs,
                                                    plant)), n_below
    return (lambda ctx, ins, attrs: _runner_up_pool(ctx, ins, attrs,
                                                    plant)), n_below


@pytest.mark.parametrize('kind', ['relu', 'pool2d'])
def test_replacements_reproduce_the_plain_ops(kind, monkeypatch):
    plain = _grads()
    got = _grads((kind, _planted(kind, False)[0]), monkeypatch)
    for n in plain:
        assert np.array_equal(plain[n], got[n]), n


@pytest.mark.parametrize('kind', ['relu', 'pool2d'])
def test_one_planted_decision_moves_every_gradient_below_it(kind,
                                                            monkeypatch):
    """Planted at the first relu, the first conv's weight is below it;
    at the pool, both convs'."""
    plain = _grads()
    fn, n_below = _planted(kind, True)
    got = _grads((kind, fn), monkeypatch)
    order = list(plain)   # parameters in creation order, bottom up
    assert n_below == (2 if kind == 'relu' else 4)
    for n in order[:n_below]:
        if '.w_' in n:
            assert BELOW[0] <= _rel(got[n], plain[n]) <= BELOW[1], n
    for n in order[n_below:]:
        if '.w_' in n:
            assert _rel(got[n], plain[n]) <= ABOVE, n

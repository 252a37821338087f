"""The image benchmarks' models (paddle_tpu_torch/models/{smallnet,alexnet,
googlenet}.py) through the port's Program / Executor against the
reference's (paddle_tpu/models/), on the CPU.

- Program parity: each model with ``cross_entropy``, ``mean`` and
  ``MomentumOptimizer`` serialises to exactly the reference's main and
  startup programs, with its parameter count (SmallNet 10, AlexNet 16,
  GoogLeNet 116: one ``momentum`` op each).
- Training parity, with the harness of tests/test_torch_vgg.py, but for
  the initial state: the port's startup program (equal to the
  reference's, above) initialises, and the reference's scope takes every
  persistable from it (the reference's compile of GoogLeNet's startup
  program alone would take most of the test's time).  Both take
  Momentum steps (lr 0.01, mu 0.9) on the same seeded batches, B=2:
  SmallNet at 32x32 (two steps), AlexNet and GoogLeNet at 64x64 (one
  step; 64x64 is about the smallest input GoogLeNet's five stride-2
  stages take).  The two sides draw different
  dropout masks, so the reference's ``Mask`` outputs are fetched and the
  port's ``dropout`` is replaced, for the test only, by one that applies
  them.  Compared each step: the loss, every gradient, and after it
  every parameter and velocity.

Tolerances: the loss 1e-5 absolute (O(7) losses, float32); a gradient
1e-4 of max(1e-2, its largest entry) and the state after a step 1e-4
absolute, tests/test_torch_resnet.py's bounds: conv and fc sums in other
orders.  These nets have no batch norm to amplify rounding from the head
down, so the bounds hold with a wide margin (a relu input that sits
within float32 noise of 0 would show as one gradient entry off by a whole
contribution; none does at these seeds).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.models import alexnet as jalex
from paddle_tpu.models import googlenet as jgoog
from paddle_tpu.models import smallnet as jsmall

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op_impl
from paddle_tpu_torch.models import alexnet as talex
from paddle_tpu_torch.models import googlenet as tgoog
from paddle_tpu_torch.models import smallnet as tsmall

TOL_LOSS = 1e-5
TOL_GRAD_REL = 1e-4
TOL_STATE = 1e-4
B = 2
# name: (reference module, port module, model function, hw, classes,
# parameter tensors, dropout ops, steps)
MODELS = {
    'smallnet': (jsmall, tsmall, 'smallnet', 32, 10, 10, 0, 2),
    'alexnet': (jalex, talex, 'alexnet', 64, 1000, 16, 2, 1),
    'googlenet': (jgoog, tgoog, 'googlenet', 64, 1000, 116, 1, 1),
}


def _programs(pkg, name, seed=7):
    jmod, tmod, fn, hw, classes = MODELS[name][:5]
    mod = jmod if pkg is fluid else tmod
    with (jprog if pkg is fluid else tprog).reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup):
            img = pkg.layers.data(name='img', shape=[3, hw, hw],
                                  dtype='float32')
            label = pkg.layers.data(name='label', shape=[1], dtype='int64')
            pred = getattr(mod, fn)(img, classes)
            cost = pkg.layers.mean(x=pkg.layers.cross_entropy(input=pred,
                                                              label=label))
            pkg.optimizer.MomentumOptimizer(
                learning_rate=0.01, momentum=0.9).minimize(cost)
    return main, startup, cost


@pytest.mark.parametrize('name', sorted(MODELS))
def test_model_serialises_to_the_reference_program(name):
    jm, js, _ = _programs(fluid, name)
    tm, ts, _ = _programs(tfl, name)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    ops = [op.type for op in tm.global_block().ops]
    n_params, n_drop = MODELS[name][5:7]
    assert len(tm.all_parameters()) == n_params
    assert ops.count('momentum') == n_params
    assert ops.count('dropout') == n_drop


def _replaying(masks_now):
    """A dropout compute that applies the masks of ``masks_now()`` (by
    the op's position)."""
    def compute(ctx, ins, attrs):
        x = ins['X'][0]
        m = torch.tensor(masks_now()[ctx.op_index]).to(x.dtype)
        return {'Out': [x * m], 'Mask': [m]}
    return compute


@pytest.mark.parametrize('name', sorted(MODELS))
def test_momentum_steps_match_the_reference(monkeypatch, name):
    hw, classes, _, _, steps = MODELS[name][3:]
    jm, _, jcost = _programs(fluid, name)
    tm, ts, _ = _programs(tfl, name)
    tscope, texe = tfl.Scope(), tfl.Executor('cpu')
    texe.run(ts, scope=tscope)
    persist = [v.name for v in tm.list_vars()
               if v.persistable and tscope.has(v.name)]
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    for n in persist:
        jscope.set(n, jnp.asarray(tscope.get_numpy(n)))
    masks = {i: op.output('Mask')[0]
             for i, op in enumerate(jm.global_block().ops)
             if op.type == 'dropout'}
    now = {}
    monkeypatch.setattr(get_op_impl('dropout'), 'compute',
                        _replaying(lambda: now))
    params = [p.name for p in jm.all_parameters()]
    fetch = [jcost.name] + [p + '@GRAD' for p in params]
    rng = np.random.default_rng(3)
    for _ in range(steps):
        feed = {'img': rng.standard_normal((B, 3, hw, hw)).astype(
                    np.float32),
                'label': rng.integers(0, classes, (B, 1)).astype(np.int64)}
        want = jexe.run(jm, feed=feed, fetch_list=fetch + list(
            masks.values()), scope=jscope)
        now.clear()
        now.update({i: np.asarray(m) for i, m in
                    zip(masks, want[len(fetch):])})
        got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        assert np.isfinite(got[0]).all()
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL_LOSS
        for pname, a, b in zip(params, got[1:], want[1:len(fetch)]):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= TOL_GRAD_REL * max(
                1e-2, np.abs(b).max()), pname
        for n in persist:
            assert np.abs(tscope.get_numpy(n) - np.asarray(
                jscope.get(n))).max() <= TOL_STATE, n
    assert all(0 < m.mean() < 1 for m in now.values())

"""Rematerialization in the port (``memory_optimize(level=...)``,
paddle_tpu_torch/core/executor.py ``_Region``) on the CPU.

- Levels None, 'dots' and 'full' give bitwise-equal losses, gradients
  and updated state for one step from the same state, on a small
  transformer (flash attention, the fused vocab head), a depth-18 ResNet
  at 32x32 (batch norm's custom backward; float32 NCHW, and bench.py's
  default bfloat16 NHWC build), seq2seq with
  ``is_sparse`` embeddings (their outputs are the gradient pass's frozen
  leaves; the SelectedRows gradients and the row-wise Adam), a dropout
  net (the recompute draws the same masks), an error-clip net and
  ``calc_gradient`` with respect to an intermediate; and the regions
  really recompute (every region's saved tensors come back from its
  rerun).
- 'dots' keeps the matmul-shaped ops, so flash attention runs once a
  step under 'dots' and twice under 'full' (its launches are counted on
  the card; here its op calls); 'full' places its cuts where the
  modelled backward memory is least.
- One remat step against the reference's remat step (``jax.checkpoint``
  over its gradient pass), from the reference's state: the transformer
  at tests/test_torch_train.py's bounds (loss 1e-5, Adam's parameters
  2e-4), the error-clip net and ``calc_gradient`` at
  tests/test_torch_calc_gradient.py's (1e-5 of the largest entry).
- A planted fault, a recompute that draws a different dropout mask,
  fails the bitwise comparison.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.datasets import wmt14
from paddle_tpu_torch.models import resnet as tres, seq2seq as ts2s

LEVELS = (None, 'dots', 'full')
TOL_LOSS = 1e-5
TOL_ADAM = 2e-4
TOL_CALC = 1e-5


@pytest.fixture(autouse=True)
def _fresh_names():
    with jprog.reset_unique_name_guard(), tprog.reset_unique_name_guard():
        yield


def _transformer(pkg):
    src, target, cost = (jtr if pkg is fluid else __import__(
        'paddle_tpu_torch.models.transformer', fromlist=['x'])).build(
            vocab_size=64, seq_len=16, n_layers=2, d_model=32, n_heads=4)
    pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(cost)
    return [cost]


def _transformer_feed(rng):
    src = rng.integers(1, 64, (2, 16)).astype(np.int64)
    return {'src': src, 'target': np.roll(src, -1, axis=1)[..., None]}


def _resnet(layout):
    def build(pkg):
        nhwc = layout == 'NHWC'   # bench.py's default build: bf16 NHWC
        img, label, _, cost, _ = tres.build_imagenet(
            18, 10, (32, 32, 3) if nhwc else (3, 32, 32),
            dtype='bfloat16' if nhwc else 'float32', layout=layout)
        pkg.optimizer.MomentumOptimizer(0.1, 0.9).minimize(cost)
        return [cost]
    return build


def _resnet_feed(layout):
    def feed(rng):
        shape = (2, 3, 32, 32) if layout == 'NCHW' else (2, 32, 32, 3)
        return {'img': rng.standard_normal(shape).astype(np.float32),
                'label': rng.integers(0, 10, (2, 1))}
    return feed


def _seq2seq(pkg):
    cost = ts2s.build(60, word_dim=8, hidden_dim=8)[4]
    pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(cost)
    return [cost]


def _seq2seq_feed(rng):
    return wmt14.batch(rng, 60, [5, 3, 7])


def _dropout(pkg):
    x = pkg.layers.data(name='x', shape=[16], dtype='float32')
    h = pkg.layers.fc(input=x, size=32, act='relu')
    h = pkg.layers.dropout(h, dropout_prob=0.5)
    h = pkg.layers.fc(input=h, size=32, act='tanh')
    h = pkg.layers.dropout(h, dropout_prob=0.3)
    loss = pkg.layers.mean(x=pkg.layers.square(
        x=pkg.layers.fc(input=h, size=1)))
    pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return [loss]


def _mlp_feed(rng):
    return {'x': rng.standard_normal((8, 16)).astype(np.float32)}


def _error_clip(pkg):
    x = pkg.layers.data(name='x', shape=[16], dtype='float32')
    h = pkg.layers.fc(input=x, size=32, act='tanh')
    h.error_clip = pkg.clip.ErrorClipByValue(max=1e-3, min=-1e-3)
    loss = pkg.layers.mean(x=pkg.layers.square(
        x=pkg.layers.fc(input=h, size=1)))
    pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return [loss]


def _calc_gradient(pkg):
    x = pkg.layers.data(name='x', shape=[16], dtype='float32')
    x.stop_gradient = False
    h1 = pkg.layers.fc(input=x, size=8, act='tanh')
    h2 = pkg.layers.fc(input=h1, size=5, act='relu')
    loss = pkg.layers.mean(x=pkg.layers.square(
        x=pkg.layers.fc(input=h2, size=2)))
    return list(pkg.backward.calc_gradient(loss, [h1, x])) + [loss]


CASES = {
    'transformer': (_transformer, _transformer_feed),
    'resnet18_nchw': (_resnet('NCHW'), _resnet_feed('NCHW')),
    'resnet18_bf16_nhwc': (_resnet('NHWC'), _resnet_feed('NHWC')),
    'seq2seq_sparse': (_seq2seq, _seq2seq_feed),
    'dropout': (_dropout, _mlp_feed),
    'error_clip': (_error_clip, _mlp_feed),
    'calc_gradient': (_calc_gradient, _mlp_feed),
}


def _port_program(build, level):
    with tprog.reset_unique_name_guard():
        main, startup = tfl.Program(), tfl.Program()
        main.random_seed = startup.random_seed = 11
        with tfl.program_guard(main, startup):
            fetch = build(tfl)
    if level is not None:
        tfl.memory_optimize(main, level=level)
    return main, startup, fetch


def _port_step(case, level, state=None, monkeypatch=None):
    """One step of ``case`` at ``level`` from ``state`` (the startup's
    when None): (fetched loss and gradients, state after the step,
    state before, regions recomputed)."""
    build, make_feed = CASES[case]
    main, startup, fetch = _port_program(build, level)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)   # the step counter keys the masks
    if state is None:
        state = {n: scope.get_numpy(n).copy()
                 for n in scope.local_var_names()}
    else:
        scope_from_numpy(state, 'cpu', scope)
    names = [v.name for v in fetch] + sorted(
        v.name for v in main.list_vars() if v.name.endswith('@GRAD'))
    recomputes = [0]
    if monkeypatch is not None:
        real = texec._Region.recompute

        def counted(region):
            recomputes[0] += 1
            return real(region)
        monkeypatch.setattr(texec._Region, 'recompute', counted)
    out = exe.run(main, feed=make_feed(np.random.default_rng(3)),
                  fetch_list=names, scope=scope)
    fetched = {}
    for n, v in zip(names, out):
        if v.dtype == object:   # a SelectedRows gradient
            rows = v.item()
            v = np.concatenate([np.asarray(rows.rows, np.float64)[:, None],
                                np.asarray(rows.values, np.float64)
                                .reshape(len(rows.rows), -1)], axis=1)
        fetched[n] = v
    after = {n: scope.get_numpy(n).copy() for n in state}
    return fetched, after, state, recomputes[0]


def _assert_bitwise(a, b, what):
    assert set(a) == set(b)
    for n in a:
        assert np.array_equal(a[n], b[n]), (what, n)


@pytest.mark.parametrize('case', sorted(CASES))
def test_levels_are_bitwise_equal(case, monkeypatch):
    want, want_state, state, _ = _port_step(case, None)
    assert want_state != {} and len(want) >= 2
    for level in ('dots', 'full'):
        got, got_state, _, recomputes = _port_step(case, level, state,
                                                   monkeypatch)
        _assert_bitwise(got, want, level)
        _assert_bitwise(got_state, want_state, level)
        assert recomputes > 0, level


def test_dots_keeps_flash_attention_and_full_recomputes_it(monkeypatch):
    calls = []
    impl = treg.get_op_impl('flash_attention')
    real = impl.compute

    def counted(ctx, ins, attrs):
        if ins['Q'][0].device.type != 'meta':   # not shape inference
            calls.append(1)
        return real(ctx, ins, attrs)

    monkeypatch.setattr(impl, 'compute', counted)
    per_level = {}
    state = None
    for level in LEVELS:
        del calls[:]
        _, _, state, _ = _port_step('transformer', level, state)
        per_level[level] = len(calls)
    assert per_level == {None: 2, 'dots': 2, 'full': 4}


def test_plan_units_follow_the_cost_class():
    main, _, _ = _port_program(_transformer, 'dots')
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(_port_program(_transformer, None)[1], scope=scope)
    exe.run(main, feed=_transformer_feed(np.random.default_rng(0)),
            fetch_list=[], scope=scope)
    plan, = [p for p in exe._plans.values()
             if getattr(p, 'remat', None) == 'dots']
    for kind, ops, *_ in plan.units:
        macs = [treg.cost_class(op.type) == 'mac' for _, op in ops]
        assert (kind == 'keep') == all(macs) and (
            kind == 'keep' or not any(macs))
    main_f, _, _ = _port_program(_transformer, 'full')
    exe.run(main_f, feed=_transformer_feed(np.random.default_rng(0)),
            fetch_list=[], scope=scope)
    plan_f, = [p for p in exe._plans.values()
               if getattr(p, 'remat', None) == 'full']
    # 'full': the cuts minimise the modelled backward memory (the values
    # crossing the cuts plus the largest region's outputs), at least as
    # well as sqrt(n) regions of equal op count would
    ops = [op for _, op in plan_f.fwd]
    size = texec._value_bytes(plan_f.program, 2)
    starts = [0]
    for _, region, *_ in plan_f.units[:-1]:
        starts.append(starts[-1] + len(region))
    assert all(kind == 'region' for kind, *_ in plan_f.units)
    assert 2 <= len(starts) < len(ops)
    n = len(ops)
    even = list(range(0, n, int(np.ceil(n / np.ceil(np.sqrt(n))))))
    assert _modelled(ops, size, starts) <= _modelled(ops, size, even)


def _modelled(ops, size, starts):
    """Bytes crossing the cuts ``starts`` plus the largest region's
    outputs, counted directly."""
    out = [sum(size.get(o, 0) for o in op.output_arg_names) for op in ops]
    ends = starts[1:] + [len(ops)]
    kept = 0
    for c in starts[1:]:
        before = {o for op in ops[:c] for o in op.output_arg_names}
        after = {i for op in ops[c:] for i in op.input_arg_names}
        kept += sum(size.get(name, 0) for name in before & after)
    return kept + max(sum(out[a:b]) for a, b in zip(starts, ends))


def test_a_recompute_with_another_mask_is_caught(monkeypatch):
    """The planted fault: every generator draw gets a fresh seed, so a
    region's recompute draws another dropout mask than its forward."""
    want, want_state, state, _ = _port_step('dropout', None)
    draws = [0]
    real = texec.ExecutionContext.generator

    def drifting(ctx, extra=0):
        draws[0] += 1
        return real(ctx, extra + draws[0])

    monkeypatch.setattr(texec.ExecutionContext, 'generator', drifting)
    got, got_state, _, _ = _port_step('dropout', 'dots', state)
    assert any(not np.array_equal(got[n], want[n]) for n in want
               if n.endswith('@GRAD'))
    monkeypatch.undo()
    # and the same fault without remat draws once a step: no gap there
    got2, _, _, _ = _port_step('dropout', 'dots', state)
    _assert_bitwise(got2, want, 'dots')


# -- against the reference's remat step --------------------------------

def _reference_step(build, level, make_feed, fetch_extra=True):
    with jprog.reset_unique_name_guard():
        jmain, jstartup = fluid.Program(), fluid.Program()
        jmain.random_seed = jstartup.random_seed = 11
        with fluid.program_guard(jmain, jstartup):
            fetch = build(fluid)
    jscope = fluid.core.scope.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name))
             for v in jmain.list_vars()
             if v.persistable and jscope.find_var(v.name) is not None}
    fluid.memory_optimize(jmain, level=level)
    names = [v.name for v in fetch]
    feed = make_feed(np.random.default_rng(3))
    want = [np.asarray(a) for a in jexe.run(jmain, feed=feed,
                                            fetch_list=names, scope=jscope)]
    after = {n: np.asarray(jscope.find_var(n)) for n in state}
    return names, state, want, after


@pytest.mark.parametrize('level', ['dots', 'full'])
@pytest.mark.parametrize('case', ['transformer', 'error_clip',
                                  'calc_gradient'])
def test_remat_step_matches_the_reference_remat_step(case, level):
    build, make_feed = CASES[case]
    names, state, want, want_after = _reference_step(build, level,
                                                     make_feed)
    got, got_after, _, _ = _port_step(case, level, state)
    for n, b in zip(names, want):
        a = got[n]
        assert a.shape == b.shape, n
        tol = (TOL_LOSS if a.size == 1 else
               TOL_CALC * max(1.0, float(np.abs(b).max())))
        assert np.abs(a - b).max() <= tol, n
    tol_state = TOL_ADAM if case == 'transformer' else TOL_CALC
    for n, b in want_after.items():
        assert np.abs(got_after[n] - b).max() <= tol_state, n


@pytest.mark.parametrize('level', ['dots', 'full'])
def test_regions_are_freed_as_the_backward_reads_them(monkeypatch, level):
    """A region lives while the backward still has to read what it saved
    (and while its outputs do), no longer: when the backward recomputes
    the first region, every later one is gone, and once the step returns
    all are, without the cyclic garbage collector.  A region kept to the
    end of the backward holds every region's inputs at once, which on the
    card raised the peak above the run without remat."""
    import gc
    import weakref
    refs, alive = [], []
    real_init = texec._Region.__init__
    real_recompute = texec._Region.recompute

    def init(region, *args):
        real_init(region, *args)
        refs.append(weakref.ref(region))

    def recompute(region):
        alive.append(sum(r() is not None for r in refs))
        return real_recompute(region)

    monkeypatch.setattr(texec._Region, '__init__', init)
    monkeypatch.setattr(texec._Region, 'recompute', recompute)
    gc.collect()
    gc.disable()
    try:
        _port_step('transformer', level)
        assert len(refs) >= 3 and all(r() is None for r in refs)
        assert alive[-1] <= 2 < alive[0], alive
    finally:
        gc.enable()


def _live_tensors():
    import gc
    return sum(1 for o in gc.get_objects() if isinstance(o, torch.Tensor))


@pytest.mark.parametrize('level', ['dots', 'full'])
def test_steps_leave_no_tensor_behind(level):
    """A rerun's graph, or a saved tensor holding its own producer, would
    keep each step's activations alive for good (a reference cycle through
    the autograd graph, which the collector cannot see): the count of live
    tensors after 3 steps equals that after 1."""
    main, startup, fetch = _port_program(_transformer, level)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feed = _transformer_feed(np.random.default_rng(0))
    counts = []
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        counts.append(_live_tensors())
    assert counts[2] == counts[0], counts

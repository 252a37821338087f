"""The executor's liveness (paddle_tpu_torch/core/executor.py): each
value leaves the environment after its last use unless it is fetched or
persistable, inside the gradient pass too, on the CPU.

- A ``weakref`` to an intermediate, taken by a monkeypatched op function
  where it is made, is dead when a later op runs after its last reader,
  in a plain run and inside the gradient pass (where autograd does not
  save it: ``scale``'s backward needs nothing, ``exp`` saves its output);
  it is alive at that point when the intermediate is fetched or
  persistable, and a persistable intermediate reaches the scope.
- A name written twice (an in-place ``sum``, ``increment``'s counter)
  stays until its last use; a forward output read by an op appended after
  ``minimize`` is published from the gradient pass; both packages give
  the same fetches for 3 steps from copied state.
- The ops the executor skips are those ``live_ops`` drops, as before.
- The plan (live ops, what to drop where) is worked out once per
  program version and fetch list; a program changed after a run gets a
  new one, a var made persistable after a run too.

Tolerances: 1e-5 absolute on the fetches and state (float32, O(1)
values through a tanh fc; XLA fuses and reorders what torch runs op by
op).
"""
import weakref

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.scope import scope_from_numpy

TOL = 1e-5


class _Probe(object):
    """Wraps op ``maker``'s compute to keep a weakref to its output, and
    op ``probe``'s to record whether that output was alive when it ran.
    Runs on meta tensors (the cost model's shape inference when a plan is
    made) are not runs of the program and are not recorded."""

    def __init__(self, monkeypatch, maker, probe):
        self.refs, self.alive = [], []
        impls = registry._OP_REGISTRY
        make_fn, probe_fn = impls[maker].compute, impls[probe].compute

        def make(ctx, ins, attrs):
            outs = make_fn(ctx, ins, attrs)
            if outs['Out'][0].device.type != 'meta':
                self.refs.append(weakref.ref(outs['Out'][0]))
            return outs

        def look(ctx, ins, attrs):
            if ins['X'][0].device.type != 'meta':
                self.alive.append(self.refs[-1]() is not None)
            return probe_fn(ctx, ins, attrs)

        monkeypatch.setattr(impls[maker], 'compute', make)
        monkeypatch.setattr(impls[probe], 'compute', look)


def _plain_program(persist_h=False):
    """x -> h = scale(x) -> exp(h) -> sqrt -> mean: exp is h's last
    reader, mean runs after it."""
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[4], dtype='float32')
        h = tfl.layers.scale(x=x, scale=0.5)
        out = tfl.layers.mean(x=tfl.layers.sqrt(x=tfl.layers.exp(x=h)))
    if persist_h:
        h.persistable = True
    return main, h, out


@pytest.mark.parametrize('mode', ['dropped', 'fetched', 'persistable'])
def test_an_intermediate_is_freed_after_its_last_reader(monkeypatch, mode):
    main, h, out = _plain_program(persist_h=mode == 'persistable')
    probe = _Probe(monkeypatch, 'scale', 'mean')
    scope = tfl.Scope()
    exe = tfl.Executor(tfl.CPUPlace())
    xv = np.arange(8, dtype=np.float32).reshape(2, 4)
    fetch = [out, h] if mode == 'fetched' else [out]
    got = exe.run(main, feed={'x': xv}, fetch_list=fetch, scope=scope)
    assert probe.alive == [mode != 'dropped']
    want = np.sqrt(np.exp(0.5 * xv)).mean()
    assert abs(float(got[0][0]) - want) <= 1e-5
    if mode == 'fetched':
        assert np.array_equal(got[1], 0.5 * xv)
    if mode == 'persistable':
        assert np.array_equal(scope.get_numpy(h.name), 0.5 * xv)
    else:
        assert not scope.has(h.name)


def _train_program(fetch_h=False):
    """x -> fc -> h = scale -> exp -> mean (the loss), SGD; inside the
    gradient pass exp is h's last reader and mean runs after it."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 3
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[4], dtype='float32')
        h = tfl.layers.scale(x=tfl.layers.fc(input=x, size=3), scale=0.1)
        loss = tfl.layers.mean(x=tfl.layers.exp(x=h))
        tfl.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, h, loss


@pytest.mark.parametrize('fetch_h', [False, True])
def test_the_gradient_pass_frees_what_autograd_does_not_save(monkeypatch,
                                                             fetch_h):
    main, startup, h, loss = _train_program()
    scope = tfl.Scope()
    exe = tfl.Executor(tfl.CPUPlace())
    exe.run(startup, scope=scope)
    probe = _Probe(monkeypatch, 'scale', 'mean')
    xv = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    fetch = [loss, h] if fetch_h else [loss]
    w = main.all_parameters()[0].name
    w0 = scope.get_numpy(w).copy()
    got = exe.run(main, feed={'x': xv}, fetch_list=fetch, scope=scope)
    assert probe.alive == [fetch_h]
    assert np.isfinite(got[0]).all()
    assert not np.array_equal(scope.get_numpy(w), w0)
    if fetch_h:
        assert got[1].shape == (5, 3)


def _twice_written(pkg):
    """A name written twice (an in-place sum), a step counter, and a
    forward output read by an op appended after minimize."""
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name='x', shape=[4], dtype='float32')
            h = pkg.layers.fc(input=x, size=4, act='tanh')
            pkg.layers.sums(input=[h, x], out=h)   # h written again
            loss = pkg.layers.mean(x=pkg.layers.square(x=h))
            step = pkg.layers.create_global_var(
                shape=[1], value=0.0, dtype='float32', persistable=True,
                name='step')
            pkg.layers.increment(x=step, value=1.0, in_place=True)
            pkg.optimizer.SGDOptimizer(0.2).minimize(loss)
            after = pkg.layers.reduce_sum(input=h)   # after minimize
    return main, startup, [loss, after, h, step]


def test_steps_with_names_written_twice_match_the_reference():
    jmain, jstartup, jfetch = _twice_written(fluid)
    tmain, _, tfetch = _twice_written(tfl)
    assert tmain.to_dict() == jmain.to_dict()
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.array(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tmain = tfl.Program.from_dict(jmain.to_dict())
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    rng = np.random.default_rng(2)
    names = [v.name for v in jfetch]
    for step in range(3):
        xv = rng.standard_normal((6, 4)).astype(np.float32)
        want = jexe.run(jmain, feed={'x': xv}, fetch_list=names,
                        scope=jscope)
        got = texe.run(tmain, feed={'x': xv}, fetch_list=names,
                       scope=tscope)
        for n, a, b in zip(names, got, want):
            assert np.abs(a - np.asarray(b)).max() <= TOL, n
        assert float(got[3][0]) == step + 1.0
        assert abs(float(got[1][0]) - float(got[2].sum())) <= 1e-5
    for n in persist:
        a, b = tscope.get_numpy(n), np.asarray(jscope.get(n))
        assert np.abs(a - b).max() <= TOL, n


def test_the_step_without_fetching_the_later_reader_skips_it():
    main, startup, fetch = _twice_written(tfl)
    scope = tfl.Scope()
    exe = tfl.Executor(tfl.CPUPlace())
    exe.run(startup, scope=scope)
    xv = np.ones((2, 4), np.float32)
    exe.run(main, feed={'x': xv}, fetch_list=[fetch[0]], scope=scope)
    assert [t for _, t in exe.skipped_ops] == ['reduce_sum']
    got = exe.run(main, feed={'x': xv}, fetch_list=[fetch[1]], scope=scope)
    assert exe.skipped_ops == [] and np.isfinite(got[0]).all()


def test_a_plan_is_kept_per_program_version():
    """The executor works out liveness once per (program, version,
    fetches): a second run reuses the plan; an op appended after a run
    bumps the version and gets a new plan that runs it."""
    main, h, out = _plain_program()
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    xv = np.ones((2, 4), np.float32)
    for _ in range(2):
        exe.run(main, feed={'x': xv}, fetch_list=[out], scope=scope)
    assert len(exe._plans) == 1
    version = main.version
    with tfl.program_guard(main, tfl.Program()):
        doubled = tfl.layers.scale(x=out, scale=2.0)
    assert main.version > version
    got = exe.run(main, feed={'x': xv}, fetch_list=[out, doubled],
                  scope=scope)
    assert len(exe._plans) == 2
    assert float(got[1][0]) == 2 * float(got[0][0])
    main.global_block().ops[0].set_attr('scale', 1.0)
    got2 = exe.run(main, feed={'x': xv}, fetch_list=[out], scope=scope)
    assert len(exe._plans) == 3
    assert abs(float(got2[0][0]) - np.sqrt(np.e)) <= 1e-5


def test_a_var_made_persistable_after_a_run_reaches_the_scope():
    """Flipping ``persistable`` on a built program after a run bumps its
    version: the next run keeps the var and writes it to the scope."""
    main, h, out = _plain_program()
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    xv = np.arange(8, dtype=np.float32).reshape(2, 4)
    exe.run(main, feed={'x': xv}, fetch_list=[out], scope=scope)
    assert not scope.has(h.name)
    version = main.version
    h.persistable = True
    assert main.version > version
    exe.run(main, feed={'x': xv}, fetch_list=[out], scope=scope)
    assert len(exe._plans) == 2
    assert np.array_equal(scope.get_numpy(h.name), 0.5 * xv)

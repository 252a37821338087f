"""Control flow, tensor arrays and their ops in the port
(paddle_tpu_torch/ops/{control_flow,tensor_array,misc}.py, the
executor's sub-blocks, layers/control_flow.py) against the reference, on
the CPU.

- Every new op but the beam-search ones (tests/test_torch_beam_search.py)
  against the reference's op on the same seeded numpy inputs: the
  tensor-array ops (an index past the capacity clamped, as the
  reference's ``dynamic_(update_)index_in_dim`` clamp it), ``print``,
  ``is_empty``, ``split_lod_tensor`` / ``merge_lod_tensor``, ``expand``,
  ``fill_zeros_like``, ``fill_constant_batch_size_like``, the logical
  ops, ``reorder_lod_tensor_by_rank`` (with ties) and ``log``.
- ``while``, ``conditional_block`` and ``recurrent`` through programs:
  the cases of tests/test_rnn_wrappers.py and tests/book/
  test_mnist_if_else.py, built by the reference, loaded through
  ``Program.to_dict`` and run from the reference's initial state, the
  fetches and three training steps' losses against the reference's; a
  ``while`` whose masked ticks write past an array's capacity; an array
  first written inside a loop that never runs (the zeroed buffer of size
  0, with and without ``max_iters`` ticks).
- ``op_traits`` equal across the packages for every op type the port
  registers (134 since the GAN's slice); ``parallel_do`` raising,
  citing ROADMAP item 10.
- Liveness: a value that only a ``while`` body reads survives until the
  loop runs (the executor counts a sub-block's reads as its op's).

Tolerances: float values 1e-6 absolute (float32, O(1) values); ints and
bools exact, dtypes equal; program fetches and losses 1e-5 absolute.
"""
import io
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import datasets as jdatasets
from paddle_tpu.core import registry as jreg
from paddle_tpu.ops import tensor_array as jta

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.ops import tensor_array as tta

TOL = 1e-6
TOL_RUN = 1e-5


class _Ctx(object):
    device = torch.device('cpu')


def _ref(op, ins, attrs):
    return jreg.get_op_impl(op).compute(
        None, {k: [_jax(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))


def _port(op, ins, attrs):
    return treg.get_op_impl(op).compute(
        _Ctx(), {k: [_torch(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))


def _jax(v):
    if isinstance(v, tuple):   # (data, size): a tensor array
        return jta.TArray(jnp.asarray(v[0]), jnp.asarray(v[1], jnp.int32))
    if isinstance(v, str):     # an empty array of this dtype
        return jta.EmptyTArray(v)
    return jnp.asarray(v)


def _torch(v):
    if isinstance(v, tuple):
        return tta.TArray(torch.tensor(v[0]),
                          torch.tensor(v[1], dtype=torch.int32))
    if isinstance(v, str):
        return tta.EmptyTArray(v)
    return torch.tensor(v)


def _host(v):
    """A port or reference value as numpy (arrays as (data, size))."""
    if isinstance(v, (jta.TArray, tta.TArray)):
        return ('array', _host(v.data), _host(v.size))
    if isinstance(v, (jta.EmptyTArray, tta.EmptyTArray)):
        return ('empty', v.dtype)
    return np.asarray(v)


def _same(a, b, tol=TOL):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and a[0] == b[0] and len(a) == len(b)
        for x, y in zip(a[1:], b[1:]):
            _same(x, y, tol)
        return
    if isinstance(a, str):
        assert a == b
        return
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.dtype.kind == 'f':
        assert np.abs(a - b).max(initial=0.0) <= tol
    else:
        assert np.array_equal(a, b)


def _check(op, ins, attrs, slots=('Out',)):
    got, want = _port(op, ins, attrs), _ref(op, ins, attrs)
    for slot in slots:
        _same(_host(got[slot][0]), _host(want[slot][0]))


_rng = np.random.default_rng(7)
X32 = _rng.standard_normal((4, 3, 2)).astype(np.float32)
ARR = (_rng.standard_normal((5, 3, 2)).astype(np.float32), 3)
LENS = np.array([3, 1, 3, 2], np.int32)

OP_CASES = [
    ('create_array', {}, {'elem_dtype': 'int64'}),
    ('create_array', {}, {'elem_dtype': 'float32', 'capacity': 4,
                          'elem_shape': [3, 2]}),
    ('write_to_array', {'Array': ['float32'], 'V': [X32[0]],
                        'I': [np.array([2], np.int64)]}, {'capacity': 5}),
    ('write_to_array', {'Array': ['float32'], 'V': [X32[0]],
                        'I': [np.array([0], np.int64)]}, {}),
    ('write_to_array', {'Array': [ARR], 'V': [X32[1]],
                        'I': [np.array([4], np.int64)]}, {}),
    # a masked while tick: the index past the capacity writes the last slot
    ('write_to_array', {'Array': [ARR], 'V': [X32[1]],
                        'I': [np.array([5], np.int64)]}, {}),
    ('write_to_array', {'X': [ARR], 'I': [np.array([1], np.int32)],
                        'V': [X32[2]]}, {}),
    ('read_from_array', {'Array': [ARR], 'I': [np.array([1], np.int64)]},
     {}),
    ('read_from_array', {'Array': [ARR], 'I': [np.array([7], np.int64)]},
     {}),
    ('read_from_array', {'X': [ARR], 'I': [np.array([-1], np.int64)]}, {}),
    ('array_length', {'X': [ARR]}, {}),
    ('lod_tensor_to_array', {'X': [X32]}, {}),
    ('array_to_lod_tensor', {'X': [ARR]}, {}),
    ('lod_rank_table', {'X': [X32], 'XLen': [LENS]}, {}),
    ('lod_rank_table', {'X': [X32]}, {}),
    ('max_sequence_len', {'RankTable': [LENS]}, {}),
    ('shrink_rnn_memory', {'X': [X32], 'RankTable': [LENS],
                           'I': [np.array([1], np.int64)]}, {}),
    ('print', {'In': [X32]}, {'message': 'x: '}),
    ('is_empty', {'X': [X32]}, {}),
    ('is_empty', {'X': [np.zeros((0, 3), np.float32)]}, {}),
    ('merge_lod_tensor', {'X': [X32], 'Mask': [np.array([1, 0, 0, 1],
                                                          np.int32)],
                          'InTrue': [X32], 'InFalse': [-X32]}, {}),
    ('expand', {'X': [X32[:, :1]]}, {'expand_times': [1, 4, 1]}),
    ('expand', {'X': [X32[0]]}, {'expand_times': [2]}),
    ('expand', {'X': [LENS.reshape(4, 1)]}, {'expand_times': [2, 3]}),
    ('fill_zeros_like', {'X': [X32]}, {}),
    ('fill_constant_batch_size_like', {'Input': [X32]},
     {'shape': [-1, 1], 'dtype': 'int64', 'value': 5.0}),
    ('fill_constant_batch_size_like', {'Input': [X32]},
     {'shape': [2, -1, 3], 'dtype': 'float32', 'value': 0.5,
      'input_dim_idx': 1, 'output_dim_idx': 1}),
    ('logical_and', {'X': [X32 > 0], 'Y': [X32 > 0.5]}, {}),
    ('logical_or', {'X': [X32 > 0], 'Y': [X32 > 0.5]}, {}),
    ('logical_xor', {'X': [X32 > 0], 'Y': [X32 > 0.5]}, {}),
    ('logical_not', {'X': [X32 > 0]}, {}),
    ('log', {'X': [np.abs(X32) + 0.1]}, {}),
]


@pytest.mark.parametrize('op,ins,attrs', OP_CASES,
                         ids=['%s_%d' % (c[0], i)
                              for i, c in enumerate(OP_CASES)])
def test_ops_match_the_reference(op, ins, attrs):
    with contextlib.redirect_stdout(io.StringIO()):
        _check(op, ins, attrs)


def test_split_outputs_and_reorder_by_rank_match_the_reference():
    mask = np.array([[1], [0], [0], [1]], bool)
    _check('split_lod_tensor', {'X': [X32], 'Mask': [mask]}, {},
           ('OutTrue', 'OutFalse'))
    table = np.array([2, 5, 2, 7, 5], np.int32)   # ties keep row order
    x = _rng.standard_normal((5, 4, 3)).astype(np.float32)
    _check('reorder_lod_tensor_by_rank', {'X': [x], 'RankTable': [table]},
           {}, ('Out', 'OutLen', 'OrderedIndex'))


def test_print_prints_the_message_and_passes_the_value():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = _port('print', {'In': [X32[0]]}, {'message': 'probe '})
    assert buf.getvalue().startswith('probe ')
    assert np.array_equal(got['Out'][0].numpy(), X32[0])


def test_op_traits_equal_the_reference_for_every_port_op():
    ops = treg.registered_ops()
    assert len(ops) == 190
    for t in ops:
        assert tuple(treg.op_traits(t)) == tuple(jreg.op_traits(t)), t
    for t in ('while', 'conditional_block', 'recurrent'):
        assert treg.op_traits(t).needs_env
    assert not treg.op_traits('parallel_do').registered


def test_parallel_do_raises_citing_item_10():
    with tfl.program_guard(tfl.Program(), tfl.Program()):
        with pytest.raises(NotImplementedError, match='item 10'):
            tfl.layers.ParallelDo()
    with pytest.raises(NotImplementedError, match='item 10'):
        treg.get_op_impl('parallel_do')


# -- programs built by the reference, run by both ------------------------

def _run_both(build, feeds, seed=5, steps=1):
    """``build()`` makes the reference's program under a program_guard
    and returns its fetch Variables (the first the loss when ``steps`` >
    1).  Both run ``steps`` steps from the reference's initial state on
    ``feeds`` (one dict, or one per step); returns (port, reference)
    fetches of every step."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        fetch_vars = build()
    names = [v.name for v in fetch_vars]
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in main.list_vars()
               if v.persistable and jscope.has(v.name)}
    tmain = tfl.Program.from_dict(main.to_dict())
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    got, want = [], []
    for k in range(steps):
        feed = feeds[k] if isinstance(feeds, list) else feeds
        want.append([np.asarray(v) for v in
                     jexe.run(main, feed=feed, fetch_list=names,
                              scope=jscope)])
        got.append(texe.run(tmain, feed=feed, fetch_list=names,
                            scope=tscope))
    return got, want


def _agree(got, want, tol=TOL_RUN):
    for g_step, w_step in zip(got, want):
        for a, b in zip(g_step, w_step):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, (a.shape, b.shape)
            if a.dtype.kind == 'f':
                assert np.abs(a - b).max(initial=0.0) <= tol
            else:
                assert np.array_equal(a, b)


def test_static_rnn_accumulator_matches_the_reference():
    def build():
        x = fluid.layers.data(name='x', shape=[5, 3], dtype='float32')
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[-1, 3], batch_ref=x)
            acc = fluid.layers.elementwise_add(x=mem, y=xt)
            rnn.update_memory(mem, acc)
            rnn.step_output(acc)
        return [rnn()]
    xv = np.random.RandomState(0).randn(2, 5, 3).astype('float32')
    got, want = _run_both(build, {'x': xv})
    _agree(got, want)
    assert np.abs(got[0][0] - np.cumsum(xv, axis=1)).max() <= TOL_RUN


def test_static_rnn_with_params_trains_as_the_reference():
    def build():
        x = fluid.layers.data(name='x', shape=[6, 4], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[-1, 8], batch_ref=x)
            h = fluid.layers.fc(input=[xt, mem], size=8, act='tanh')
            rnn.update_memory(mem, h)
            rnn.step_output(h)
        hs = rnn()
        last = fluid.layers.sequence_last_step(input=hs)
        pred = fluid.layers.fc(input=last, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
        return [loss, hs]
    r = np.random.RandomState(1)
    feed = {'x': r.randn(4, 6, 4).astype('float32'),
            'y': r.randn(4, 1).astype('float32')}
    got, want = _run_both(build, feed, steps=3)
    _agree(got, want)
    losses = [float(np.ravel(g[0])[0]) for g in got]
    assert losses[-1] < losses[0]


def test_dynamic_rnn_masks_ragged_rows_as_the_reference():
    def build():
        x = fluid.layers.data(name='x', shape=[2], dtype='float32',
                              lod_level=1)
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x)
            mem = drnn.memory(shape=[2])
            acc = fluid.layers.elementwise_add(x=mem, y=xt)
            drnn.update_memory(mem, acc)
            drnn.output(acc)
        out = drnn()
        return [out, fluid.layers.sequence_last_step(input=out)]
    xv = np.random.RandomState(3).rand(3, 4, 2).astype('float32')
    got, want = _run_both(build, {'x': (xv, np.array([4, 2, 1], 'int32'))})
    _agree(got, want)
    assert np.all(got[0][0][1, 2:] == 0)


def _cond_program(with_training):
    def build():
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        flag = fluid.layers.data(name='flag', shape=[1], dtype='float32')
        zero = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                          value=0.0)
        cond = fluid.layers.less_than(x=zero, y=flag)
        cb = fluid.layers.ConditionalBlock([cond])
        with cb.block():
            if with_training:
                h = fluid.layers.fc(input=x, size=8, act='relu')
            else:
                h = fluid.layers.scale(x=x, scale=2.0)
        if not with_training:
            return [h]
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGDOptimizer(0.05).minimize(loss)
        return [loss, h]
    return build


@pytest.mark.parametrize('flag', [1.0, 0.0])
def test_conditional_block_selects_writes_as_the_reference(flag):
    xv = np.array([[1.0, 3.0, -2.0, 0.5]], 'float32')
    got, want = _run_both(_cond_program(False),
                          {'x': xv, 'flag': np.full((1, 1), flag, 'f4')})
    _agree(got, want)
    assert np.array_equal(got[0][0], xv * 2 * flag)


def test_conditional_block_trains_as_the_reference_and_prunes():
    r = np.random.RandomState(0)
    w = r.randn(4, 1).astype('float32')
    feeds = []
    for _ in range(3):
        xb = r.randn(8, 4).astype('float32')
        feeds.append({'x': xb, 'flag': np.ones((1, 1), 'f4'), 'y': xb @ w})
    got, want = _run_both(_cond_program(True), feeds, seed=11, steps=3)
    _agree(got, want)
    assert got[0][1].shape == (8, 8)
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[4], dtype='float32')
        flag = tfl.layers.data(name='flag', shape=[1], dtype='float32')
        zero = tfl.layers.fill_constant(shape=[1], dtype='float32',
                                        value=0.0)
        cb = tfl.layers.ConditionalBlock([tfl.layers.less_than(x=zero,
                                                               y=flag)])
        with cb.block():
            h = tfl.layers.fc(input=x, size=8, act='relu')
        try:
            with tfl.layers.ConditionalBlock(
                    [tfl.layers.less_than(x=zero, y=flag)]).block():
                raise RuntimeError('boom')
        except RuntimeError:
            pass
        after = tfl.layers.scale(x=x, scale=3.0)
    assert after.block.idx == 0
    pruned = main.prune(targets=[h.name], feeds=['x', 'flag'])
    assert [op.type for op in pruned.global_block().ops] == [
        'fill_constant', 'less_than', 'conditional_block']
    assert [op.type for op in pruned.blocks[1].ops] == [
        'mul', 'elementwise_add', 'relu']


def test_conditional_block_nested_while_as_the_reference():
    def build():
        flag = fluid.layers.data(name='flag', shape=[1], dtype='float32')
        zero = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                          value=0.0)
        cond = fluid.layers.less_than(x=zero, y=flag)
        cb = fluid.layers.ConditionalBlock([cond])
        with cb.block():
            i = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                           value=0.0)
            limit = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                               value=3.0)
            acc = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                             value=0.0)
            wcond = fluid.layers.less_than(x=i, y=limit)
            w = fluid.layers.While(cond=wcond, max_iters=3)
            with w.block():
                fluid.layers.increment(x=acc, value=1.0, in_place=True)
                fluid.layers.increment(x=i, value=1.0, in_place=True)
                fluid.layers.less_than(x=i, y=limit, cond=wcond)
        return [acc]
    for flag in (1.0, 0.0):
        got, want = _run_both(build, {'flag': np.full((1, 1), flag, 'f4')})
        _agree(got, want)
        assert float(np.ravel(got[0][0])[0]) == 3.0 * flag


def test_ifelse_merges_rows_as_the_reference():
    def build():
        x = fluid.layers.data(name='x', shape=[1], dtype='float32')
        zero = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                          value=0.0)
        cond = fluid.layers.less_than(x=x, y=zero)
        ie = fluid.layers.IfElse(cond)
        with ie.true_block():
            ie.output(fluid.layers.scale(x=ie.input(x), scale=-1.0))
        with ie.false_block():
            ie.output(fluid.layers.scale(x=ie.input(x), scale=1.0))
        return [ie()]
    xv = np.array([[-2.0], [3.0], [-0.5], [4.0]], 'float32')
    got, want = _run_both(build, {'x': xv})
    _agree(got, want)
    assert np.array_equal(got[0][0], np.abs(xv))


def test_mnist_if_else_trains_as_the_reference():
    def build():
        image = fluid.layers.data(name='x', shape=[784], dtype='float32')
        label = fluid.layers.data(name='y', shape=[1], dtype='int64')
        limit = fluid.layers.fill_constant_batch_size_like(
            input=label, shape=[-1, 1], dtype='int64', value=5)
        cond = fluid.layers.less_than(x=label, y=limit)
        ie = fluid.layers.IfElse(cond)
        with ie.true_block():
            hidden = fluid.layers.fc(input=ie.input(image), size=64,
                                     act='tanh')
            ie.output(fluid.layers.fc(input=hidden, size=10,
                                      act='softmax'))
        with ie.false_block():
            hidden = fluid.layers.fc(input=ie.input(image), size=64,
                                     act='tanh')
            ie.output(fluid.layers.fc(input=hidden, size=10,
                                      act='softmax'))
        prob = ie()
        acc = fluid.layers.accuracy(input=prob, label=label)
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=prob, label=label))
        fluid.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(loss)
        build.vars = (image, label)
        return [loss, acc, prob]
    samples = list(fluid.reader.firstn(jdatasets.mnist.train(), 192)())
    feeds = []
    for k in range(3):
        batch = samples[64 * k:64 * (k + 1)]
        feeds.append({'x': np.stack([s[0] for s in batch]).astype('f4'),
                      'y': np.array([[s[1]] for s in batch], 'int64')})
    got, want = _run_both(build, feeds, seed=11, steps=3)
    _agree(got, want)


# -- while loops ---------------------------------------------------------

def _loop_program(pkg, limit_value, max_iters, capacity):
    """counter < limit over ``max_iters`` ticks; each writes x * counter
    into an array of ``capacity`` first written inside the loop."""
    x = pkg.layers.data(name='x', shape=[3], dtype='float32')
    counter = pkg.layers.zeros(shape=[1], dtype='int64')
    limit = pkg.layers.fill_constant(shape=[1], dtype='int64',
                                     value=limit_value)
    cond = pkg.layers.less_than(x=counter, y=limit)
    arr = pkg.layers.create_array('float32')
    w = pkg.layers.While(cond=cond, max_iters=max_iters)
    with w.block():
        f = pkg.layers.cast(x=counter, dtype='float32')
        pkg.layers.array_write(pkg.layers.elementwise_mul(x, f),
                               counter, arr, capacity=capacity)
        pkg.layers.increment(x=counter, value=1, in_place=True)
        pkg.layers.less_than(x=counter, y=limit, cond=cond)
    return [pkg.layers.array_to_lod_tensor(arr),
            pkg.layers.array_length(arr), counter]


@pytest.mark.parametrize('limit,max_iters,capacity', [
    (3, 5, 3),    # masked ticks 4 and 5 write at index 3, past the capacity
    (4, 4, 6),    # every tick active
    (0, 3, 4),    # a loop that never runs: the zeroed buffer of size 0
    (0, 0, 4),    # no tick at all: the reference's probe
], ids=['masked_past_capacity', 'all_active', 'never_runs', 'no_ticks'])
def test_while_arrays_match_the_reference(limit, max_iters, capacity):
    xv = np.random.RandomState(4).randn(2, 3).astype('float32')
    got, want = _run_both(lambda: _loop_program(fluid, limit, max_iters,
                                                capacity), {'x': xv})
    _agree(got, want)
    data, size, counter = got[0]
    assert data.shape == (2, capacity, 3)
    assert int(size[0]) == min(limit, max_iters) == int(counter[0])
    assert not data[:, min(limit, max_iters):].any()


def test_a_value_only_a_while_body_reads_lives_until_the_loop():
    """``scaled`` is written before the loop and read only inside its
    body; the executor must neither skip its op nor drop it before the
    loop runs."""
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[3], dtype='float32')
        scaled = tfl.layers.scale(x, scale=2.0)
        total = tfl.layers.fill_constant(shape=[1], dtype='float32',
                                         value=0.0)
        counter = tfl.layers.zeros(shape=[1], dtype='int64')
        limit = tfl.layers.fill_constant(shape=[1], dtype='int64', value=2)
        cond = tfl.layers.less_than(x=counter, y=limit)
        w = tfl.layers.While(cond=cond)
        with w.block():
            s = tfl.layers.reduce_sum(scaled)
            tfl.layers.assign(tfl.layers.elementwise_add(total, s), total)
            tfl.layers.increment(x=counter, value=1, in_place=True)
            tfl.layers.less_than(x=counter, y=limit, cond=cond)
    assert main.global_block().ops[-1].attrs['max_iters'] == 2
    exe = tfl.Executor(tfl.CPUPlace())
    xv = np.arange(6, dtype='float32').reshape(2, 3)
    out, = exe.run(main, feed={'x': xv}, fetch_list=[total])
    assert float(out[0]) == 2 * 2 * xv.sum()
    assert 'scale' not in [t for _, t in exe.skipped_ops]

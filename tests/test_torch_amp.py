"""Automatic mixed precision in the port (paddle_tpu_torch/transpiler/
amp.py, ops/amp_ops.py, the executor's gates) against the reference's.

The reference's tests/test_amp.py cases that exist in the port, each run
through both packages: mode resolution and the plan key, the op classes
of every op type the port registers, the cast op, the golden cast list
(the port's weave equals the reference's cast for cast), AMP off as the
bitwise identity, a flag flip planning anew, the two loss-scaling ops on
the same inputs, and the f16 overflow skip (dense, and row-sparse under
lazy Adam, Adagrad and sgd on the row-wise rules, and densifying
momentum): every parameter, moment and row bitwise as it was, on both
sides, with the same loss-scale counters.  The low-precision model
builds (``dtype='bfloat16'``) of the transformer, the LSTM LM and
seq2seq serialise to the reference's programs.

Bounds of the three-step parity runs (both packages from the
reference's state, the same batches; the loss's largest gap over the
steps).  The two sides are two CPU implementations of one AMP step
(XLA's and torch's 16-bit matmuls; the port's flash attention rounds q
times the scale, p and ds to the input type as the reference's Pallas
kernels do, where the reference's CPU backward, its float32 jax scan,
rounds none of them), so their gap is the control, read on the CPU at
these seeds (float32, for scale: 2e-7 to 2e-6).  MNIST mlp (B=64, SGD
0.05): bf16 7.0e-5, f16 1.9e-5; the unfused LSTM LM (V=60, H=32,
Adagrad 0.1): bf16 3.8e-6, f16 2.8e-5; the transformer (L=2, D=64,
T=32, B=2, Adam 1e-3): bf16 1.90e-3, f16 4.12e-4 (1.14e-3 and 1.6e-4
while the port's attention kept p and ds in float32, as that scan
does).  A planted fault, softmax moved to the white list, reads 6.4e-4
(mlp, bf16), 2.7e-2 (mlp, f16), 4.5e-4 (LM, bf16), 7.2e-2 (LM, f16).
The bounds sit between, near the geometric middle where the fault is
close: mlp 2e-4 / 1e-4, LM 4e-5 / 1.5e-4 (bf16 / f16); the transformer,
whose program has no softmax, 3e-3 / 6e-4 (1.6x and 1.5x its control;
its planted layer_norm fault is refused by the verifier before it
runs).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import datatypes as jdt, registry as jreg
from paddle_tpu.core import program as jprog
from paddle_tpu.models import mnist as jmnist, rnn_lm as jrnn
from paddle_tpu.models import seq2seq as js2s, transformer as jtr
from paddle_tpu.ops import amp_ops as _jamp_ops  # noqa: F401 (registers)
from paddle_tpu.transpiler import amp as jamp
from paddle_tpu.core.selected_rows import SelectedRows as JRows

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import datatypes as tdt, registry as treg
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows
from paddle_tpu_torch.models import rnn_lm as trnn, seq2seq as ts2s
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.transpiler import amp as tamp
from paddle_tpu_torch.transpiler import verify as tverify

TOL_LOSS = {  # (bf16, f16), the module's bounds
    'mnist_mlp': (2e-4, 1e-4),
    'lm_unfused': (4e-5, 1.5e-4),
    'transformer': (3e-3, 6e-4),
}
ENV = ('PADDLE_TPU_AMP', 'PADDLE_TPU_TORCH_AMP')


@pytest.fixture(autouse=True)
def _fresh_names():
    """Every test builds under fresh name counters in both packages, so
    no name it draws shifts another test's in the same process."""
    with jprog.reset_unique_name_guard(), tprog.reset_unique_name_guard():
        yield


@pytest.fixture(autouse=True)
def _amp_env_clean(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def test_resolve_mode(monkeypatch):
    assert tamp.resolve_mode('0') is None
    assert tamp.resolve_mode('') is None
    assert tamp.resolve_mode('off') is None
    assert tamp.resolve_mode('bf16') == 'bf16'
    assert tamp.resolve_mode('BFLOAT16') == 'bf16'
    assert tamp.resolve_mode('fp16') == 'f16'
    assert tamp.resolve_mode('float16') == 'f16'
    with pytest.raises(ValueError):
        tamp.resolve_mode('f8')
    assert tamp.resolve_mode() is None
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'bf16')
    assert tamp.resolve_mode() == 'bf16'
    monkeypatch.setenv('PADDLE_TPU_AMP', 'f16')   # the reference's switch
    assert tamp.resolve_mode() == 'bf16' and jamp.resolve_mode() == 'f16'


def test_plan_key_component(monkeypatch):
    assert tamp.plan_key_component() is None
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'bf16')
    assert tamp.plan_key_component() == ('bf16',)
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'f16')
    monkeypatch.setenv('PADDLE_TPU_AMP', 'f16')
    assert tamp.plan_key_component() == jamp.plan_key_component()
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP_INCR_EVERY_N_STEPS', '7')
    assert tamp.plan_key_component() == ('f16', 32768.0, 7, 2)


def test_amp_guard_restores_env(monkeypatch):
    with tamp.amp_guard('bf16'):
        assert os.environ['PADDLE_TPU_TORCH_AMP'] == 'bf16'
    assert 'PADDLE_TPU_TORCH_AMP' not in os.environ
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'f16')
    with tamp.amp_guard('0'):
        assert tamp.resolve_mode() is None
    assert os.environ['PADDLE_TPU_TORCH_AMP'] == 'f16'
    with pytest.raises(ValueError):
        with tamp.amp_guard('f8'):
            pass
    assert os.environ['PADDLE_TPU_TORCH_AMP'] == 'f16'


def test_datatypes_low_precision_and_promotion():
    names = ('float16', 'bfloat16', 'float32', 'float64', 'fp16', 'bf16')
    for a in names:
        assert tdt.is_low_precision(a) == jdt.is_low_precision(a)
        for b in names:
            assert tdt.promote_float_dtype(a, b) == \
                jdt.promote_float_dtype(a, b), (a, b)
    with pytest.raises(ValueError):
        tdt.promote_float_dtype('int32', 'float32')


def test_amp_classes_match_the_reference_for_every_port_op():
    ops = treg.registered_ops()
    assert len(ops) >= 80
    assert treg.AMP_WHITE == jreg.AMP_WHITE
    assert treg.AMP_BLACK == jreg.AMP_BLACK
    for t in ops + ['never_registered_op']:
        assert treg.op_traits(t).amp == jreg.op_traits(t).amp, t
        assert treg.op_traits(t).registered == (t in ops)


def test_cast_same_dtype_is_passthrough_and_grad_is_float32():
    impl = treg.get_op_impl('cast')
    x = torch.arange(6, dtype=torch.float32)
    y, = impl.compute(None, {'X': [x]}, {'out_dtype': 'float32'})['Out']
    assert y is x
    x = torch.linspace(-3, 3, 17).requires_grad_(True)
    lo, = impl.compute(None, {'X': [x]}, {'out_dtype': 'bfloat16'})['Out']
    up, = impl.compute(None, {'X': [lo]}, {'out_dtype': 'float32'})['Out']
    assert lo.dtype == torch.bfloat16 and up.dtype == torch.float32
    np.testing.assert_allclose(up.detach().numpy(), x.detach().numpy(),
                               rtol=1e-2)
    g, = torch.autograd.grad(up.sum(), x)
    assert g.dtype == torch.float32 and torch.equal(g, torch.ones(17))


def _mnist_program(side, lr=0.05, kind='mlp'):
    pkg, prog_mod = (fluid, jprog) if side == 'ref' else (tfl, tprog)
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.program_guard(main, startup):
            mod = jmnist if side == 'ref' else __import__(
                'paddle_tpu_torch.models.mnist', fromlist=['mnist'])
            cost = mod.build(kind)[3]
            pkg.optimizer.SGDOptimizer(lr).minimize(cost)
    return main, startup, cost


def test_golden_cast_list_mnist_mlp():
    jmain = _mnist_program('ref', 0.1)[0]
    tmain = _mnist_program('port', 0.1)[0]
    jp2, jrep = jamp.apply_amp(jmain, mode='bf16')
    tp2, trep = tamp.apply_amp(tmain, mode='bf16')
    assert tp2.to_dict() == jp2.to_dict()
    assert trep['mode'] == 'bf16' and not trep['loss_scaling']
    assert trep['casts'] == jrep['casts'] == [
        ('img', 'bfloat16'),
        ('fc_0.w_0', 'bfloat16'), ('fc_0.b_0', 'bfloat16'),
        ('fc_1.w_0', 'bfloat16'), ('fc_1.b_0', 'bfloat16'),
        ('fc_2.w_0', 'bfloat16'), ('fc_2.b_0', 'bfloat16'),
        ('fc_2.tmp_1', 'float32')]
    assert trep['casts_inserted'] == 8 and trep['ops_lowered'] == 8
    assert 'cast' not in [op.type for op in tmain.global_block().ops]
    assert all(p.dtype == 'float32' for p in tp2.all_parameters())


def test_foreign_low_dtype_promotes_to_f32():
    progs = {}
    for side, pkg, prog_mod, amp in (('ref', fluid, jprog, jamp),
                                     ('port', tfl, tprog, tamp)):
        with prog_mod.reset_unique_name_guard():
            main = pkg.Program()
            with pkg.program_guard(main, pkg.Program()):
                x = pkg.layers.data(name='amp_mix_x', shape=[4],
                                    dtype='float32')
                xb = pkg.layers.cast(x=x, dtype='bfloat16')
                y = pkg.layers.data(name='amp_mix_y', shape=[4],
                                    dtype='float32')
                z = pkg.layers.elementwise_add(xb, y)
            progs[side] = amp.apply_amp(main, mode='f16')
    (jp, jrep), (tp, trep) = progs['ref'], progs['port']
    assert tp.to_dict() == jp.to_dict()
    assert (xb.name, 'float32') in trep['casts']
    assert not any(dt == 'float16' for _, dt in trep['casts'])
    assert tp.global_block().vars[z.name].dtype == 'float32'


def _mnist_feed(batch=16, seed=0):
    rng = np.random.default_rng(seed)
    return {'img': rng.normal(size=(batch, 1, 28, 28)).astype(np.float32),
            'label': rng.integers(0, 10, (batch, 1)).astype(np.int32)}


def _port_losses(mode, steps, feed, monkeypatch):
    if mode is None:
        monkeypatch.delenv('PADDLE_TPU_TORCH_AMP', raising=False)
    else:
        monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', mode)
    main, startup, cost = _mnist_program('port')
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0][0]) for _ in range(steps)]
    return losses, exe.last_graph_opt_report


def test_amp_off_is_bitwise_identity(monkeypatch):
    feed = _mnist_feed()
    l_unset, rep_unset = _port_losses(None, 2, feed, monkeypatch)
    l_zero, rep_zero = _port_losses('0', 2, feed, monkeypatch)
    assert l_unset == l_zero
    assert 'amp' not in rep_unset and 'amp' not in rep_zero
    # and the pipeline at level 0 with AMP off leaves the program alone
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '0')
    l_bare, rep_bare = _port_losses('0', 2, feed, monkeypatch)
    assert rep_bare is None and l_bare == l_zero


def test_flag_flip_invalidates_plan_cache(monkeypatch):
    feed = _mnist_feed(8)
    main, startup, cost = _mnist_program('port')
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    n_plans = len(exe._plans)
    assert 'amp' not in exe.last_graph_opt_report
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'bf16')
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    assert len(exe._plans) == n_plans + 1
    assert exe.last_graph_opt_report['amp']['ops_lowered'] > 0
    monkeypatch.delenv('PADDLE_TPU_TORCH_AMP')
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    assert len(exe._plans) == n_plans + 1
    assert 'amp' not in exe.last_graph_opt_report


# ---------------------------------------------------------------------------
# the loss-scaling ops against the reference's on the same inputs
# ---------------------------------------------------------------------------

def _both_ops(type, ins, attrs):
    import jax.numpy as jnp
    jins = {k: [JRows(jnp.asarray(v[0]), jnp.asarray(v[1]), v[2])
                if isinstance(v, tuple) else jnp.asarray(v) for v in vs]
            for k, vs in ins.items()}
    tins = {k: [TRows(torch.from_numpy(v[0]), torch.from_numpy(v[1]), v[2])
                if isinstance(v, tuple) else torch.from_numpy(v)
                for v in vs] for k, vs in ins.items()}
    jout = jreg.get_op_impl(type).compute(None, jins, attrs)
    tout = treg.get_op_impl(type).compute(None, tins, attrs)
    assert set(jout) == set(tout)
    for k in jout:
        for a, b in zip(jout[k], tout[k]):
            if isinstance(b, TRows):
                assert np.array_equal(np.asarray(a.rows), b.rows.numpy())
                a, b = a.values, b.values
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype, k
            assert np.array_equal(a, b, equal_nan=True), k
    return tout


def test_check_finite_and_unscale_matches_the_reference():
    scale = np.array([4.0], np.float32)
    g1 = np.array([8.0, 12.0], np.float32)
    out = _both_ops('check_finite_and_unscale',
                    {'X': [g1], 'Scale': [scale]}, {})
    assert out['Out'][0].tolist() == [2.0, 3.0]
    assert not bool(out['FoundInfinite'][0][0])
    bad = np.array([1.0, np.inf], np.float32)
    out = _both_ops('check_finite_and_unscale',
                    {'X': [g1, bad], 'Scale': [scale]}, {})
    assert bool(out['FoundInfinite'][0][0])
    out = _both_ops('check_finite_and_unscale',
                    {'X': [g1], 'Scale': [scale],
                     'FoundAcc': [np.array([True])]}, {})
    assert bool(out['FoundInfinite'][0][0])
    rows = (np.array([3, 0, 3], np.int32),
            np.array([[4.0, 8.0], [np.nan, 1.0], [2.0, 2.0]], np.float32), 5)
    out = _both_ops('check_finite_and_unscale',
                    {'X': [rows, g1], 'Scale': [scale]}, {})
    assert bool(out['FoundInfinite'][0][0])
    g16 = np.array([8.0, 65504.0], np.float16)
    out = _both_ops('check_finite_and_unscale',
                    {'X': [g16], 'Scale': [scale]}, {})
    assert out['Out'][0].dtype == torch.float16


@pytest.mark.parametrize('found,scale,good,bad,skipped,knobs', [
    (False, 1024.0, 0, 0, 0, dict(incr_every_n_steps=2)),
    (False, 1024.0, 1, 0, 0, dict(incr_every_n_steps=2)),
    (True, 1024.0, 5, 0, 0, dict(decr_every_n_nan_or_inf=2)),
    (True, 1024.0, 0, 1, 1, dict(decr_every_n_nan_or_inf=2)),
    (True, 1.0, 0, 1, 0, dict(decr_every_n_nan_or_inf=2)),
    (False, 2.0 ** 31, 999, 0, 3, {}),
])
def test_update_loss_scale_matches_the_reference(found, scale, good, bad,
                                                 skipped, knobs):
    _both_ops('update_loss_scale', {
        'FoundInfinite': [np.array([found])],
        'LossScale': [np.array([scale], np.float32)],
        'GoodSteps': [np.array([good], np.int32)],
        'BadSteps': [np.array([bad], np.int32)],
        'SkippedSteps': [np.array([skipped], np.int32)]}, knobs)


# ---------------------------------------------------------------------------
# f16 loss scaling and the overflow skip, both packages
# ---------------------------------------------------------------------------

def _pair(build, startup_seed=5):
    """((reference main, exe, scope), (port main, exe, scope)), the loss
    name and the persistables: ``build(fluid)`` builds the reference's
    program, the port runs it (``from_dict``) from the reference's
    initialised state."""
    with jprog.reset_unique_name_guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = startup_seed
        with fluid.program_guard(main, startup):
            cost = build(fluid)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in main.list_vars()
               if v.persistable and jscope.has(v.name)}
    tmain = tfl.Program.from_dict(main.to_dict())
    return (((main, jexe, jscope), (tmain, tfl.Executor(tfl.CPUPlace()),
                                    scope_from_numpy(persist, 'cpu'))),
            cost.name, sorted(persist))


def _state(side, scope, names):
    return {n: (np.asarray(scope.get(n)) if side == 'ref'
                else scope.get_numpy(n)).copy() for n in names}


def _step_both(pair, loss, feed):
    out = []
    for side, (main, exe, scope) in zip(('ref', 'port'), pair):
        out.append(float(np.asarray(exe.run(main, feed=feed,
                                            fetch_list=[loss],
                                            scope=scope)[0]).ravel()[0]))
    return out


COUNTERS = (tamp.LOSS_SCALE_VAR, tamp.GOOD_STEPS_VAR, tamp.BAD_STEPS_VAR,
            tamp.SKIPPED_STEPS_VAR)


def _counters(pair):
    return [[float(np.asarray(scope.get(n) if i == 0 else
                              scope.get_numpy(n)).ravel()[0])
             for n in COUNTERS] for i, (_, _, scope) in enumerate(pair)]


def _f16_env(monkeypatch, decr='1'):
    for k in ENV:
        monkeypatch.setenv(k, 'f16')
    for prefix in ('PADDLE_TPU_', 'PADDLE_TPU_TORCH_'):
        monkeypatch.setenv(prefix + 'AMP_DECR_EVERY_N_NAN_OR_INF', decr)


def test_f16_loss_scaling_trains_and_carries_state(monkeypatch):
    _f16_env(monkeypatch, decr='2')

    def build(pkg):
        cost = jmnist.build('mlp')[3]
        pkg.optimizer.SGDOptimizer(0.01).minimize(cost)
        return cost
    pair, loss, names = _pair(build)
    feed = _mnist_feed(16)
    for _ in range(3):
        jl, tl = _step_both(pair, loss, feed)
        assert abs(jl - tl) <= TOL_LOSS['mnist_mlp'][1]
    rep = pair[1][1].last_graph_opt_report['amp']
    assert rep['mode'] == 'f16' and rep['loss_scaling']
    ref, port = _counters(pair)
    assert port == ref == [32768.0, 3.0, 0.0, 0.0]
    out = pair[1][1].run_steps(pair[1][0], feed=feed, fetch_list=[loss],
                               scope=pair[1][2], repeat=4)
    assert np.isfinite(out[0]).all()
    assert _counters(pair)[1][1] == 7.0
    assert all(pair[1][2].get(n).dtype == torch.float32
               for n in names if n.startswith('fc_'))


def test_f16_overflow_skips_step_and_backs_off(monkeypatch):
    _f16_env(monkeypatch)

    def build(pkg):
        cost = jmnist.build('mlp')[3]
        pkg.optimizer.SGDOptimizer(0.01).minimize(cost)
        return cost
    pair, loss, names = _pair(build)
    feed = _mnist_feed(16)
    bad = dict(feed, img=np.full_like(feed['img'], 1e38))
    _step_both(pair, loss, feed)
    before = [_state(s, p[2], names) for s, p in zip(('ref', 'port'),
                                                     pair)]
    _step_both(pair, loss, bad)
    after = [_state(s, p[2], names) for s, p in zip(('ref', 'port'),
                                                    pair)]
    for b, a in zip(before, after):
        for n in names:
            assert np.array_equal(b[n], a[n]), n
    ref, port = _counters(pair)
    assert port == ref == [16384.0, 0.0, 0.0, 1.0]
    _step_both(pair, loss, feed)
    moved = _state('port', pair[1][2], names)
    assert any(not np.array_equal(after[1][n], moved[n]) for n in names)


@pytest.mark.parametrize('opt', ['adam', 'adagrad', 'sgd', 'momentum'])
def test_f16_sparse_grads_skip_step(opt, monkeypatch):
    """SelectedRows gradients under the f16 skip: the row-wise rules
    (lazy Adam, Adagrad, sgd) see every id swapped to the sentinel and
    write nothing; momentum densifies and keeps its outputs' old values.
    The table and its accumulators stay bitwise on both sides."""
    _f16_env(monkeypatch)

    def build(pkg):
        ids = pkg.layers.data(name='ids', shape=[1], dtype='int64')
        emb = pkg.layers.embedding(input=ids, size=[40, 8], is_sparse=True)
        y = pkg.layers.data(name='y', shape=[8], dtype='float32')
        cost = pkg.layers.mean(
            x=pkg.layers.square_error_cost(input=emb, label=y))
        {'adam': lambda: pkg.optimizer.AdamOptimizer(0.1),
         'adagrad': lambda: pkg.optimizer.AdagradOptimizer(0.1),
         'sgd': lambda: pkg.optimizer.SGDOptimizer(0.1),
         'momentum': lambda: pkg.optimizer.MomentumOptimizer(0.1, 0.9)}[
            opt]().minimize(cost)
        return cost
    pair, loss, names = _pair(build)
    rng = np.random.default_rng(3)
    feed = {'ids': rng.integers(0, 40, (6, 1)).astype(np.int32),
            'y': rng.normal(size=(6, 8)).astype(np.float32)}
    bad = dict(feed, y=np.full((6, 8), 1e38, np.float32))
    _step_both(pair, loss, feed)
    before = [_state(s, p[2], names) for s, p in zip(('ref', 'port'),
                                                     pair)]
    _step_both(pair, loss, bad)
    for s, p, b in zip(('ref', 'port'), pair, before):
        a = _state(s, p[2], names)
        for n in names:
            assert np.array_equal(b[n], a[n]), (s, n)
    ref, port = _counters(pair)
    assert port == ref and port[0] == 16384.0 and port[3] == 1.0
    _step_both(pair, loss, feed)
    table = [n for n in names if n.startswith('embedding')][0]
    assert not np.array_equal(before[1][table],
                              _state('port', pair[1][2], [table])[table])


# ---------------------------------------------------------------------------
# three steps from the reference's state, bf16 and f16
# ---------------------------------------------------------------------------

def _mlp(pkg):
    cost = jmnist.build('mlp')[3]
    pkg.optimizer.SGDOptimizer(0.05).minimize(cost)
    return cost


def _lm_unfused(pkg):
    cost = jrnn.build(vocab_size=60, emb_dim=16, hidden_dim=32,
                      num_layers=1, fuse_vocab_loss=False)[-1]
    pkg.optimizer.AdagradOptimizer(0.1).minimize(cost)
    return cost


def _transformer(pkg):
    cost = jtr.build(vocab_size=64, seq_len=32, n_layers=2, d_model=64,
                     n_heads=4)[-1]
    pkg.optimizer.AdamOptimizer(1e-3).minimize(cost)
    return cost


def _feeds(name):
    if name == 'mnist_mlp':
        return [_mnist_feed(64, seed=5 + i) for i in range(3)]
    rng = np.random.default_rng(11)
    if name == 'lm_unfused':
        ln = np.full((4,), 8, np.int32)
        return [{'src': (rng.integers(1, 60, (4, 8, 1)).astype(np.int32), ln),
                 'target': (rng.integers(1, 60, (4, 8, 1)).astype(np.int32),
                            ln)} for _ in range(3)]
    feeds = []
    for _ in range(3):
        src = rng.integers(0, 64, (2, 32)).astype(np.int64)
        feeds.append({'src': src,
                      'target': np.roll(src, -1, axis=1)[..., None]})
    return feeds


BUILDS = {'mnist_mlp': _mlp, 'lm_unfused': _lm_unfused,
          'transformer': _transformer}


def _three_steps(name, mode, monkeypatch, fault=None):
    for k in ENV:
        monkeypatch.setenv(k, mode)
    if fault:
        monkeypatch.setattr(treg, 'AMP_WHITE', treg.AMP_WHITE | {fault})
    pair, loss, _ = _pair(BUILDS[name], startup_seed=7)
    gaps = [abs(a - b) for a, b in (_step_both(pair, loss, f)
                                    for f in _feeds(name))]
    assert np.isfinite(gaps).all()
    return max(gaps)


@pytest.mark.parametrize('mode', ['bf16', 'f16'])
@pytest.mark.parametrize('name', sorted(BUILDS))
def test_three_amp_steps_match_the_reference(name, mode, monkeypatch):
    tol = TOL_LOSS[name][0 if mode == 'bf16' else 1]
    assert _three_steps(name, mode, monkeypatch) <= tol


@pytest.mark.parametrize('mode', ['bf16', 'f16'])
@pytest.mark.parametrize('name', ['mnist_mlp', 'lm_unfused'])
def test_planted_softmax_in_white_exceeds_the_bound(name, mode,
                                                    monkeypatch):
    assert _three_steps(name, mode, monkeypatch, fault='softmax') > \
        TOL_LOSS[name][0 if mode == 'bf16' else 1]


def test_planted_layer_norm_in_white_is_refused(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'bf16')
    monkeypatch.setattr(treg, 'AMP_WHITE', treg.AMP_WHITE | {'layer_norm'})
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        _, _, cost = ttr.build(vocab_size=64, seq_len=32, n_layers=1,
                               d_model=32, n_heads=4)
    exe = tfl.Executor(tfl.CPUPlace())
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    src = np.zeros((1, 32), np.int64)
    with pytest.raises(tverify.IRVerificationError,
                       match='layer_norm.*declared bfloat16 but '
                             're-inference'):
        exe.run(main, feed={'src': src, 'target': src[..., None]},
                fetch_list=[cost], scope=scope)


# ---------------------------------------------------------------------------
# the low-precision model builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['bfloat16', 'float16'])
@pytest.mark.parametrize('model', ['transformer', 'transformer_logits',
                                   'rnn_lm', 'rnn_lm_unfused', 'seq2seq'])
def test_low_precision_builds_serialise_to_the_reference(model, dtype):
    makers = {
        'transformer': lambda m: m.build(vocab_size=64, seq_len=16,
                                         n_layers=1, d_model=32, n_heads=4,
                                         dtype=dtype),
        'transformer_logits': lambda m: m.build_logits(
            vocab_size=64, seq_len=16, n_layers=1, d_model=32, n_heads=4,
            dtype=dtype),
        'rnn_lm': lambda m: m.build(vocab_size=50, dtype=dtype),
        'rnn_lm_unfused': lambda m: m.build(vocab_size=50, dtype=dtype,
                                            fuse_vocab_loss=False),
        'seq2seq': lambda m: m.build(dict_size=30, dtype=dtype),
    }
    mods = {'transformer': (jtr, ttr), 'transformer_logits': (jtr, ttr),
            'rnn_lm': (jrnn, trnn), 'rnn_lm_unfused': (jrnn, trnn),
            'seq2seq': (js2s, ts2s)}[model]
    dicts = []
    for (pkg, prog_mod), mod in zip(((fluid, jprog), (tfl, tprog)), mods):
        with prog_mod.reset_unique_name_guard():
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup):
                makers[model](mod)
        dicts.append((main.to_dict(), startup.to_dict()))
    assert dicts[1] == dicts[0]

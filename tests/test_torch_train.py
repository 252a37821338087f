"""Training the transformer LM through the port's Program / Executor
(paddle_tpu_torch) against the reference's, on the CPU, and serving the
weights it trained.

The harness: the reference builds the program (models/transformer.py
``build`` + ``minimize``) and runs its startup; ``Program.to_dict`` hands
the program to the port's ``Program.from_dict``; every persistable is
copied into the port's Scope (``scope_from_numpy``); both executors run
the same batches.  L=2, D=32, H=4, V=64, T=32, B=2, 3 steps; the fused
vocab head runs pinned to each of its modes (chunk 16 of V=64 in the
chunked mode).

Tolerances.  Loss per step: 1e-5 absolute (the losses are O(4); both
sides compute in float32 on the CPU with different BLAS and summation
orders).  Parameters after the steps: 2e-4 absolute for Adam.  Adam's
step is sign-like, lr * m / (sqrt(v) + eps): where a gradient is within
float32 noise of zero, the two sides' last-ulp differences can move
that parameter's step by up to 2 * lr = 2e-3, so a bound below that
only holds where no such gradient sits near zero, as at these seeds
(the dense-mode run's largest gap was 4e-5).  SGD and momentum have no
such amplifier: 1e-5.
Engine vs program logits: 1e-5 absolute.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.inference import decode as tdec
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.kernels import dense_update as tdu
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

L, D, H, V, T, B = 2, 32, 4, 64, 32, 2
CFG = dict(vocab_size=V, seq_len=T, n_layers=L, d_model=D, n_heads=H)
STEPS = 3
TOL_LOSS = 1e-5
TOL_PARAM = {'adam': 2e-4, 'sgd': 1e-5, 'momentum': 1e-5}
TOL_LOGITS = 1e-5

OPTIMIZERS = {
    'adam': lambda pkg: pkg.optimizer.AdamOptimizer(learning_rate=1e-3),
    'sgd': lambda pkg: pkg.optimizer.SGDOptimizer(learning_rate=0.1),
    'momentum': lambda pkg: pkg.optimizer.MomentumOptimizer(
        learning_rate=0.1, momentum=0.9, use_nesterov=True),
}


def _reference(opt, mode):
    with jprog.reset_unique_name_guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 7
        with fluid.program_guard(main, startup):
            _, _, cost = jtr.build(**CFG)
            OPTIMIZERS[opt](fluid).minimize(cost)
    d = main.to_dict()
    for op in d['blocks'][0]['ops']:
        if op['type'] == 'fused_linear_softmax_ce':
            op['attrs'].update(mode=mode, chunk=16)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    persist = {v.name: np.asarray(scope.get(v.name))
               for v in main.list_vars()
               if v.persistable and scope.has(v.name)}
    return fluid.Program.from_dict(d), d, exe, scope, persist, cost.name


def _batches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(STEPS):
        src = rng.integers(0, V, (B, T)).astype(np.int64)
        yield {'src': src, 'target': np.roll(src, -1, axis=1)[..., None]}


@pytest.fixture(scope='module')
def trained():
    """The Adam, dense-mode run: (reference scope, port scope)."""
    return _train('adam', 'dense')


def _train(opt, mode):
    jmain, d, jexe, jscope, persist, loss = _reference(opt, mode)
    tmain = tfl.Program.from_dict(d)
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    for feed in _batches(11):
        jl, = jexe.run(jmain, feed=feed, fetch_list=[loss], scope=jscope)
        tl, = texe.run(tmain, feed=feed, fetch_list=[loss], scope=tscope)
        assert np.isfinite(tl).all()
        assert abs(float(tl[0]) - float(jl[0])) <= TOL_LOSS
    for name in persist:
        got = tscope.get_numpy(name)
        assert got.shape == persist[name].shape
        assert np.max(np.abs(got - np.asarray(jscope.get(name)))) <= \
            TOL_PARAM[opt], name
    return jscope, tscope


@pytest.mark.parametrize('opt,mode', [('adam', 'chunked'), ('sgd', 'dense'),
                                      ('momentum', 'dense')])
def test_steps_match_reference(opt, mode):
    _train(opt, mode)


def test_adam_dense_steps_match_reference(trained):
    jscope, tscope = trained
    # the optimizer state moved: beta pows are beta^(1 + steps)
    b1 = [n for n in tscope.local_var_names() if n.startswith('beta1_pow')]
    assert len(b1) == 1
    assert np.allclose(tscope.get_numpy(b1[0]), 0.9 ** (1 + STEPS))


def test_trained_weights_serve_through_the_decode_engine(trained):
    _, tscope = trained
    params = tdec.extract_params(tscope, L)
    assert sorted(params) == sorted(ttr.param_names(L))
    eng = tdec.DecodeEngine(params, n_layers=L, n_heads=H, page_size=8,
                            max_streams=2, prefill_bucket=32, device='cpu')
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        _, logits = ttr.build_logits(**CFG)
    exe = tfl.Executor(tfl.CPUPlace())
    rng = np.random.default_rng(5)
    for t in (5, 17, 32):
        prompt = rng.integers(0, V, size=t)
        pages = eng.cache.alloc(-(-t // 8))
        got = eng.prefill_into(prompt, pages)
        eng.cache.free(pages)
        src = np.zeros((1, T), np.int64)
        src[0, :t] = prompt   # causal: positions past t-1 cannot leak in
        want, = exe.run(main, feed={'src': src}, fetch_list=[logits],
                        scope=tscope)
        assert np.max(np.abs(got - want[0, t - 1])) <= TOL_LOGITS


def test_port_startup_and_steps_on_its_own_program():
    """The port's own build + startup (its random init) trains: the loss
    of a repeated batch falls, and the CPU run launched no kernel."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 3
    with tfl.program_guard(main, startup):
        _, _, cost = ttr.build(**CFG)
        tfl.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(cost)
    scope = tfl.Scope()
    exe = tfl.Executor(tfl.CPUPlace())
    exe.run(startup, scope=scope)
    embed = scope.get('tr_embed')
    limit = np.sqrt(6.0 / (V + D))
    assert embed.shape == (V, D) and float(embed.abs().max()) <= limit
    feed = next(_batches(2))
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0][0]) for _ in range(4)]
    assert losses[-1] < losses[0]
    assert scope.get('tr_embed') is embed   # updated in place
    assert tfa.launches == tfa.bwd_launches == tdu.launches == 0


def test_executor_raises_for_what_this_slice_does_not_bring():
    exe = tfl.Executor(tfl.CPUPlace())
    main = tfl.Program()
    with tfl.program_guard(main, tfl.Program()):
        x = tfl.layers.data(name='x', shape=[4], dtype='float32')
        y = tfl.layers.mean(x=x)
    main.global_block().ops[-1].attrs['overlap_buckets'] = [['w@GRAD']]
    with pytest.raises(NotImplementedError, match='multi-chip'):
        exe.run(main, feed={'x': np.zeros((2, 4), np.float32)},
                fetch_list=[y], scope=tfl.Scope())
    with pytest.raises(KeyError, match='not produced'):
        exe.run(main, feed={}, fetch_list=['nope'], scope=tfl.Scope())

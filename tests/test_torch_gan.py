"""Programs with several ``autodiff`` ops through the port: the GAN
(paddle_tpu_torch/models/gan.py, two ``minimize`` passes in one program)
and fit_a_line (models/fit_a_line.py on datasets/uci_housing.py),
against the reference, on the CPU.

- Program parity: each model's ``build`` (+ fit_a_line's SGD
  ``minimize``) serialises to exactly the reference's main and startup
  programs.
- The GAN, 3 steps, with the harness of tests/test_torch_ctr.py: the
  reference builds and initialises, the port loads ``to_dict`` and every
  persistable, both run on the same seeded images and noise.  D's
  gradient is taken first; G's gradient runs the forward ops G's
  parameters taint, at D's parameters from before D's Adam step (the
  reference's ``pre_update_vals``; the port copies them before #5's plain
  rule updates them in place).  Losses at 1e-5 relative, every
  gradient each step at 1e-6 absolute, every parameter and moment after
  the 3 steps at 1e-5 absolute.  A planted control: the port's plan with
  D's rollback removed (G's gradient taken at D's post-update
  parameters) reads far outside those bounds.
- The same under the pass pipeline at each level, under AMP (bf16, f16)
  and under remat ('dots', 'full'), and through ``run_steps``.
- fit_a_line 3 SGD steps against the reference, and the datasets' samples
  bit for bit.
- The book tests through the port: tests/book/test_gan.py's gate (2
  epochs of the first 256 synthetic MNIST images in batches of 32: the
  mean D loss of the last 4 steps below 1.45 and below the mean of the
  first 2) and tests/book/test_fit_a_line.py's (the cost below 12.0
  within 12 epochs, and below the first).

Tolerances: the losses are O(1) means of float32 sums, so 1e-5 relative
holds a reassociation; the gradients are O(0.5) at most and the two
sides' float32 sums differ by under 2e-7 (measured), so 1e-6 absolute.
The state after Adam (lr 2e-4) is held to 1e-5, 5% of a step: Adam's
first step moves an entry by lr * g / (|g| + 3.2e-7), so a gradient
entry within ~1e-7 of zero turns the sides' float32 noise on it into a
part of a step (3.7e-6 measured on d_fc2_w, all of it in the first
step; the later steps agree within 1e-7).  The planted control reads
6e-4 to 3.5e-3 there.
"""
import types

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import datasets as jdatasets
from paddle_tpu.core import program as jprog
from paddle_tpu.models import fit_a_line as jfit
from paddle_tpu.models import gan as jgan

import paddle_tpu_torch as tfl
from paddle_tpu_torch import datasets
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import fit_a_line, gan
from paddle_tpu_torch.ops.kernels import dense_update as tdu

TOL_LOSS = 1e-5
TOL_GRAD = 1e-6
TOL_STATE = 1e-5
IMG = 784
B = 8

REF = types.SimpleNamespace(gan=jgan, fit=jfit, prog=jprog)
PORT = types.SimpleNamespace(gan=gan, fit=fit_a_line, prog=tprog)


def _models(pkg):
    return REF if pkg is fluid else PORT


def _build(pkg, what):
    m = _models(pkg)
    with m.prog.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 11
        with pkg.program_guard(main, startup):
            if what == 'gan':
                img, noise, d_loss, g_loss, fake = m.gan.build(img_dim=IMG)
                fetch = [d_loss, g_loss]
            else:
                x, y, y_pred, cost = m.fit.build()
                pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(cost)
                fetch = [cost]
    return main, startup, fetch


@pytest.mark.parametrize('what', ['gan', 'fit_a_line'])
def test_port_build_serialises_to_the_reference_program(what):
    jm, js, _ = _build(fluid, what)
    tm, ts, _ = _build(tfl, what)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    if what == 'gan':
        ads = [op for op in tm.global_block().ops if op.type == 'autodiff']
        assert [sorted(op.attrs['param_names'])[0][:2] for op in ads] == \
            ['d_', 'g_']


def _gan_feeds(rng, n=3):
    return [{'img': rng.uniform(-1, 1, (B, IMG)).astype(np.float32),
             'noise': rng.normal(size=(B, gan.NOISE_DIM)).astype(
                 np.float32)} for _ in range(n)]


def _reference(what, feeds, fetch_grads=True, remat=None):
    """The reference's run: (main, per-step fetches, final state, the
    port's starting state, fetch names)."""
    jmain, jstartup, jfetch = _build(fluid, what)
    if remat is not None:
        fluid.memory_optimize(jmain, level=remat)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.array(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    params = [p.name for p in jmain.all_parameters()]
    fetch = [v.name for v in jfetch] + (
        [p + '@GRAD' for p in params] if fetch_grads else [])
    want = [jexe.run(jmain, feed=f, fetch_list=fetch, scope=jscope)
            for f in feeds]
    final = {n: np.asarray(jscope.get(n)) for n in persist}
    return jmain, want, final, persist, fetch


def _port_run(jmain, persist, feeds, fetch, plan_hook=None, steps=False,
              remat=None):
    tmain = tfl.Program.from_dict(jmain.to_dict())
    if remat is not None:
        tfl.memory_optimize(tmain, level=remat)
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    if plan_hook is not None:
        texe.run(tmain, feed=feeds[0], fetch_list=fetch,
                 scope=scope_from_numpy(persist, 'cpu'))
        for plan in texe._plans.values():
            plan_hook(plan)
    if steps:
        got = texe.run_steps(tmain, feed=feeds, fetch_list=fetch,
                             scope=tscope)
        got = [[g[k] for g in got] for k in range(len(feeds))]
    else:
        got = [texe.run(tmain, feed=f, fetch_list=fetch, scope=tscope)
               for f in feeds]
    return got, {n: tscope.get_numpy(n) for n in persist}, texe


def _gaps(got, want, final, state, nloss):
    """(the largest relative loss gap, the largest absolute gap of any
    other fetch (the gradients), the largest absolute gap of any state
    entry after the steps)."""
    loss = max(abs(float(np.ravel(a)[0]) - float(np.ravel(b)[0])) /
               abs(float(np.ravel(b)[0]))
               for g, w in zip(got, want) for a, b in
               zip(g[:nloss], w[:nloss]))
    grads = max([0.0] + [float(np.abs(np.asarray(a) - np.asarray(b)).max())
                         for g, w in zip(got, want)
                         for a, b in zip(g[nloss:], w[nloss:])])
    st = max(float(np.abs(state[n] - final[n]).max()) for n in final)
    return loss, grads, st


def _within(gaps, tol_state=TOL_STATE):
    loss, grads, st = gaps
    return loss <= TOL_LOSS and grads <= TOL_GRAD and st <= tol_state


def test_gan_three_steps_match_the_reference():
    feeds = _gan_feeds(np.random.default_rng(5))
    jmain, want, final, persist, fetch = _reference('gan', feeds)
    got, state, texe = _port_run(jmain, persist, feeds, fetch)
    gaps = _gaps(got, want, final, state, 2)
    assert _within(gaps), gaps
    # G's pass rolled D's six parameters back; no kernel ran on the CPU
    plan, = texe._plans.values()
    later, = [gp for gp in plan.passes.values() if not gp.publish]
    assert sorted(later.rollback) == sorted(
        p.name for p in jmain.all_parameters() if p.name.startswith('d_'))
    assert tdu.launches == 0


def test_gan_planted_control_post_update_discriminator():
    """G's gradient taken at D's post-update parameters: the test above
    must be able to see it."""
    feeds = _gan_feeds(np.random.default_rng(5))
    jmain, want, final, persist, fetch = _reference('gan', feeds)

    def no_rollback(plan):
        for gp in plan.passes.values():
            gp.rollback = []
        plan.snapshots = {}
    got, state, _ = _port_run(jmain, persist, feeds, fetch,
                              plan_hook=no_rollback)
    loss, grads, st = _gaps(got, want, final, state, 2)
    assert grads > 100 * TOL_GRAD and st > 20 * TOL_STATE, (grads, st)


@pytest.mark.parametrize('level', ['0', '1', '2'])
def test_gan_under_the_pass_pipeline(level, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', level)
    monkeypatch.setenv('PADDLE_TPU_GRAPH_OPT_LEVEL', level)
    feeds = _gan_feeds(np.random.default_rng(6), 2)
    jmain, want, final, persist, fetch = _reference('gan', feeds)
    got, state, _ = _port_run(jmain, persist, feeds, fetch)
    gaps = _gaps(got, want, final, state, 2)
    assert _within(gaps), gaps


@pytest.mark.parametrize('level', ['dots', 'full'])
def test_gan_under_remat(level):
    """Both packages under ``memory_optimize(level)``: the port's steps
    are bitwise its steps without remat, and within the bounds of the
    reference's remat steps."""
    feeds = _gan_feeds(np.random.default_rng(8), 2)
    jmain, want, final, persist, fetch = _reference('gan', feeds,
                                                    remat=level)
    got, state, texe = _port_run(jmain, persist, feeds, fetch, remat=level)
    gaps = _gaps(got, want, final, state, 2)
    assert _within(gaps), gaps
    plan, = texe._plans.values()
    assert all(gp.units for gp in plan.passes.values())
    bare, bare_state, _ = _port_run(jmain, persist, feeds, fetch)
    for g, b in zip(got, bare):
        assert all(np.array_equal(x, y) for x, y in zip(g, b))
    assert all(np.array_equal(state[n], bare_state[n]) for n in state)


# AMP: the losses relative and the gradients norm-relative per parameter.
# Each side rounds its matmul inputs to the low type in the same places
# and sums in other orders; one bf16 ulp of a bias gradient summed from
# bf16 values is a few %.  Measured: bf16 2.5e-4 and up to 6.3% (the
# reference's own bf16 step reads up to 16.7% from its float32 step), f16
# 2.0e-5 and 1.1e-3 (its float32 step 3.4%); the gradient bounds are
# chip_smoke.py's AMP parity bound (0.1) and a tenth of it for f16
TOL_AMP = {'bf16': (1e-3, 0.1), 'f16': (1e-4, 1e-2)}


@pytest.mark.parametrize('mode', ['bf16', 'f16'])
def test_gan_under_amp(mode, monkeypatch):
    for k in ('PADDLE_TPU_AMP', 'PADDLE_TPU_TORCH_AMP'):
        monkeypatch.setenv(k, mode)
    feeds = _gan_feeds(np.random.default_rng(9), 2)
    jmain, want, final, persist, fetch = _reference('gan', feeds)
    got, state, texe = _port_run(jmain, persist, feeds, fetch)
    tol_loss, tol_grad = TOL_AMP[mode]
    for g, w in zip(got, want):
        for a, b in zip(g[:2], w[:2]):
            assert abs(float(a[0]) - float(b[0])) <= tol_loss * abs(
                float(b[0]))
        for a, b in zip(g[2:], w[2:]):
            assert np.linalg.norm(a - b) <= tol_grad * np.linalg.norm(b)
    assert texe.last_graph_opt_report['amp']['ops_lowered'] > 0


def test_gan_through_run_steps():
    feeds = _gan_feeds(np.random.default_rng(7))
    jmain, want, final, persist, fetch = _reference('gan', feeds)
    got, state, _ = _port_run(jmain, persist, feeds, fetch, steps=True)
    gaps = _gaps(got, want, final, state, 2)
    assert _within(gaps), gaps


def test_fit_a_line_three_steps_match_the_reference():
    samples = list(datasets.uci_housing.train()())[:24]
    feeds = [{'x': np.stack([s[0] for s in samples[i:i + 8]]),
              'y': np.stack([s[1] for s in samples[i:i + 8]])}
             for i in (0, 8, 16)]
    jmain, want, final, persist, fetch = _reference('fit_a_line', feeds)
    got, state, _ = _port_run(jmain, persist, feeds, fetch)
    loss, grads, st = _gaps(got, want, final, state, 1)
    # the cost is O(500) at the init and the weights' gradients O(1e2):
    # 1e-5 of their size; SGD's state moves by lr times them
    assert loss <= TOL_LOSS and grads <= 1e-3 and st <= 1e-5, \
        (loss, grads, st)


@pytest.mark.parametrize('split', ['train', 'test'])
def test_uci_housing_samples_are_the_references(split):
    got = list(getattr(datasets.uci_housing, split)()())
    want = list(getattr(jdatasets.uci_housing, split)()())
    assert len(got) == len(want) == {'train': 404, 'test': 102}[split]
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32 and gy.shape == (1,)
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_gan_trains():
    """tests/book/test_gan.py through the port."""
    main, startup = tfl.Program(), tfl.Program()
    main.random_seed = startup.random_seed = 11
    with tfl.program_guard(main, startup):
        img, noise, d_loss, g_loss, fake = gan.build(img_dim=IMG)
    place = tfl.CPUPlace()
    exe = tfl.Executor(place)
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=place, feed_list=[img], program=main)
    rng = np.random.default_rng(0)
    reader = tfl.batch(tfl.reader.firstn(datasets.mnist.train(), 256),
                       batch_size=32, drop_last=True)
    d_losses, g_losses = [], []
    for epoch in range(2):
        for batch in reader():
            feed = feeder.feed([(s[0],) for s in batch])
            feed['noise'] = rng.normal(
                size=(len(batch), gan.NOISE_DIM)).astype(np.float32)
            d, g = exe.run(main, feed=feed, fetch_list=[d_loss, g_loss],
                           scope=scope)
            d_losses.append(float(np.ravel(d)[0]))
            g_losses.append(float(np.ravel(g)[0]))
    assert np.isfinite(d_losses).all() and np.isfinite(g_losses).all()
    assert np.mean(d_losses[-4:]) < np.mean(d_losses[:2])
    assert np.mean(d_losses[-4:]) < 1.45, np.mean(d_losses[-4:])


def test_fit_a_line_converges():
    """tests/book/test_fit_a_line.py through the port."""
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        x, y, y_predict, avg_cost = fit_a_line.build()
        tfl.optimizer.SGDOptimizer(learning_rate=0.01).minimize(avg_cost)
    place = tfl.CPUPlace()
    exe = tfl.Executor(place)
    scope = tfl.Scope()
    exe.run(startup, scope=scope)
    feeder = tfl.DataFeeder(place=place, feed_list=[x, y], program=main)
    reader = tfl.batch(
        tfl.reader.shuffle(datasets.uci_housing.train(), buf_size=256),
        batch_size=32, drop_last=True)
    first = last = None
    for epoch in range(12):
        for data in reader():
            out, = exe.run(main, feed=feeder.feed(data),
                           fetch_list=[avg_cost], scope=scope)
            if first is None:
                first = float(np.ravel(out)[0])
            last = float(np.ravel(out)[0])
        if last < 12.0:
            break
    assert last < first, (first, last)
    assert last < 12.0, "cost %.3f did not reach threshold" % last


@pytest.mark.parametrize('wrt,rolled', [
    ('x', ['fc_0.b_0', 'fc_0.w_0']),
    ('fc_0.tmp_0', ['fc_0.b_0']),   # the product comes from the first pass
    ('fc_0.w_0', ['fc_0.b_0', 'fc_0.w_0'])])
def test_calc_gradient_after_minimize(wrt, rolled):
    """A second autodiff op from ``calc_gradient`` after fit_a_line's SGD
    ``minimize``: its gradient reads the fc's parameters from before the
    update (their readers ran before it), with respect to a fed input,
    an intermediate (the first pass's value) or the updated weight
    itself."""
    def build(pkg):
        m = _models(pkg)
        with m.prog.reset_unique_name_guard():
            main, startup = pkg.Program(), pkg.Program()
            main.random_seed = startup.random_seed = 11
            with pkg.program_guard(main, startup):
                x, y, y_pred, cost = m.fit.build()
                pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(cost)
                g, = pkg.backward.calc_gradient(
                    cost, [main.global_block().var(wrt)])
        return main, startup, [cost, g]

    samples = list(datasets.uci_housing.train()())[:16]
    feeds = [{'x': np.stack([s[0] for s in samples[i:i + 8]]),
              'y': np.stack([s[1] for s in samples[i:i + 8]])}
             for i in (0, 8)]
    jmain, jstartup, jfetch = build(fluid)
    tmain, _, _ = build(tfl)
    assert tmain.to_dict() == jmain.to_dict()
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.array(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    fetch = [v.name for v in jfetch]
    want = [jexe.run(jmain, feed=f, fetch_list=fetch, scope=jscope)
            for f in feeds]
    got, state, texe = _port_run(jmain, persist, feeds, fetch)
    for g, w in zip(got, want):
        assert abs(float(g[0][0]) - float(w[0][0])) <= TOL_LOSS * abs(
            float(w[0][0]))
        assert np.abs(g[1] - w[1]).max() <= 1e-5 * np.abs(w[1]).max()
    plan, = texe._plans.values()
    later, = [gp for gp in plan.passes.values() if not gp.publish]
    assert sorted(later.rollback) == rolled

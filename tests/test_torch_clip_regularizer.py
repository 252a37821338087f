"""Gradient clip, error clip and the regularizers through the port's
``minimize`` (paddle_tpu_torch/clip.py, regularizer.py, optimizer.py)
against the reference's (paddle_tpu/clip.py, regularizer.py,
optimizer.py), on the CPU.

- The programs and cases of tests/test_clip_regularizer.py through both
  packages: y = w.x under a huge loss gradient, one SGD step with no
  clip and with each of GradientClipByValue, ByNorm and ByGlobalNorm;
  L2Decay and L1Decay shrinking w under a zero data gradient.  Each
  program serialises to exactly the reference's, the port's step
  matches the reference's, and the reference test's own bounds hold.
- SGD + L2Decay folds into the ``sgd`` op's ``weight_decay`` where the
  reference folds (a dense float32 gradient, the decay set on the
  parameter or on the optimizer) and weaves a ``scale`` and a ``sum``
  op where it weaves (L1, Momentum, a sparse embedding's gradient).
- Three steps of a two-layer net under each optimizer (SGD, Momentum,
  Adam, Adagrad) with ``regularization=`` L2 or L1 and a global-norm
  clip, from the reference's initial state: the loss and every
  gradient each step, every parameter and accumulator after.
- ErrorClipByValue on a hidden activation and on a parameter: the
  gradients match the reference's and differ from the unclipped ones;
  ``append_backward(callbacks=[error_clip_callback])`` adds no op.

Tolerances: the one-step cases 1e-5 relative (gradients of ~1e3);
the three-step runs 1e-5 absolute on losses and state and 1e-5 of
max(1e-2, the largest entry) on gradients (float32 sums of at most 16
products in other orders; Adam's and Adagrad's steps are lr * g / (|g| +
eps)-like, sign-like where a gradient sits near float32 noise, which a
clip by global norm does not create here: the smallest entries are
~1e-3).
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.core.backward import append_backward as jappend_backward

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.backward import \
    append_backward as tappend_backward
from paddle_tpu_torch.core.scope import scope_from_numpy

TOL_ONE = 1e-5
TOL = 1e-5
TOL_GRAD_REL = 1e-5


def _programs(pkg, build, seed=3):
    prog_mod = jprog if pkg is fluid else tprog
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup):
            fetch = build(pkg)
    return main, startup, fetch


def _both(build, seed=3):
    """Both packages' programs (equal as data), the reference's initial
    state, and an executor and scope for each."""
    jm, js, jf = _programs(fluid, build, seed)
    tm, ts, tf = _programs(tfl, build, seed)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jm.list_vars()
               if v.persistable and jscope.has(v.name)}
    return dict(jm=jm, tm=tm, jf=jf, tf=tf, jscope=jscope, jexe=jexe,
                tscope=scope_from_numpy(persist, 'cpu'),
                texe=tfl.Executor(tfl.CPUPlace()), persist=persist)


def _linear(clip=None, regularizer=None, lr=1.0):
    """tests/test_clip_regularizer.py's model: y = w.x, mean square error,
    SGD."""
    def build(pkg):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        p = pkg.layers.fc(
            input=x, size=1, bias_attr=False,
            param_attr=pkg.ParamAttr(name='w', regularizer=regularizer(pkg)
                                     if regularizer else None))
        loss = pkg.layers.mean(
            x=pkg.layers.square_error_cost(input=p, label=y))
        if clip is not None:
            pkg.clip.set_gradient_clip(clip(pkg))
        try:
            pkg.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
        finally:
            pkg.clip.set_gradient_clip(None)
        return loss
    return build


def _step_w(h, feed):
    """w before, and after one step on each side."""
    before = h['persist']['w'].copy()
    h['jexe'].run(h['jm'], feed=feed, fetch_list=[h['jf']],
                  scope=h['jscope'])
    h['texe'].run(h['tm'], feed=feed, fetch_list=[h['tf'].name],
                  scope=h['tscope'])
    return before, h['tscope'].get_numpy('w'), np.asarray(
        h['jscope'].get('w'))


CLIPS = {
    'none': None,
    'global_norm': lambda pkg: pkg.clip.GradientClipByGlobalNorm(
        clip_norm=0.1),
    'value': lambda pkg: pkg.clip.GradientClipByValue(max=0.05, min=-0.05),
    'norm': lambda pkg: pkg.clip.GradientClipByNorm(clip_norm=0.2),
}


@pytest.mark.parametrize('name', sorted(CLIPS))
def test_gradient_clip_step_matches_the_reference(name):
    h = _both(_linear(clip=CLIPS[name]))
    feed = {'x': np.ones((2, 4), 'float32'),
            'y': np.full((2, 1), 1000.0, 'float32')}
    b, got, want = _step_w(h, feed)
    np.testing.assert_allclose(got, want, rtol=TOL_ONE, atol=TOL_ONE)
    delta = got - b
    if name == 'none':
        assert np.abs(delta).max() > 10
    elif name == 'global_norm':
        assert np.linalg.norm(delta) <= 0.1 + 1e-5
    elif name == 'value':
        assert np.abs(delta).max() <= 0.05 + 1e-6
    else:
        assert np.linalg.norm(delta) <= 0.2 + 1e-5
    ops = [op.type for op in h['tm'].global_block().ops]
    assert {'none': 'autodiff', 'global_norm': 'sqrt', 'value': 'clip',
            'norm': 'clip_by_norm'}[name] in ops


@pytest.mark.parametrize('reg', ['l2', 'l1'])
def test_regularizer_shrinks_weights_as_the_reference(reg):
    cls = (lambda pkg: pkg.regularizer.L2Decay(0.1)) if reg == 'l2' else \
        (lambda pkg: pkg.regularizer.L1Decay(0.1))
    h = _both(_linear(regularizer=cls, lr=0.5), seed=5)
    feed = {'x': np.zeros((2, 4), 'float32'),
            'y': np.zeros((2, 1), 'float32')}
    w0, got, want = _step_w(h, feed)
    np.testing.assert_allclose(got, want, rtol=TOL_ONE, atol=1e-7)
    if reg == 'l2':
        np.testing.assert_allclose(got, w0 * (1 - 0.5 * 0.1), rtol=1e-4)
    else:
        np.testing.assert_allclose(got, w0 - 0.5 * 0.1 * np.sign(w0),
                                   rtol=1e-4, atol=1e-6)
    assert np.abs(got).sum() < np.abs(w0).sum()


def _fold_case(kind):
    def build(pkg):
        reg = pkg.regularizer.L1Decay(0.01) if kind == 'l1' else \
            pkg.regularizer.L2Decay(0.01)
        on_param = kind == 'param_l2'
        if kind == 'sparse':
            ids = pkg.layers.data(name='ids', shape=[1], dtype='int64')
            x = pkg.layers.embedding(input=ids, size=[20, 4],
                                     is_sparse=True)
        else:
            x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        p = pkg.layers.fc(input=x, size=1, param_attr=pkg.ParamAttr(
            name='w', regularizer=reg if on_param else None))
        loss = pkg.layers.mean(
            x=pkg.layers.square_error_cost(input=p, label=y))
        opt_reg = None if on_param else reg
        if kind == 'momentum':
            opt = pkg.optimizer.MomentumOptimizer(
                learning_rate=0.1, momentum=0.9, regularization=opt_reg)
        else:
            opt = pkg.optimizer.SGDOptimizer(learning_rate=0.1,
                                             regularization=opt_reg)
        opt.minimize(loss)
        return loss
    return build


@pytest.mark.parametrize('kind,folded', [
    ('l2', {'w', 'fc_0.b_0'}), ('param_l2', {'w'}), ('l1', set()),
    ('momentum', set()), ('sparse', {'w', 'fc_0.b_0'})])
def test_sgd_folds_l2_where_the_reference_folds(kind, folded):
    h = _both(_fold_case(kind))
    ops = h['tm'].global_block().ops
    wd = {op.input('Param')[0]: op.attrs.get('weight_decay')
          for op in ops if op.type in ('sgd', 'momentum')}
    assert {n for n, v in wd.items() if v} == folded
    assert all(wd[n] == 0.01 for n in folded)
    woven = {op.output('Out')[0] for op in ops if op.type == 'sum'}
    want_woven = {n + '@GRAD_reg' for n in wd if n not in folded}
    if kind == 'param_l2':
        want_woven = set()
    assert woven == want_woven
    if kind == 'sparse':
        # the table's SelectedRows gradient keeps the weave
        emb = [n for n in wd if n.startswith('embedding')]
        assert emb and not any(wd[n] for n in emb)
        assert emb[0] + '@GRAD_reg' in woven


def _mlp(opt_name, reg):
    """Two fc layers (8 -> 16 relu -> 1) under ``opt_name`` with
    ``regularization=reg`` and a global-norm clip of 1.0."""
    def build(pkg):
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=x, size=16, act='relu')
        p = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(
            x=pkg.layers.square_error_cost(input=p, label=y))
        r = pkg.regularizer.L2Decay(0.05) if reg == 'l2' else \
            pkg.regularizer.L1Decay(0.05)
        kw = dict(regularization=r)
        opt = {'sgd': lambda: pkg.optimizer.SGDOptimizer(0.1, **kw),
               'momentum': lambda: pkg.optimizer.MomentumOptimizer(
                   0.1, 0.9, **kw),
               'adam': lambda: pkg.optimizer.AdamOptimizer(0.01, **kw),
               'adagrad': lambda: pkg.optimizer.AdagradOptimizer(
                   0.1, **kw)}[opt_name]()
        pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByGlobalNorm(clip_norm=1.0))
        try:
            opt.minimize(loss)
        finally:
            pkg.clip.set_gradient_clip(None)
        return loss
    return build


def _feeds(n=3, seed=11):
    rng = np.random.default_rng(seed)
    return [{'x': rng.standard_normal((6, 8)).astype(np.float32),
             'y': (3.0 * rng.standard_normal((6, 1))).astype(np.float32)}
            for _ in range(n)]


def _steps_match(h, feeds):
    params = [p.name for p in h['jm'].all_parameters()]
    fetch = [h['jf'].name] + [p + '@GRAD' for p in params]
    for feed in feeds:
        want = h['jexe'].run(h['jm'], feed=feed, fetch_list=fetch,
                             scope=h['jscope'])
        got = h['texe'].run(h['tm'], feed=feed, fetch_list=fetch,
                            scope=h['tscope'])
        assert abs(float(got[0][0]) - float(want[0][0])) <= TOL
        for a, b in zip(got[1:], want[1:]):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= TOL_GRAD_REL * max(
                1e-2, np.abs(b).max())
    for n in h['persist']:
        a, b = h['tscope'].get_numpy(n), np.asarray(h['jscope'].get(n))
        assert np.abs(a - b).max() <= TOL, n
    return params


@pytest.mark.parametrize('reg', ['l2', 'l1'])
@pytest.mark.parametrize('opt', ['sgd', 'momentum', 'adam', 'adagrad'])
def test_regularized_clipped_steps_match_the_reference(opt, reg):
    h = _both(_mlp(opt, reg))
    params = _steps_match(h, _feeds())
    ops = [op.type for op in h['tm'].global_block().ops]
    assert ops.count('reduce_sum') == len(params) and 'sqrt' in ops
    folded = opt == 'sgd' and reg == 'l2'
    assert ops.count('sum') == (1 if folded else 1 + len(params))


def _error_clip(target, clip=True):
    """``_mlp``'s net under SGD, with an error clip on the hidden
    activation or on the first layer's weight."""
    def build(pkg):
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=x, size=16, act='relu')
        p = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(
            x=pkg.layers.square_error_cost(input=p, label=y))
        var = h if target == 'activation' else \
            pkg.default_main_program().global_block().var('fc_0.w_0')
        if clip:
            var.error_clip = pkg.clip.ErrorClipByValue(max=2e-3)
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
        return loss
    return build


@pytest.mark.parametrize('target', ['activation', 'parameter'])
def test_error_clip_matches_the_reference(target):
    feeds = _feeds()
    h = _both(_error_clip(target))
    _steps_match(h, feeds)
    free = _both(_error_clip(target, clip=False))
    fetch = ['fc_0.w_0@GRAD']
    a = h['texe'].run(h['tm'], feed=feeds[0], fetch_list=fetch,
                      scope=scope_from_numpy(h['persist'], 'cpu'))[0]
    b = free['texe'].run(free['tm'], feed=feeds[0], fetch_list=fetch,
                         scope=free['tscope'])[0]
    assert np.abs(a - b).max() > 1e-3   # the clip changed the gradient
    if target == 'parameter':
        assert np.abs(a).max() <= 2e-3 + 1e-9


@pytest.mark.parametrize('pkg,append_backward', [
    (fluid, jappend_backward), (tfl, tappend_backward)])
def test_error_clip_callback_adds_no_op(pkg, append_backward):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        x = pkg.layers.data(name='x', shape=[2], dtype='float32')
        loss = pkg.layers.mean(x=pkg.layers.fc(input=x, size=1))
        n = len(main.global_block().ops)
        append_backward(loss, callbacks=[pkg.clip.error_clip_callback])
    assert [op.type for op in main.global_block().ops[n:]] == ['autodiff']

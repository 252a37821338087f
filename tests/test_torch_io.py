"""Persistence in the port (paddle_tpu_torch/io.py) against the
reference's (paddle_tpu/io.py).

The reference's non-sharded tests/test_io.py cases through the port:
the params round trip, the inference model, checkpoint and resume (into
a fresh executor and into the live one), a changed program refused, the
generation equal to step + 1 and rising save by save, a crash before the
manifest leaving the old checkpoint whole, the generation sweep keeping
the rollback, a dotted var name's legacy file kept, STEP.prev archived
only when the step changes, a rollback re-save archiving the pair it
supersedes, ``rollback_checkpoint``, a rollback to a step-less
checkpoint clearing STEP.  Every model starts from the reference's
startup state, copied in (``scope_from_numpy``).

Cross-package: checkpoints and inference models saved by either package
load in the other, every value bitwise equal, in float32 and bfloat16
(the port writes bfloat16 as its uint16 bits, the reference as numpy's
raw ``|V2``), and a sharded checkpoint as the reference's own tests
write one on this CPU (two hosts' manifests of disjoint row blocks)
loads assembled.  The forward of a model loaded across runs within
1e-6 of the saving side's (float32: XLA and torch sum the fc's
products in other orders; O(1) values).
"""
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import io as jio
from paddle_tpu.core import program as jprog

import paddle_tpu_torch as tfl
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.scope import scope_from_numpy

TOL_FWD = 1e-6


@pytest.fixture(autouse=True)
def _fresh_names():
    with jprog.reset_unique_name_guard(), tprog.reset_unique_name_guard():
        yield


def _build(pkg, hidden=8, adam=False, seed=7):
    """The reference test's model: x[4] -> fc(hidden, relu) -> fc(1),
    square error, SGD 0.01 (or Adam 0.01)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(input=x, size=hidden, act='relu')
        pred = pkg.layers.fc(input=h, size=1, act=None)
        loss = pkg.layers.mean(
            x=pkg.layers.square_error_cost(input=pred, label=y))
        opt = (pkg.optimizer.AdamOptimizer(learning_rate=0.01) if adam
               else pkg.optimizer.SGDOptimizer(learning_rate=0.01))
        opt.minimize(loss)
    return main, startup, pred, loss


def _ref_state(hidden=8, adam=False):
    """The reference's startup state of ``_build`` as numpy arrays."""
    with jprog.reset_unique_name_guard():
        main, startup, _, _ = _build(fluid, hidden, adam)
    scope = fluid.core.scope.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in startup.list_vars() if v.persistable and
            scope.find_var(v.name) is not None}


def _port(hidden=8, adam=False):
    """(main, pred, loss, executor, scope) of the port's model from the
    reference's startup state."""
    state = _ref_state(hidden, adam)
    with tprog.reset_unique_name_guard():
        main, _, pred, loss = _build(tfl, hidden, adam)
    return main, pred, loss, tfl.Executor(tfl.CPUPlace()), \
        scope_from_numpy(state, 'cpu')


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype('float32')
    out = []
    for _ in range(n):
        xb = rng.randn(8, 4).astype('float32')
        out.append({'x': xb, 'y': xb @ w})
    return out


def _train(exe, main, loss, scope, n, seed=0):
    res = None
    for feed in _batches(n, seed):
        res = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return float(np.ravel(res[0])[0])


def _persistables(main, scope):
    # copies: a CPU tensor's numpy view follows its in-place updates
    return {v.name: scope.get_numpy(v.name).copy()
            for v in main.list_vars()
            if v.persistable and scope.has(v.name)}


def _assert_state(scope, want):
    for name, val in want.items():
        np.testing.assert_array_equal(scope.get_numpy(name), val,
                                      err_msg=name)


def _clobber(scope, names):
    for name in names:
        scope.set(name, torch.zeros_like(scope.get(name)))


def _gens(d):
    return {int(m.group(1)) for f in glob.glob(d + '/*.npy')
            for m in [re.search(r'\.g(\d+)\.', os.path.basename(f))] if m}


def test_save_load_params_roundtrip(tmp_path):
    main, pred, loss, exe, scope = _port()
    _train(exe, main, loss, scope, 3)
    params = {p.name: scope.get_numpy(p.name).copy()
              for p in main.list_vars() if tio.is_parameter(p)}
    assert len(params) == 4
    tio.save_params(exe, str(tmp_path / 'params'), main, scope=scope)
    _clobber(scope, params)
    tio.load_params(exe, str(tmp_path / 'params'), main, scope=scope)
    _assert_state(scope, params)
    assert scope.get('fc_0.w_0').device.type == 'cpu'


def test_inference_model_roundtrip(tmp_path):
    main, pred, loss, exe, scope = _port()
    _train(exe, main, loss, scope, 2)
    xb = np.random.RandomState(1).randn(5, 4).astype('float32')
    infer = tio.get_inference_program([pred], main)
    assert [op.type for op in infer.global_block().ops] == [
        'mul', 'elementwise_add', 'relu', 'mul', 'elementwise_add']
    want = exe.run(infer, feed={'x': xb}, fetch_list=[pred], scope=scope)[0]
    d = str(tmp_path / 'model')
    with tfl.scope_guard(scope):
        tio.save_inference_model(d, ['x'], [pred], exe, main)
    fresh = tfl.Scope()
    with tfl.scope_guard(fresh):
        prog, feeds, fetches = tio.load_inference_model(
            d, tfl.Executor(tfl.CPUPlace()))
    assert feeds == ['x'] and [v.name for v in fetches] == [pred.name]
    got = tfl.Executor(tfl.CPUPlace()).run(
        prog, feed={'x': xb}, fetch_list=fetches, scope=fresh)[0]
    np.testing.assert_array_equal(got, want)


def test_checkpoint_resume(tmp_path):
    main, pred, loss, exe, scope = _port()
    _train(exe, main, loss, scope, 3)
    d = str(tmp_path / 'ckpt')
    tio.save_checkpoint(exe, d, main, step=3, scope=scope)
    persist = _persistables(main, scope)
    nxt = _batches(1, seed=9)[0]
    want_next = exe.run(main, feed=nxt, fetch_list=[loss], scope=scope)[0]
    _train(exe, main, loss, scope, 3, seed=9)
    assert any(not np.array_equal(scope.get_numpy(n), v)
               for n, v in persist.items())
    # into the live executor, whose plan is kept: its next step sees it
    assert tio.load_checkpoint(exe, d, main, scope=scope) == 3
    _assert_state(scope, persist)
    got = exe.run(main, feed=nxt, fetch_list=[loss], scope=scope)[0]
    np.testing.assert_array_equal(got, want_next)
    # into a fresh scope and executor
    fresh = tfl.Scope()
    assert tio.load_checkpoint(tfl.Executor(tfl.CPUPlace()), d, main,
                               scope=fresh) == 3
    _assert_state(fresh, persist)


def test_checkpoint_mismatch_raises(tmp_path):
    main, pred, loss, exe, scope = _port(hidden=32, adam=True)
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
    d = str(tmp_path / 'ckpt_mismatch')
    tio.save_checkpoint(exe, d, main, scope=scope)
    with tprog.reset_unique_name_guard():
        main2, _, _, _ = _build(tfl, hidden=64, adam=True)
    with pytest.raises(ValueError, match='declares'):
        tio.load_checkpoint(exe, d, main2, scope=tfl.Scope())


def test_save_checkpoint_generation_is_step(tmp_path):
    main, pred, loss, exe, scope = _port()
    d = str(tmp_path / 'stepgen')
    tio.save_checkpoint(exe, d, main, step=7, scope=scope)
    assert {r['gen'] for r in tio._read_manifest(d)['vars'].values()} == {8}


def test_save_generation_increments(tmp_path):
    main, pred, loss, exe, scope = _port()
    d = str(tmp_path / 'gen')
    tio.save_params(exe, d, main, scope=scope)
    g1 = {n: r['gen'] for n, r in tio._read_manifest(d)['vars'].items()}
    tio.save_params(exe, d, main, scope=scope)
    g2 = {n: r['gen'] for n, r in tio._read_manifest(d)['vars'].items()}
    assert g1 and all(g2[n] == g1[n] + 1 for n in g1)


def test_crash_before_manifest_preserves_old_checkpoint(tmp_path,
                                                        monkeypatch):
    main, pred, loss, exe, scope = _port()
    _train(exe, main, loss, scope, 2)
    d = str(tmp_path / 'torn')
    tio.save_checkpoint(exe, d, main, step=1, scope=scope)
    saved = _persistables(main, scope)
    _train(exe, main, loss, scope, 2, seed=1)

    def no_manifest(dirname, manifest):
        raise RuntimeError('killed before manifest write')

    monkeypatch.setattr(tio, '_write_manifest', no_manifest)
    with pytest.raises(RuntimeError, match='killed'):
        tio.save_checkpoint(exe, d, main, step=2, scope=scope)
    monkeypatch.undo()
    _clobber(scope, saved)
    assert tio.load_checkpoint(exe, d, main, scope=scope) == 1
    _assert_state(scope, saved)
    # the torn generation 3 is spared at the next save and swept at the
    # one after; the archived .prev's generation survives throughout
    _train(exe, main, loss, scope, 1, seed=2)
    tio.save_checkpoint(exe, d, main, step=3, scope=scope)
    assert _gens(d) == {2, 3, 4}
    os.replace(os.path.join(d, '__manifest__.json.prev'),
               os.path.join(d, '__manifest__.json'))
    tio.load_persistables(exe, d, main, scope=scope)
    _assert_state(scope, saved)
    tio.save_checkpoint(exe, d, main, step=4, scope=scope)
    assert _gens(d) == {2, 4, 5}


def test_generation_gc_keeps_rollback(tmp_path):
    main, pred, loss, exe, scope = _port()
    d = str(tmp_path / 'gc')
    at_step = {}
    for step in (1, 2, 3):
        _train(exe, main, loss, scope, 1, seed=step)
        tio.save_checkpoint(exe, d, main, step=step, scope=scope)
        at_step[step] = _persistables(main, scope)
    assert _gens(d) == {3, 4}
    _clobber(scope, at_step[3])
    assert tio.load_checkpoint(exe, d, main, scope=scope) == 3
    _assert_state(scope, at_step[3])
    os.replace(os.path.join(d, '__manifest__.json.prev'),
               os.path.join(d, '__manifest__.json'))
    os.replace(os.path.join(d, 'STEP.prev'), os.path.join(d, 'STEP'))
    assert tio.load_checkpoint(exe, d, main, scope=scope) == 2
    _assert_state(scope, at_step[2])


def test_gc_never_deletes_legacy_file_of_dotted_var_name(tmp_path):
    d = str(tmp_path)
    np.save(os.path.join(d, 'w.g5.npy'), np.zeros(2))   # legacy of 'w.g5'
    np.save(os.path.join(d, 'w.g1.npy'), np.zeros(2))   # gen 1 of 'w'
    tio._gc_stale_generations(d, ['w', 'w.g5'], floor_gen=9)
    left = sorted(os.listdir(d))
    assert 'w.g5.npy' in left and 'w.g1.npy' not in left


def test_step_prev_archives_only_on_advance(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 2):
        tio.write_step_file(d, step)
    assert open(os.path.join(d, 'STEP.prev')).read().strip() == '1'
    assert open(os.path.join(d, 'STEP')).read().strip() == '2'


def test_downgrade_resave_archives_consistent_prev_pair(tmp_path):
    main, pred, loss, exe, scope = _port()
    d = str(tmp_path / 'downgrade')
    _train(exe, main, loss, scope, 2)
    tio.save_checkpoint(exe, d, main, step=9, scope=scope)
    _train(exe, main, loss, scope, 2, seed=1)
    tio.save_checkpoint(exe, d, main, step=10, scope=scope)
    at_10 = _persistables(main, scope)
    _train(exe, main, loss, scope, 2, seed=2)
    tio.save_checkpoint(exe, d, main, step=3, scope=scope)
    assert int(open(os.path.join(d, 'STEP')).read()) == 3
    assert int(open(os.path.join(d, 'STEP.prev')).read()) == 10
    assert tio.rollback_checkpoint(d) == 10
    _clobber(scope, at_10)
    assert tio.load_checkpoint(exe, d, main, scope=scope) == 10
    _assert_state(scope, at_10)
    tio.save_checkpoint(exe, d, main, step=11, scope=scope)
    tio.save_checkpoint(exe, d, main, step=11, scope=scope)
    assert int(open(os.path.join(d, 'STEP.prev')).read()) == 10


def test_rollback_checkpoint_helper(tmp_path):
    main, pred, loss, exe, scope = _port()
    d = str(tmp_path / 'rb')
    with pytest.raises(ValueError, match='nothing to roll back'):
        tio.rollback_checkpoint(d)
    _train(exe, main, loss, scope, 2)
    tio.save_checkpoint(exe, d, main, step=1, scope=scope)
    at_1 = _persistables(main, scope)
    _train(exe, main, loss, scope, 2, seed=5)
    tio.save_checkpoint(exe, d, main, step=2, scope=scope)
    assert tio.rollback_checkpoint(d) == 1
    _clobber(scope, at_1)
    assert tio.load_checkpoint(exe, d, main, scope=scope) == 1
    _assert_state(scope, at_1)
    with pytest.raises(ValueError, match='nothing to roll back'):
        tio.rollback_checkpoint(d)


def test_rollback_to_stepless_checkpoint_clears_step(tmp_path):
    main, pred, loss, exe, scope = _port()
    d = str(tmp_path / 'stepless')
    tio.save_checkpoint(exe, d, main, scope=scope)
    _train(exe, main, loss, scope, 1)
    tio.save_checkpoint(exe, d, main, step=5, scope=scope)
    assert tio.rollback_checkpoint(d) is None
    assert not os.path.exists(os.path.join(d, 'STEP'))
    assert tio.load_checkpoint(exe, d, main, scope=scope) is None


# -- across the packages -------------------------------------------------

def _ref_trained(hidden=8, adam=True, steps=2):
    """The reference's model after ``steps`` steps: (main, pred, loss,
    executor, scope)."""
    with jprog.reset_unique_name_guard():
        main, startup, pred, loss = _build(fluid, hidden, adam)
    scope = fluid.core.scope.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for feed in _batches(steps):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return main, pred, loss, exe, scope


def _ref_persistables(main, scope):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    jmain, _, _, jexe, jscope = _ref_trained()
    d = str(tmp_path / 'ref_ckpt')
    jio.save_checkpoint(jexe, d, jmain, step=2, scope=jscope)
    want = _ref_persistables(jmain, jscope)
    assert any('moment' in n for n in want)
    with tprog.reset_unique_name_guard():
        tmain, _, _, _ = _build(tfl, adam=True)
    scope = tfl.Scope()
    assert tio.load_checkpoint(tfl.Executor(tfl.CPUPlace()), d, tmain,
                               scope=scope) == 2
    assert set(scope.local_var_names()) == set(want)
    _assert_state(scope, want)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    main, pred, loss, exe, scope = _port(adam=True)
    _train(exe, main, loss, scope, 2)
    d = str(tmp_path / 'port_ckpt')
    tio.save_checkpoint(exe, d, main, step=2, scope=scope)
    want = _persistables(main, scope)
    with jprog.reset_unique_name_guard():
        jmain, _, _, _ = _build(fluid, adam=True)
    jscope = fluid.core.scope.Scope()
    assert jio.load_checkpoint(fluid.Executor(fluid.CPUPlace()), d, jmain,
                               scope=jscope) == 2
    got = _ref_persistables(jmain, jscope)
    assert set(got) == set(want)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)


def _bf16_program(pkg):
    """x (bf16) -> mul by a bfloat16 parameter ``w16`` -> out."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[4], dtype='bfloat16')
        w = pkg.layers.create_parameter(
            shape=[4, 3], dtype='bfloat16', attr=pkg.ParamAttr(name='w16'))
        out = pkg.layers.mul(x=x, y=w)
    return main, out


_W16_BITS = np.random.default_rng(3).integers(
    0x3c00, 0x4000, (4, 3)).astype(np.uint16)   # O(1) bfloat16 values


def test_bfloat16_crosses_both_ways(tmp_path):
    import jax.numpy as jnp
    import ml_dtypes
    jbits = _W16_BITS.view(ml_dtypes.bfloat16)
    # the reference saves (numpy's raw |V2), the port loads the bits
    jmain, jout = _bf16_program(fluid)
    jscope = fluid.core.scope.Scope()
    jscope.set('w16', jnp.asarray(jbits))
    d1 = str(tmp_path / 'ref16')
    jio.save_persistables(None, d1, jmain, scope=jscope)
    assert json.load(open(os.path.join(d1, '__manifest__.json')))[
        'vars']['w16']['dtype'] == 'bfloat16'
    tmain, tout = _bf16_program(tfl)
    scope = tfl.Scope()
    tio.load_persistables(tfl.Executor(tfl.CPUPlace()), d1, tmain,
                          scope=scope)
    t = scope.get('w16')
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy().view(np.uint16), _W16_BITS)
    # the port saves (uint16 bits), the reference loads the bits
    d2 = str(tmp_path / 'port16')
    tio.save_persistables(None, d2, tmain, scope=scope)
    assert np.load(os.path.join(d2, 'w16.g1.npy')).dtype == np.uint16
    jscope2 = fluid.core.scope.Scope()
    jio.load_persistables(None, d2, jmain, scope=jscope2)
    got = np.asarray(jscope2.find_var('w16'))
    assert got.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.view(np.uint16), _W16_BITS)


def _ref_forward(prog, feed, fetches, scope):
    return np.asarray(fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetches, scope=scope)[0])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_inference_models_cross_both_ways(tmp_path, dtype):
    xb = np.random.RandomState(1).randn(5, 4).astype('float32')
    if dtype == 'float32':
        jmain, jpred, _, jexe, jscope = _ref_trained()
        jstate = _ref_persistables(jmain, jscope)
    else:
        import jax.numpy as jnp
        import ml_dtypes
        jmain, jpred = _bf16_program(fluid)
        jexe, jscope = fluid.Executor(fluid.CPUPlace()), \
            fluid.core.scope.Scope()
        jscope.set('w16', jnp.asarray(_W16_BITS.view(ml_dtypes.bfloat16)))
        jstate = {'w16': _W16_BITS}
        xb = xb.astype(ml_dtypes.bfloat16)
    # reference -> port
    d1 = str(tmp_path / 'ref_model')
    with fluid.scope_guard(jscope):
        jio.save_inference_model(d1, ['x'], [jpred], jexe, jmain)
    want = _ref_forward(jio.get_inference_program([jpred], jmain),
                        {'x': xb}, [jpred], jscope)
    scope = tfl.Scope()
    texe = tfl.Executor(tfl.CPUPlace())
    with tfl.scope_guard(scope):
        prog, feeds, fetches = tio.load_inference_model(d1, texe)
    for n, v in jstate.items():
        t = scope.get(n)
        bits = (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
        np.testing.assert_array_equal(bits, v, err_msg=n)
    tfeed = ({'x': xb} if dtype == 'float32' else
             {'x': torch.from_numpy(xb.view(np.int16)).view(torch.bfloat16)})
    got = texe.run(prog, feed=tfeed, fetch_list=fetches, scope=scope,
                   return_numpy=False)[0].float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL_FWD if dtype == 'float32' else 0.02,
                               rtol=0 if dtype == 'float32' else 0.01)
    # port -> reference
    d2 = str(tmp_path / 'port_model')
    with tfl.scope_guard(scope):
        tio.save_inference_model(d2, feeds, fetches, texe, prog)
    jscope2 = fluid.core.scope.Scope()
    with fluid.scope_guard(jscope2):
        jprog2, jfeeds, jfetches = jio.load_inference_model(
            d2, fluid.Executor(fluid.CPUPlace()))
    assert jfeeds == ['x']
    for n, v in jstate.items():
        a = np.asarray(jscope2.find_var(n))
        np.testing.assert_array_equal(
            a.view(np.uint16) if dtype == 'bfloat16' else a, v, err_msg=n)
    again = _ref_forward(jprog2, {'x': xb}, jfetches, jscope2)
    np.testing.assert_array_equal(np.asarray(again, np.float32),
                                  np.asarray(want, np.float32))


def test_reference_multihost_sharded_checkpoint_loads_assembled(tmp_path):
    """Two hosts' disjoint row blocks of one var, each with its own
    manifest, as the reference's tests/test_io.py writes them."""
    d = str(tmp_path / 'mh')
    os.makedirs(d)
    full = np.arange(64, dtype='float32').reshape(8, 8)
    for k, rows in ((0, [(0, 2), (2, 4)]), (1, [(4, 6), (6, 8)])):
        shards = []
        for a, b in rows:
            idx = ((a, b), (0, 8))
            fname = jio._shard_filename('w', idx)
            np.save(os.path.join(d, fname), full[a:b])
            shards.append({'index': [list(p) for p in idx], 'file': fname})
        with open(os.path.join(d, '__manifest__.p%d.json' % k), 'w') as f:
            json.dump({'format_version': 1, 'vars': {'w': {
                'shape': [8, 8], 'dtype': 'float32',
                'spec': ['fsdp', None], 'shards': shards}}}, f)
    merged = tio._read_manifest(d)
    assert len(merged['vars']['w']['shards']) == 4
    scope = tfl.Scope()
    assert tio.load_vars(tfl.Executor(tfl.CPUPlace()), d, vars=['w'],
                         scope=scope) == 1
    np.testing.assert_array_equal(scope.get_numpy('w'), full)
    # a host missing: the load refuses the partial array
    os.remove(os.path.join(d, '__manifest__.p1.json'))
    with pytest.raises(ValueError, match='incomplete'):
        tio.load_vars(tfl.Executor(tfl.CPUPlace()), d, vars=['w'],
                      scope=tfl.Scope())


def test_f16_loss_scale_state_is_left_out_by_both(tmp_path, monkeypatch):
    """The f16 loss-scale state is declared on the AMP pass's rewritten
    copy of the program, not on the user's: ``save_checkpoint`` of the
    user's program leaves it out, in the reference as in the port (a
    resumed f16 run starts again from the initial scale)."""
    monkeypatch.setenv('PADDLE_TPU_AMP', 'f16')
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'f16')
    jmain, jpred, jloss, jexe, jscope = _ref_trained(adam=True, steps=2)
    assert jscope.find_var('@amp_loss_scale@') is not None
    d1 = str(tmp_path / 'ref')
    jio.save_checkpoint(jexe, d1, jmain, step=2, scope=jscope)
    main, pred, loss, exe, scope = _port(adam=True)
    _train(exe, main, loss, scope, 2)
    assert scope.has('@amp_loss_scale@')
    d2 = str(tmp_path / 'port')
    tio.save_checkpoint(exe, d2, main, step=2, scope=scope)
    saved = [set(tio._read_manifest(d)['vars']) for d in (d1, d2)]
    assert saved[0] == saved[1]
    for names in saved:
        assert not any(n.startswith('@amp_') for n in names)

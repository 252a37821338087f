"""The port's IR verifier and pass manager (paddle_tpu_torch/transpiler/
verify.py, pass_manager.py) against the reference's.

The reference's tests/test_verify.py cases that exist in the port (the
port has no sub-blocks, sharding, embedding lowering or collective
overlap yet): each golden broken program is built in both packages and
both verifiers must give the same diagnostics, word for word, among them
the reference test's own.  The mutation matrix corrupts one pass's output
at a time (the reference's corruptions) and ``every_pass`` mode must name
that pass.  Then the executor: the plan key (graph-opt level, AMP mode,
verify mode) re-keys ``run`` and ``run_steps``, the per-pass report, a
verifier rejection raising, ``off`` restoring the executor's own
KeyError, and dropout streams unchanged by the pipeline.

Recorded departure: a pass that raises makes ``run_pipeline`` raise (the
reference skips it and reports it; a skipped ``amp`` pass would train in
float32 while the run says bf16).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.transpiler import verify as jverify

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.transpiler import pass_manager as pm
from paddle_tpu_torch.transpiler import verify
from paddle_tpu_torch.transpiler.verify import IRVerificationError

SIDES = {'ref': (fluid, jprog, jverify), 'port': (tfl, tprog, verify)}


@pytest.fixture(autouse=True)
def _fresh_names():
    """Every test builds under fresh name counters in both packages, so
    no name it draws shifts another test's in the same process."""
    with jprog.reset_unique_name_guard(), tprog.reset_unique_name_guard():
        yield


def _data_program(pkg):
    """x -> scale -> add -> y, plus a persistable counter write."""
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        h = pkg.layers.scale(x, scale=2.0)
        y = pkg.layers.elementwise_add(h, h)
        w = main.global_block().create_var(
            name='w_persist', shape=[-1, 4], dtype='float32',
            persistable=True)
        main.global_block().append_op(
            type='assign', inputs={'X': [y]}, outputs={'Out': [w]})
    return main, y.name


def _both(make, check):
    """``make(pkg, prog_mod) -> program``; ``check(verify_mod, program)
    -> errors``.  Returns the port's errors after asserting that they
    equal the reference's."""
    errs = {}
    for side, (pkg, prog_mod, mod) in SIDES.items():
        with prog_mod.reset_unique_name_guard():
            errs[side] = check(mod, make(pkg, prog_mod))
    assert errs['port'] == errs['ref']
    return errs['port']


def _one_op(type, inputs, outputs, attrs):
    def make(pkg, prog_mod):
        main = prog_mod.Program()
        main.global_block().append_op(type=type, inputs=inputs,
                                      outputs=outputs, attrs=attrs)
        return main
    return make


def test_use_before_def_diagnostic():
    errs = _both(_one_op('scale', {'X': ['ghost']}, {'Out': ['y']},
                         {'scale': 2.0}),
                 lambda v, p: v.verify_program(p, fetch_names=('y',)))
    assert any("op #0 (scale) in block 0 reads 'ghost' before any "
               "definition" in e for e in errs), errs


def _declared(shape_x, shape_y, dtype_y):
    def make(pkg, prog_mod):
        main = prog_mod.Program()
        block = main.global_block()
        prog_mod.Variable(block, name='x', shape=shape_x, dtype='float32')
        prog_mod.Variable(block, name='y', shape=shape_y, dtype=dtype_y)
        block.append_op(type='scale', inputs={'X': ['x']},
                        outputs={'Out': ['y']}, attrs={'scale': 2.0})
        return main
    return make


def test_dtype_mismatched_vardesc_diagnostic():
    errs = _both(_declared((4,), (4,), 'int32'),
                 lambda v, p: v.verify_program(p, feed_names=('x',)))
    assert any("output 'y' is declared int32 but re-inference "
               "(core/infer.py) produces float32" in e for e in errs), errs


def test_shape_mismatched_vardesc_diagnostic():
    errs = _both(_declared((4, 3), (9, 9), 'float32'),
                 lambda v, p: v.verify_program(p, feed_names=('x',)))
    assert any("output 'y' is declared with shape (9, 9) but "
               "re-inference produces (4, 3)" in e for e in errs), errs


def test_duplicated_op_seq_diagnostic():
    def make(pkg, prog_mod):
        main = prog_mod.Program()
        block = main.global_block()
        for src, dst in (('x', 'h'), ('h', 'y')):
            block.append_op(type='scale', inputs={'X': [src]},
                            outputs={'Out': [dst]},
                            attrs={'scale': 2.0, 'op_seq': 3})
        return main
    errs = _both(make, lambda v, p: v.verify_program(p, feed_names=('x',)))
    assert any("op #1 (scale) in block 0 carries op_seq 3, but op #0 "
               "(scale) in block 0 already carries op_seq 3" in e and
               "strictly monotonic" in e for e in errs), errs


def _rewritten(mutate):
    """verify_rewrite of ``_data_program`` after ``mutate``."""
    def check(v, main):
        fetch = [op for op in main.global_block().ops
                 if op.type == 'elementwise_add'][0].output('Out')[0]
        snap = v.pin_snapshot(main, (fetch,), ('x',))
        mutate(main)
        return v.verify_rewrite(snap, main, (fetch,), ('x',))
    return check


def test_renamed_persistable_diagnostic():
    def mutate(main):
        for op in main.global_block().ops:
            if 'w_persist' in op.output_arg_names:
                op.outputs = {'Out': ['w_renamed']}
    errs = _both(lambda pkg, _: _data_program(pkg)[0], _rewritten(mutate))
    assert any("pinned name 'w_persist' (persistable) was written before "
               "the pass but no surviving op writes it — renamed or "
               "eliminated" in e for e in errs), errs


def test_retyped_persistable_diagnostic():
    def mutate(main):
        main.global_block().vars['w_persist'].dtype = 'bfloat16'
    errs = _both(lambda pkg, _: _data_program(pkg)[0], _rewritten(mutate))
    assert any("persistable var 'w_persist' was re-typed from float32 to "
               "bfloat16" in e for e in errs), errs


def _casts(second_type):
    def make(pkg, prog_mod):
        main = prog_mod.Program()
        block = main.global_block()
        block.append_op(type='cast', inputs={'X': ['x']},
                        outputs={'Out': ['x@amp.bf16']},
                        attrs={'out_dtype': 'bfloat16'})
        if second_type == 'cast':
            block.append_op(type='cast', inputs={'X': ['x']},
                            outputs={'Out': ['x@amp.bf16']},
                            attrs={'out_dtype': 'bfloat16'})
        else:
            block.append_op(type=second_type, inputs={'X': ['x@amp.bf16']},
                            outputs={'Out': ['y']}, attrs={})
        return main
    return make


def test_cast_into_amp_black_diagnostic():
    errs = _both(_casts('softmax'), lambda v, p: v.verify_program(
        p, feed_names=('x',), amp_low='bfloat16'))
    assert any("op #1 (softmax) in block 0 is AMP_BLACK but reads "
               "'x@amp.bf16' straight from an f32->bfloat16 weaver cast"
               in e for e in errs), errs


def test_duplicate_weaver_cast_diagnostic():
    errs = _both(_casts('cast'), lambda v, p: v.verify_program(
        p, feed_names=('x',), amp_low='bfloat16'))
    assert any("duplicates the AMP cast ('x' -> bfloat16) within one "
               "definition epoch" in e for e in errs), errs


def test_signature_unknown_input_slot_diagnostic():
    errs = _both(_one_op('scale', {'X': ['x'], 'Bogus': ['x']},
                         {'Out': ['y']}, {'scale': 1.0}),
                 lambda v, p: v.verify_program(p, feed_names=('x',)))
    assert any("declares input slot 'Bogus'" in e and
               "only reads ['X']" in e for e in errs), errs


def test_signature_unknown_output_slot_diagnostic():
    errs = _both(_one_op('scale', {'X': ['x']},
                         {'Out': ['y'], 'Phantom': ['z']}, {'scale': 1.0}),
                 lambda v, p: v.verify_program(p, feed_names=('x',)))
    assert any("declares output slot 'Phantom'" in e and
               "would stay undefined" in e for e in errs), errs


def test_signature_missing_required_attr_diagnostic():
    errs = _both(_one_op('cast', {'X': ['x']}, {'Out': ['y']}, {}),
                 lambda v, p: v.verify_program(p, feed_names=('x',)))
    assert any("attr 'out_dtype' is read unconditionally by the compute "
               "function but the OpDesc does not carry it" in e
               for e in errs), errs


def test_unregistered_op_diagnostic():
    errs = verify.verify_program(_one_op('definitely_not_an_op', {}, {},
                                         {})(tfl, tprog))
    assert any("op type 'definitely_not_an_op' is not registered" in e
               for e in errs), errs


def test_donation_order_inversion_diagnostic():
    def make(pkg, prog_mod):
        main = prog_mod.Program()
        block = main.global_block()
        prog_mod.Variable(block, name='w', shape=(4,), dtype='float32',
                          persistable=True)
        block.append_op(type='sgd',
                        inputs={'Param': ['w'], 'Grad': ['g'],
                                'LearningRate': ['lr']},
                        outputs={'ParamOut': ['w']},
                        attrs={'op_role': 'optimize', 'op_seq': 5})
        block.append_op(type='scale', inputs={'X': ['w']},
                        outputs={'Out': ['y']},
                        attrs={'scale': 1.0, 'op_seq': 2})
        return main
    errs = _both(make, lambda v, p: v.verify_program(
        p, feed_names=('g', 'lr')))
    assert any("reads 'w' after" in e and
               "updated in place (donated alias)" in e and
               "read after last legal use" in e for e in errs), errs


def test_clean_program_verifies_clean():
    main, fetch = _data_program(tfl)
    assert verify.verify_program(main, (fetch,), ('x',)) == []


def test_port_op_signatures_match_the_reference_where_closed():
    """The introspected signature of every op type the port registers
    against the reference's: a slot one side reads and the other never
    does would pass one verifier and fail the other."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    worse = []
    for t in treg.registered_ops():
        js, ts = jreg.op_signature(t), treg.op_signature(t)
        if js is None:
            continue
        assert treg.op_traits(t).amp == jreg.op_traits(t).amp, t
        if not ts.in_open and not js.in_open and \
                not js.in_slots <= ts.in_slots:
            worse.append((t, 'in', sorted(js.in_slots - ts.in_slots)))
        if not ts.out_open and not js.out_open and \
                not js.out_slots <= ts.out_slots:
            worse.append((t, 'out', sorted(js.out_slots - ts.out_slots)))
    assert worse == []


# ---------------------------------------------------------------------------
# mutation matrix: corrupt ONE pass's output, every_pass names it
# ---------------------------------------------------------------------------

def _mut_drop_persistable_writer(program):
    blk = program.global_block()
    blk.ops = [op for op in blk.ops
               if 'w_persist' not in op.output_arg_names]


def _mut_read_ghost(program):
    op = program.global_block().ops[0]
    op.inputs = {slot: ['__ghost__' for _ in names]
                 for slot, names in op.inputs.items()}


def _mut_duplicate_op_seq(program):
    stamped = [op for op in program.global_block().ops
               if 'op_seq' in op.attrs]
    if len(stamped) >= 2:
        stamped[-1].attrs['op_seq'] = stamped[0].attrs['op_seq']


def _mut_drop_fetch_producer(program):
    blk = program.global_block()
    blk.ops = [op for op in blk.ops
               if not any(n.startswith('elementwise_add')
                          for n in op.output_arg_names)]


def _mut_duplicate_weaver_cast(program):
    blk = program.global_block()
    for _ in range(2):
        blk.append_op(type='cast', inputs={'X': ['x']},
                      outputs={'Out': ['x@amp.bf16']},
                      attrs={'out_dtype': 'bfloat16'})


# every rewrite pass the port registers, with a corruption the verifier
# catches
PASS_MUTATIONS = {
    'dce': _mut_drop_persistable_writer,
    'constant_fold': _mut_read_ghost,
    'cse': _mut_duplicate_op_seq,
    'dce_sweep': _mut_drop_fetch_producer,
    'amp': _mut_duplicate_weaver_cast,
}


def test_every_rewrite_pass_has_a_mutation():
    assert sorted(p.name for p in pm.registered_passes()
                  if p.kind == 'rewrite') == sorted(PASS_MUTATIONS)


@pytest.mark.parametrize('pass_name', sorted(PASS_MUTATIONS))
def test_mutation_is_caught_and_attributed(pass_name, monkeypatch):
    main, fetch = _data_program(tfl)
    amp = 'bf16' if pass_name == 'amp' else '0'
    pm.run_pipeline(main, fetch_names=(fetch,), feed_names=('x',),
                    level=2, amp_mode=amp, verify='every_pass')
    monkeypatch.setitem(pm._TEST_CORRUPTORS, pass_name,
                        PASS_MUTATIONS[pass_name])
    with pytest.raises(IRVerificationError) as ei:
        pm.run_pipeline(main, fetch_names=(fetch,), feed_names=('x',),
                        level=2, amp_mode=amp, verify='every_pass')
    assert ei.value.pass_name == pass_name
    assert ei.value.errors


def test_mutation_boundary_mode_catches_without_attribution(monkeypatch):
    main, fetch = _data_program(tfl)
    monkeypatch.setitem(pm._TEST_CORRUPTORS, 'dce',
                        PASS_MUTATIONS['dce'])
    with pytest.raises(IRVerificationError) as ei:
        pm.run_pipeline(main, fetch_names=(fetch,), feed_names=('x',),
                        level=2, amp_mode='0', verify='boundary')
    assert ei.value.pass_name is None


@pytest.mark.parametrize('pass_name', ['cse', 'amp'])
def test_a_pass_that_raises_makes_the_pipeline_raise(pass_name,
                                                     monkeypatch):
    """The recorded departure: no pass is skipped.  A raising ``amp``
    pass must not leave a float32 program behind a bf16 run."""
    def boom(program, ctx):
        raise RuntimeError("pass exploded")
    monkeypatch.setitem(pm.PASSES, pass_name,
                        pm.PASSES[pass_name]._replace(fn=boom))
    main, fetch = _data_program(tfl)
    with pytest.raises(RuntimeError, match='pass exploded'):
        pm.run_pipeline(main, fetch_names=(fetch,), feed_names=('x',),
                        level=2, amp_mode='bf16', verify='boundary')
    exe = tfl.Executor(tfl.CPUPlace())
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'bf16')
    with pytest.raises(RuntimeError, match='pass exploded'):
        exe.run(main, feed={'x': np.ones((2, 4), np.float32)},
                fetch_list=[fetch], scope=tfl.Scope())


# ---------------------------------------------------------------------------
# executor integration
# ---------------------------------------------------------------------------

def test_plan_cache_invalidation_on_config_flips(monkeypatch):
    """Flipping the graph-opt level, the AMP mode or the verify mode
    each re-keys both the run and the run_steps plans."""
    main, fetch = _data_program(tfl)
    feed = {'x': np.ones((2, 4), np.float32)}
    scope = tfl.Scope()
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '2')
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', '0')
    monkeypatch.setenv('PADDLE_TPU_TORCH_VERIFY_IR', 'boundary')
    exe = tfl.Executor(tfl.CPUPlace())
    exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)
    exe.run_steps(main, feed=[feed, feed], fetch_list=[fetch], scope=scope)
    n0 = len(exe._plans)
    for var, val in (('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '1'),
                     ('PADDLE_TPU_TORCH_AMP', 'bf16'),
                     ('PADDLE_TPU_TORCH_VERIFY_IR', 'every_pass')):
        monkeypatch.setenv(var, val)
        exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)
        exe.run_steps(main, feed=[feed, feed], fetch_list=[fetch],
                      scope=scope)
        n1 = len(exe._plans)
        assert n1 == n0 + 1, (var, n0, n1)   # one plan serves both calls
        n0 = n1


def test_executor_propagates_verifier_rejection(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_VERIFY_IR', 'boundary')
    main = tfl.Program()
    main.global_block().append_op(
        type='scale', inputs={'X': ['never_defined']},
        outputs={'Out': ['y']}, attrs={'scale': 1.0})
    exe = tfl.Executor(tfl.CPUPlace())
    with pytest.raises(IRVerificationError) as ei:
        exe.run(main, feed={}, fetch_list=['y'], scope=tfl.Scope())
    assert "reads 'never_defined' before any definition" in str(ei.value)


def test_verify_off_restores_unverified_path(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_VERIFY_IR', 'off')
    main = tfl.Program()
    main.global_block().append_op(
        type='scale', inputs={'X': ['never_defined']},
        outputs={'Out': ['y']}, attrs={'scale': 1.0})
    exe = tfl.Executor(tfl.CPUPlace())
    with pytest.raises(KeyError) as ei:
        exe.run(main, feed={}, fetch_list=['y'], scope=tfl.Scope())
    assert not isinstance(ei.value, IRVerificationError)
    assert "reads 'never_defined' which has no value" in str(ei.value)


def test_per_pass_report_structure(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', '2')
    monkeypatch.setenv('PADDLE_TPU_TORCH_VERIFY_IR', 'every_pass')
    main, fetch = _data_program(tfl)
    exe = tfl.Executor(tfl.CPUPlace())
    exe.run(main, feed={'x': np.ones((2, 4), np.float32)},
            fetch_list=[fetch], scope=tfl.Scope())
    rep = exe.last_graph_opt_report
    assert [e['name'] for e in rep['passes']] == [
        'dce', 'constant_fold', 'cse', 'dce_sweep', 'donation',
        'cost_model', 'memory_model']
    for e in rep['passes']:
        assert e['ops_after'] <= e['ops_before'] and e['wall_s'] >= 0.0
        assert e['verify'] == (
            'skipped' if e['name'] in ('donation', 'cost_model',
                                       'memory_model') else 'ok')
    assert rep['verify']['mode'] == 'every_pass'
    assert rep['verify']['checks'] == 4


@pytest.mark.parametrize('mode,level', [('boundary', '2'),
                                        ('every_pass', '2'),
                                        ('boundary', '1')])
def test_rng_streams_survive_managed_pipeline(mode, level, monkeypatch):
    """Dropout masks are bitwise the same with the pipeline off and on:
    the op_seq stamps key each op's generator on its pre-pass
    position."""
    def run(mode, level):
        monkeypatch.setenv('PADDLE_TPU_TORCH_VERIFY_IR', mode)
        monkeypatch.setenv('PADDLE_TPU_TORCH_GRAPH_OPT_LEVEL', level)
        main = tfl.Program()
        main.random_seed = 1234
        with tfl.program_guard(main, tfl.Program()):
            x = tfl.layers.data(name='x', shape=[8], dtype='float32')
            tfl.layers.scale(x, scale=9.0)   # dead
            d = tfl.layers.dropout(x, dropout_prob=0.5)
            y = tfl.layers.scale(d, scale=1.0)
        out, = tfl.Executor(tfl.CPUPlace()).run(
            main, feed={'x': np.ones((4, 8), np.float32)},
            fetch_list=[y.name], scope=tfl.Scope())
        return out
    ref = run('off', '0')
    got = run(mode, level)
    assert 0 < (ref == 0).sum() < ref.size
    np.testing.assert_array_equal(ref, got)


def test_liveness_plan_sees_the_rewritten_program(monkeypatch):
    """Under AMP the plan's liveness runs on the rewritten program: the
    ``@amp.bf16`` copies and casts have their own last uses, and a fetch
    of a lowered value comes back in bfloat16."""
    monkeypatch.setenv('PADDLE_TPU_TORCH_AMP', 'bf16')
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup):
        x = tfl.layers.data(name='x', shape=[8], dtype='float32')
        h = tfl.layers.fc(input=x, size=16, act='relu')
        h2 = tfl.layers.fc(input=h, size=4)
        loss = tfl.layers.mean(x=h2)
        tfl.optimizer.SGDOptimizer(0.1).minimize(loss)
    scope = tfl.Scope()
    exe = tfl.Executor(tfl.CPUPlace())
    exe.run(startup, scope=scope)
    got = exe.run(main, feed={'x': np.ones((3, 8), np.float32)},
                  fetch_list=[loss, h], scope=scope, return_numpy=False)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    plan, = [p for k, p in exe._plans.items() if k[0] == main._uid]
    casts = [op for op in plan.program.global_block().ops
             if op.type == 'cast']
    assert casts and all(op.output('Out')[0].endswith(('@amp.bf16',
                                                       '@amp.f32'))
                         for op in casts)
    assert not any(scope.has(op.output('Out')[0]) for op in casts)

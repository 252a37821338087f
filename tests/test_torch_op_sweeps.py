"""The reference's structural sweeps over the op registry
(tests/test_zz_op_coverage.py), run over the port's registry
(paddle_tpu_torch/core/registry.py) and its pass pipeline, cost and
memory models (paddle_tpu_torch/transpiler/).

- The registry: 190 op types, each a reference name with equal
  ``op_traits``; the 9 it does not register are exactly item 10's nine
  distribution ops; the port's layers
  have every public name of the reference's but ``device`` and
  ``get_places``.
- Traits against the pass lists: an op with random draws, an environment
  or effects is in neither the CSE nor the folding list, every
  environment op is effectful, folding implies CSE, and the lists name
  registered ops (or the unported distribution ops, which the lists
  carry from the reference).
- Every op's AMP class is exactly one of white, black and grey, equal to
  the reference's; the bf16 weaver keeps a single-op program of each type
  and inserts no cast for inputs of unknown dtype; the level-2 pipeline
  leaves a fetched single-op program of each type as it is; the verifier
  at ``every_pass`` passes the signature-conformant program of each type
  under level 2 with and without AMP.
- Every op has a cost verdict path or a waiver (a 'mac' op has its MAC
  formula), and the memory model sizes, waives or reports each op's
  outputs, never silently 0.  For each op type this slice brings and the
  repaired ``clip``, both models give the reference's report, number for
  number, on the reference sweep's single-op program.
- The reference's "executed by the suite" check reads which ops ran in
  one process; the suite runs over several workers, so here it is a
  static check instead: every op type the port registers is named in
  tests/torch_op_library_cases.py or in an earlier parity test
  (``PARITY_FILES``); ``truncated_gaussian_random`` in the text of
  tests/test_torch_optimizers.py, which checks its draws by distribution
  through its initializer.
"""
import ast
import os

import pytest

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.transpiler import cost_model as jcm
from paddle_tpu.transpiler import memory_model as jmm

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.transpiler import amp, cost_model, memory_model, passes
from paddle_tpu_torch.transpiler import pass_manager as pm

from tests.test_zz_op_coverage import _SWEEP_ATTR_VALUES, _sweep_program
from torch_op_library_cases import NEW_OPS

NOT_PORTED = {'parallel_do', 'get_places', 'send', 'recv', 'allreduce',
              'allgather', 'broadcast', 'reducescatter',
              'vocab_parallel_ce'}
HERE = os.path.dirname(os.path.abspath(__file__))
# the earlier slices' parity tests and their shared cases
PARITY_FILES = sorted(
    f for f in os.listdir(HERE)
    if f.startswith(('test_torch_', 'torch_')) and f.endswith('.py') and
    f != os.path.basename(__file__))


def test_the_port_registers_the_reference_library_but_eleven_ops():
    ops = treg.registered_ops()
    assert len(ops) == 190
    assert set(jreg.registered_ops()) - set(ops) == NOT_PORTED
    for t in ops:
        assert tuple(treg.op_traits(t)) == tuple(jreg.op_traits(t)), t
    public = {n for n in dir(fluid.layers) if not n.startswith('_')}
    assert public - set(dir(tfl.layers)) == {'device', 'get_places'}


def test_graph_opt_classification_consistent_with_registry():
    for t in treg.registered_ops():
        registered, stateful_rng, needs_env, _amp, _cost = \
            treg.op_traits(t)
        assert registered
        if needs_env:
            assert t in passes.EFFECTFUL_OPS, t
        if stateful_rng or needs_env or t in passes.EFFECTFUL_OPS:
            assert t not in passes.CSE_OPS, t
            assert t not in passes.FOLDABLE_OPS, t
    assert passes.FOLDABLE_OPS <= passes.CSE_OPS
    for t in passes.CSE_OPS | passes.EFFECTFUL_OPS:
        assert treg.has_op(t) or t in NOT_PORTED, t


def test_amp_classification_covers_every_op_exactly_once():
    for t in treg.registered_ops():
        cls = treg.op_traits(t).amp
        assert cls == treg.amp_class(t) == jreg.amp_class(t)
        assert cls in ('white', 'black', 'grey')
        assert (cls == 'white') == (t in treg.AMP_WHITE)
        assert (cls == 'black') == (t in treg.AMP_BLACK)
    assert treg.amp_class('no_such_op') == 'grey'


def _single_op(t):
    p = Program()
    p.global_block().append_op(
        type=t, inputs={'X': ['swp_in_a'], 'Y': ['swp_in_b']},
        outputs={'Out': ['swp_out_%s' % t]}, attrs={})
    return p


def test_amp_weaver_survives_every_registered_op():
    for t in treg.registered_ops():
        opt, rep = amp.apply_amp(_single_op(t), mode='bf16')
        assert t in [op.type for op in opt.global_block().ops], t
        assert rep['casts_inserted'] == 0, (t, rep['casts'])


def test_graph_opt_pipeline_survives_every_registered_op():
    for t in treg.registered_ops():
        opt, _ = pm.run_pipeline(
            _single_op(t), fetch_names=('swp_out_%s' % t,),
            feed_names=('swp_in_a', 'swp_in_b'), level=2, amp_mode='0',
            verify='off')
        assert [op.type for op in opt.global_block().ops] == [t]


def _port_sweep_program(t):
    """The reference sweep's signature-conformant single-op program,
    through the port's signature of ``t``."""
    sig = treg.op_signature(t)
    in_slots = sorted(sig.in_slots) or ([] if not sig.in_open else ['X'])
    out_slots = sorted(sig.out_slots) or ['Out']
    p = Program()
    attrs, feeds = {}, []
    for k in sorted(sig.required_attrs):
        if k in ('sub_block', 'block'):
            p.create_block()
            p.current_block_idx = 0
            attrs[k] = 1
        elif k == 'condition':
            attrs[k] = 'swp_cond'
            feeds.append('swp_cond')
        else:
            attrs[k] = _SWEEP_ATTR_VALUES[k]
    inputs = {s: ['swp_%s_%s' % (t, s)] for s in in_slots}
    outputs = {s: ['swpout_%s_%s' % (t, s)] for s in out_slots}
    feeds += [n for ns in inputs.values() for n in ns]
    p.global_block().append_op(type=t, inputs=inputs, outputs=outputs,
                               attrs=attrs)
    return p, tuple(n for ns in outputs.values() for n in ns), tuple(feeds)


def test_verifier_every_pass_over_every_registered_op():
    for t in treg.registered_ops():
        p, fetches, feeds = _port_sweep_program(t)
        for mode in ('0', 'bf16'):
            _, rep = pm.run_pipeline(p, fetch_names=fetches,
                                     feed_names=feeds, level=2,
                                     amp_mode=mode, verify='every_pass')
            assert rep['verify']['mode'] == 'every_pass'
            assert rep['verify']['checks'] >= 1, (t, mode)


def test_cost_model_verdict_or_waiver_for_every_registered_op():
    for t in treg.registered_ops():
        traits = treg.op_traits(t)
        assert traits.cost == treg.cost_class(t)
        assert (traits.cost == 'mac') == (t in treg.COST_MAC)
        if traits.cost == 'mac' and t not in cost_model.WAIVED_OPS:
            assert t in cost_model.MAC_FORMULAS, t
    assert set(cost_model.MAC_FORMULAS) <= set(treg.COST_MAC)
    for t in cost_model.WAIVED_OPS:
        assert t == 'autodiff' or treg.has_op(t), t


def test_memory_model_verdict_or_waiver_for_every_registered_op():
    for t in treg.registered_ops():
        p, fetches, feeds = _port_sweep_program(t)
        specs = {n: ((3, 4), 'float32') for n in feeds}
        cov = memory_model.analyze_memory(p, fetch_names=fetches,
                                          feed_specs=specs)['coverage']
        out_names = set(p.global_block().ops[-1].output_arg_names)
        sized = not cov['no_verdict'] and \
            not (out_names & set(cov['unsized_vars']))
        waived = t in cov['waived']
        reported = t in cov['no_verdict'] or \
            bool(out_names & set(cov['unsized_vars']))
        assert sized or waived or reported, t
        if t in memory_model.WAIVED_OPS:
            assert waived, t
    for t in memory_model.WAIVED_OPS:
        assert treg.has_op(t), t
    assert 'autodiff' not in memory_model.WAIVED_OPS


def _outcome(fn, *args, **kwargs):
    """fn's result, or the type of the exception it raises (a MAC
    formula that cannot read (3, 4) inputs raises in both models)."""
    try:
        return fn(*args, **kwargs)
    except (ValueError, TypeError, IndexError, KeyError) as e:
        return type(e)


@pytest.mark.parametrize('op', sorted(set(NEW_OPS) | {'clip'}))
def test_new_ops_are_costed_and_sized_as_the_reference(op):
    p, fetches, feeds = _sweep_program(op)
    specs = {n: ((3, 4), 'float32') for n in feeds}
    tp = tfl.Program.from_dict(p.to_dict())
    assert _outcome(cost_model.analyze_cost, tp, fetches, specs) == \
        _outcome(jcm.analyze_cost, p, fetches, specs)
    assert _outcome(memory_model.analyze_memory, tp, fetches, specs) == \
        _outcome(jmm.analyze_memory, p, fetch_names=fetches,
                 feed_specs=specs)


def _string_literals(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_every_registered_op_is_named_by_a_parity_test():
    named = set()
    for f in PARITY_FILES:
        named |= _string_literals(os.path.join(HERE, f))
    assert 'torch_op_library_cases.py' in PARITY_FILES
    with open(os.path.join(HERE, 'test_torch_optimizers.py')) as f:
        if 'truncated_gaussian_random' in f.read():
            named.add('truncated_gaussian_random')
    missing = sorted(t for t in treg.registered_ops() if t not in named)
    assert missing == []

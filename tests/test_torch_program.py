"""The port's program IR (paddle_tpu_torch/core/program.py, layers,
optimizer, models/transformer.py ``build``) against the reference's.

- ``Program.from_dict`` reads the reference's ``to_dict`` unchanged: the
  round trip gives back the same dict.
- The port's own ``build`` + ``minimize`` serialises to exactly the
  reference's dict (op types, slots, attrs, variable names, shapes and
  dtypes, the startup program's init ops), for each optimizer the slice
  ports.
- Build-time shape inference on meta tensors keeps the -1 batch dim.

Exact equality throughout: the programs are data, not numbers.
"""
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import infer as tinfer
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.models import transformer as ttr

CFG = dict(vocab_size=64, seq_len=32, n_layers=2, d_model=32, n_heads=4)

OPTIMIZERS = {
    'adam': lambda pkg: pkg.optimizer.AdamOptimizer(learning_rate=1e-3),
    'sgd': lambda pkg: pkg.optimizer.SGDOptimizer(learning_rate=0.1),
    'momentum': lambda pkg: pkg.optimizer.MomentumOptimizer(
        learning_rate=0.1, momentum=0.9, use_nesterov=True),
}


def _build(pkg, prog_mod, tr_mod, opt):
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            _, _, cost = tr_mod.build(**CFG)
            OPTIMIZERS[opt](pkg).minimize(cost)
    return main, startup


@pytest.mark.parametrize('opt', sorted(OPTIMIZERS))
def test_port_build_serialises_to_the_reference_program(opt):
    jm, js = _build(fluid, jprog, jtr, opt)
    tm, ts = _build(tfl, tprog, ttr, opt)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def test_build_logits_serialises_to_the_reference_program():
    with jprog.reset_unique_name_guard():
        jm, js = fluid.Program(), fluid.Program()
        with fluid.program_guard(jm, js):
            jtr.build_logits(**CFG)
    with tprog.reset_unique_name_guard():
        tm, ts = tfl.Program(), tfl.Program()
        with tfl.program_guard(tm, ts):
            ttr.build_logits(**CFG)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def test_from_dict_round_trips_the_reference_dict():
    jm, js = _build(fluid, jprog, jtr, 'adam')
    for prog in (jm, js):
        d = prog.to_dict()
        loaded = tfl.Program.from_dict(d)
        assert loaded.to_dict() == d
        assert tfl.Program.from_json(prog.to_json()).to_dict() == d
    params = [p.name for p in tfl.Program.from_dict(
        jm.to_dict()).all_parameters()]
    assert params == [p.name for p in jm.all_parameters()]
    assert len(params) == 2 + 12 * CFG['n_layers'] + 4


def test_op_roles_and_the_autodiff_op():
    tm, _ = _build(tfl, tprog, ttr, 'adam')
    ops = tm.global_block().ops
    roles = [op.attrs['op_role'] for op in ops]
    ad = [i for i, op in enumerate(ops) if op.type == 'autodiff']
    assert len(ad) == 1 and roles[ad[0]] == 'backward'
    assert set(roles[:ad[0]]) == {'forward'}
    assert set(roles[ad[0] + 1:]) == {'optimize'}
    n_params = 2 + 12 * CFG['n_layers'] + 4
    assert sum(op.type == 'adam' for op in ops) == n_params
    assert [op.type for op in ops[-2:]] == ['scale', 'scale']


@pytest.mark.parametrize('op_type,specs,attrs,slots,want', [
    ('lookup_table', {'Ids': [((-1, 32), 'int64')],
                      'W': [((64, 8), 'float32')]}, {},
     ['Out'], {'Out': [((-1, 32, 8), 'float32')]}),
    ('mul', {'X': [((-1, 32, 8), 'float32')], 'Y': [((8, 24), 'float32')]},
     {'x_num_col_dims': 2, 'y_num_col_dims': 1},
     ['Out'], {'Out': [((-1, 32, 24), 'float32')]}),
    ('reshape', {'X': [((-1, 32, 8), 'float32')]},
     {'shape': [-1, 32, 2, 4]}, ['Out'],
     {'Out': [((-1, 32, 2, 4), 'float32')]}),
    ('split', {'X': [((-1, 32, 24), 'float32')]},
     {'num': 3, 'axis': 2, 'sections': []}, ['Out'],
     {'Out': [((-1, 32, 8), 'float32')] * 3}),
    ('layer_norm', {'X': [((-1, 32, 8), 'float32')],
                    'Scale': [((8,), 'float32')],
                    'Bias': [((8,), 'float32')]},
     {'begin_norm_axis': 2}, ['Y', 'Mean', 'Variance'],
     {'Y': [((-1, 32, 8), 'float32')], 'Mean': [((-1, 32), 'float32')],
      'Variance': [((-1, 32), 'float32')]}),
    ('flash_attention', {'Q': [((-1, 32, 2, 4), 'float32')],
                         'K': [((-1, 32, 2, 4), 'float32')],
                         'V': [((-1, 32, 2, 4), 'float32')]},
     {'causal': True}, ['Out'], {'Out': [((-1, 32, 2, 4), 'float32')]}),
    ('mean', {'X': [((-1, 32, 1), 'float32')]}, {}, ['Out'],
     {'Out': [((1,), 'float32')]}),
    ('fill_constant', {}, {'shape': [3, 2], 'dtype': 'int64', 'value': 1.0},
     ['Out'], {'Out': [((3, 2), 'int64')]}),
])
def test_meta_inference_keeps_the_batch_dim(op_type, specs, attrs, slots,
                                            want):
    assert tinfer.infer_outputs(op_type, specs, attrs, slots) == want


def test_unported_op_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tinfer.infer_outputs('conv3d', {}, {}, ['Output'])

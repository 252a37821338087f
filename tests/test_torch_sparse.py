"""The port's row-sparse (SelectedRows) path against the reference's, on the
CPU: core/selected_rows.py, the plain row-sparse rules of
ops/kernels/table_update.py, the sparse branches of the optimizer ops,
``sparse_grad_assemble`` and the SelectedRows backward.

- ``merge_rows_sentinel`` / ``to_dense`` against the reference's.
- The plain sgd, adagrad and lazy-adam rules against the reference's
  XLA-branch expressions (its ``sgd`` / ``adagrad`` / ``adam`` ops called
  eagerly with a SelectedRows) and against its Pallas kernels
  (``table_update.sparse_apply_*``) in interpret mode: duplicates,
  negative ids, sentinel and out-of-range ids, an all-sentinel vector and
  K = 0.  Rows that are not touched stay bitwise unchanged, moments
  included.
- The optimizer ops: rank-2 tables, and a rank-3 table as a [height, -1]
  view, through the row-wise rule; momentum densifying; a sharded table
  raising.
- The backward: ``_find_sparse_params``' choice, the serialised program,
  and the SelectedRows that ``sparse_grad_assemble`` emits (with
  ``padding_idx``) against the reference's on the same program and feed.

Tolerances.  Within the port the kernel is bitwise equal to these plain
rules (chip_smoke.py holds that on the card).  Across the packages the
reference's eager XLA:CPU contracts some products and sums into fused
multiply-adds (optim_ops.py's Adagrad rounds moment + g^2 once in a
fused multiply-add for its step), which the port's eager torch never
does, so tables and moments agree within 1e-6 absolute (values O(1), a
few ulps); ids, rows and merged sums summed in the same slot order agree
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import backward as jbackward
from paddle_tpu.core import program as jprog
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.ops.pallas import table_update as jtu

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import backward as tbackward
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core import selected_rows as tsr
from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.ops.kernels import table_update as ttu

TOL = 1e-6
H, D = 41, 8
B1, B2, EPS_ADAM, EPS_ADAGRAD = 0.9, 0.999, 1e-8, 1e-6


def _ids(rng, k, negatives=False, n_sentinel=3, n_oob=2, n_dup=5):
    """k ids: duplicates, ``height`` sentinels and out-of-range ids
    interleaved; with ``negatives``, ids in [-H, 0) that alias none of the
    positive ones (the reference's XLA branch merges an id and its
    negative alias apart)."""
    real = rng.integers(0, H // 2, k - n_sentinel - n_oob)
    real[-n_dup:] = real[:n_dup]
    if negatives:
        real[::3] = -1 - rng.integers(0, H // 2 - 1, len(real[::3]))
    ids = np.concatenate([real, np.full(n_sentinel, H),
                          H + 1 + rng.integers(0, 5, n_oob)])
    return rng.permutation(ids).astype(np.int32)


CASES = {
    'duplicates': lambda rng: _ids(rng, 29),
    'negatives': lambda rng: _ids(rng, 29, negatives=True),
    'all_sentinel': lambda rng: np.full(6, H, np.int32),
    'heavy_run': lambda rng: np.concatenate(
        [np.full(40, 7), rng.integers(0, H, 9)]).astype(np.int32),
    # longer than every threshold, batch, scan group and ring depth of the
    # card's kernel (csrc/table_update.cu: 32, 32, 64 and 256 slots), and
    # a long run next to it
    'long_run': lambda rng: rng.permutation(np.concatenate(
        [np.full(300, 5), np.full(65, 6), rng.integers(0, H, 31)])
    ).astype(np.int32),
    # the synthetic text's id shape (datasets/wmt14.py zipf_seq) folded
    # into the table
    'zipf': lambda rng: ((rng.zipf(1.3, 400) - 1) % H).astype(np.int32),
}


def _state(rng, k):
    vals = rng.standard_normal((k, D)).astype(np.float32)
    p = rng.standard_normal((H, D)).astype(np.float32)
    m = rng.standard_normal((H, D)).astype(np.float32)
    v = np.abs(rng.standard_normal((H, D))).astype(np.float32)
    return vals, p, m, v


def _touched(ids):
    ids = np.where(ids < 0, ids + H, ids)
    mask = np.zeros(H, bool)
    mask[ids[(ids >= 0) & (ids < H)]] = True
    return mask


def _port_rule(rule, ids, vals, p, m, v, lr):
    t = [torch.tensor(a) for a in (p, m, v)]
    rows, values, lr_t = (torch.tensor(ids), torch.tensor(vals),
                          torch.tensor([lr], dtype=torch.float32))
    if rule == 'sgd':
        ttu.sparse_apply_sgd(t[0], rows, values, lr_t)
        return [t[0].numpy()]
    if rule == 'adagrad':
        ttu.sparse_apply_adagrad(t[0], t[2], rows, values, lr_t,
                                 EPS_ADAGRAD)
        return [t[0].numpy(), t[2].numpy()]
    ttu.sparse_apply_adam(t[0], t[1], t[2], rows, values, lr_t, B1, B2,
                          EPS_ADAM)
    return [x.numpy() for x in t]


def _ref_op(rule, ids, vals, p, m, v, lr):
    """The reference op's XLA scatter branch, eagerly, on a SelectedRows."""
    grad = jsr.SelectedRows(jnp.asarray(ids), jnp.asarray(vals), H)
    ins = {'Param': [jnp.asarray(p)], 'Grad': [grad],
           'LearningRate': [jnp.asarray([lr], jnp.float32)]}
    if rule == 'sgd':
        return [np.asarray(jget_op('sgd').compute(None, ins, {})
                           ['ParamOut'][0])]
    if rule == 'adagrad':
        ins['Moment'] = [jnp.asarray(v)]
        out = jget_op('adagrad').compute(None, ins,
                                         {'epsilon': EPS_ADAGRAD})
        return [np.asarray(out['ParamOut'][0]),
                np.asarray(out['MomentOut'][0])]
    # beta pows of 0 make the bias-corrected rate lr_t = lr itself
    zero = jnp.asarray([0.0], jnp.float32)
    ins.update(Moment1=[jnp.asarray(m)], Moment2=[jnp.asarray(v)],
               Beta1Pow=[zero], Beta2Pow=[zero])
    out = jget_op('adam').compute(None, ins, {'beta1': B1, 'beta2': B2,
                                              'epsilon': EPS_ADAM})
    return [np.asarray(out[k][0])
            for k in ('ParamOut', 'Moment1Out', 'Moment2Out')]


def _ref_pallas(rule, ids, vals, p, m, v, lr):
    rows, values = jnp.asarray(ids), jnp.asarray(vals)
    lr = jnp.float32(lr)
    if rule == 'sgd':
        return [np.asarray(jtu.sparse_apply_sgd(jnp.asarray(p), rows, values,
                                                lr, interpret=True))]
    if rule == 'adagrad':
        return [np.asarray(a) for a in jtu.sparse_apply_adagrad(
            jnp.asarray(p), jnp.asarray(v), rows, values, lr, EPS_ADAGRAD,
            interpret=True)]
    return [np.asarray(a) for a in jtu.sparse_apply_adam(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), rows, values, lr,
        B1, B2, EPS_ADAM, interpret=True)]


def _inputs_of(rule, p, m, v):
    return {'sgd': [p], 'adagrad': [p, v], 'adam': [p, m, v]}[rule]


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('rule', ['sgd', 'adagrad', 'adam'])
def test_plain_rules_match_the_reference(rule, case):
    rng = np.random.default_rng(len(case) + len(rule))
    ids = CASES[case](rng)
    vals, p, m, v = _state(rng, len(ids))
    got = _port_rule(rule, ids, vals, p, m, v, 0.13)
    pallas = _ref_pallas(rule, ids, vals, p, m, v, 0.13)
    xla = _ref_op(rule, ids, vals, p, m, v, 0.13)
    for a, b, c in zip(got, pallas, xla):
        assert np.abs(a - b).max() <= TOL
        assert np.abs(a - c).max() <= TOL
    untouched = ~_touched(ids)
    for a, before in zip(got, _inputs_of(rule, p, m, v)):
        assert np.array_equal(a[untouched], before[untouched])
        assert untouched.all() == np.array_equal(a, before)


@pytest.mark.parametrize('rule', ['sgd', 'adagrad', 'adam'])
def test_empty_id_vector_changes_nothing(rule):
    rng = np.random.default_rng(11)
    vals, p, m, v = _state(rng, 0)
    ids = np.zeros((0,), np.int32)
    got = _port_rule(rule, ids, vals, p, m, v, 0.13)
    want = _ref_pallas(rule, ids, vals, p, m, v, 0.13)
    for a, b, before in zip(got, want, _inputs_of(rule, p, m, v)):
        assert np.array_equal(a, before) and np.array_equal(b, before)


def test_a_negative_id_merges_with_its_wrapped_row():
    """-1 and H - 1 are one row, as the reference's Pallas rules read
    them (its XLA branch would merge them apart)."""
    rng = np.random.default_rng(12)
    ids = np.array([-1, H - 1, 3, -H], np.int32)
    vals, p, m, v = _state(rng, 4)
    got = _port_rule('adam', ids, vals, p, m, v, 0.01)
    want = _ref_pallas('adam', ids, vals, p, m, v, 0.01)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= TOL
    wrapped = np.array([H - 1, H - 1, 3, 0], np.int32)
    for a, b in zip(got, _port_rule('adam', wrapped, vals, p, m, v, 0.01)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('case', sorted(CASES))
def test_merge_rows_sentinel_matches_the_reference(case):
    rng = np.random.default_rng(13)
    ids = CASES[case](rng)
    vals = rng.standard_normal((len(ids), D)).astype(np.float32)
    jr, jv, jvalid = jsr.merge_rows_sentinel(jnp.asarray(ids),
                                             jnp.asarray(vals), H)
    tr, tv, tvalid = tsr.merge_rows_sentinel(torch.tensor(ids),
                                             torch.tensor(vals), H)
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert np.array_equal(tv.numpy()[tvalid.numpy()],
                          np.asarray(jv)[np.asarray(jvalid)])
    assert np.abs(tv.numpy() - np.asarray(jv)).max() <= TOL


def test_to_dense_matches_the_reference():
    rng = np.random.default_rng(14)
    ids = rng.integers(0, H, 30).astype(np.int32)
    vals = rng.standard_normal((30, D)).astype(np.float32)
    ids[:4] = [-1, H, H + 7, -H]
    want = np.asarray(jsr.SelectedRows(jnp.asarray(ids), jnp.asarray(vals),
                                       H).to_dense())
    got = tsr.SelectedRows(torch.tensor(ids), torch.tensor(vals), H)
    assert np.array_equal(got.to_dense().numpy(), want)
    assert np.array_equal(got.numpy().to_dense(), want)


def _op_ins(pkg, grad, p, m, v):
    arr = jnp.asarray if pkg == 'ref' else torch.tensor
    ins = {'Param': [arr(p)], 'Grad': [grad],
           'LearningRate': [arr(np.float32([0.05]))],
           'Moment': [arr(v)], 'Moment1': [arr(m)], 'Moment2': [arr(v)],
           'Velocity': [arr(m)],
           'Beta1Pow': [arr(np.float32([0.9 ** 2]))],
           'Beta2Pow': [arr(np.float32([0.999 ** 2]))]}
    return ins


@pytest.mark.parametrize('op,outs', [
    ('sgd', ['ParamOut']), ('adagrad', ['ParamOut', 'MomentOut']),
    ('adam', ['ParamOut', 'Moment1Out', 'Moment2Out']),
    ('momentum', ['ParamOut', 'VelocityOut'])])
@pytest.mark.parametrize('rank', [2, 3])
def test_optimizer_ops_apply_a_selected_rows_gradient(op, outs, rank):
    """Rank 2 takes the row-wise rule, rank 3 the same rule on a
    [height, -1] view; momentum densifies.  Outputs are the input tensors, updated in
    place."""
    rng = np.random.default_rng(15)
    shape = (H, D) if rank == 2 else (H, 2, D // 2)
    ids = _ids(rng, 23)
    vals = rng.standard_normal((23,) + shape[1:]).astype(np.float32)
    p, m = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    v = np.abs(rng.standard_normal(shape)).astype(np.float32)
    attrs = {'epsilon': 1e-6} if op == 'adagrad' else {}
    # the reference's scatter branches of adagrad and adam mask [K, 1]
    # against [K, a, b] values and fail above rank 2, so its rule runs on
    # the table flattened to [H, D]
    flat = [a.reshape(H, D) for a in (p, m, v)]
    jgrad = jsr.SelectedRows(jnp.asarray(ids),
                             jnp.asarray(vals.reshape(-1, D)), H)
    want = jget_op(op).compute(None, _op_ins('ref', jgrad, *flat), attrs)
    tgrad = tsr.SelectedRows(torch.tensor(ids), torch.tensor(vals), H)
    ins = _op_ins('port', tgrad, p, m, v)
    got = tget_op(op).compute(None, ins, attrs)
    assert got['ParamOut'][0] is ins['Param'][0]
    for slot in outs:
        assert np.abs(got[slot][0].numpy().reshape(H, D)
                      - np.asarray(want[slot][0])).max() <= TOL, slot


def test_sharded_table_raises_naming_the_multi_chip_slice():
    grad = tsr.SelectedRows(torch.tensor([1, 2]), torch.ones((2, D)), H)
    ins = _op_ins('port', grad, *(np.zeros((H, D), np.float32),) * 3)
    with pytest.raises(NotImplementedError, match='item 10'):
        tget_op('sgd').compute(None, ins, {'embed_ways': 2})


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, v = torch.zeros((H, D)), torch.ones((3, D))
    rows, lr = torch.tensor([1, 2, 3]), torch.tensor([0.1])
    with pytest.raises(ValueError, match='values'):
        ttu.sparse_apply_sgd(p, rows, torch.ones((3, D + 1)), lr)
    with pytest.raises(TypeError):
        ttu.sparse_apply_sgd(p.double(), rows, v, lr)
    with pytest.raises(ValueError, match='ids'):
        ttu.sparse_apply_sgd(p, rows.float(), v, lr)
    with pytest.raises(ValueError, match='learning rate'):
        ttu.sparse_apply_sgd(p, rows, v, lr.repeat(2))
    srows, order = ttu.sort_rows(torch.tensor([5, -1, H, 2, 5, -H - 1]), H)
    assert srows.tolist() == [2, 5, 5, H - 1, H, H]
    assert order.tolist() == [3, 0, 4, 1, 2, 5]
    assert ttu.launches == 0


def _sparse_program(pkg, prog_mod, optimize=True):
    """Two is_sparse lookups of one table sharing a padding_idx, a table
    read both sparsely and densely, and a table whose lookups disagree on
    padding_idx: only the first takes the SelectedRows path."""
    with prog_mod.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.program_guard(main, startup):
            L = pkg.layers
            a = L.data(name='a', shape=[1], dtype='int64', lod_level=1)
            b = L.data(name='b', shape=[1], dtype='int64', lod_level=1)
            ea = L.embedding(input=a, size=[H, D], is_sparse=True,
                             padding_idx=-1, param_attr='shared')
            eb = L.embedding(input=b, size=[H, D], is_sparse=True,
                             padding_idx=-1, param_attr='shared')
            ec = L.embedding(input=a, size=[H, D], is_sparse=True,
                             param_attr='mixed')
            ed = L.embedding(input=b, size=[H, D], is_sparse=False,
                             param_attr='mixed')
            ee = L.embedding(input=a, size=[H, D], is_sparse=True,
                             padding_idx=0, param_attr='conflict')
            ef = L.embedding(input=b, size=[H, D], is_sparse=True,
                             padding_idx=1, param_attr='conflict')
            feat = L.concat(input=[ea, eb, ec, ed, ee, ef], axis=2)
            cost = L.mean(x=L.sequence_pool(
                input=L.fc(input=feat, size=1, num_flatten_dims=2),
                pool_type='sum'))
            if optimize:
                pkg.optimizer.AdamOptimizer(1e-2).minimize(cost)
    return main, startup, cost


def test_sparse_backward_matches_the_reference():
    jmain, jstartup, _ = _sparse_program(fluid, jprog)
    tmain, tstartup, _ = _sparse_program(tfl, tprog)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstartup.to_dict() == jstartup.to_dict()
    # the choice is made before the optimizer's ops read the tables
    jplain, _, _ = _sparse_program(fluid, jprog, optimize=False)
    tplain, _, _ = _sparse_program(tfl, tprog, optimize=False)
    names = [p.name for p in tplain.all_parameters()]
    want = jbackward._find_sparse_params(jplain.global_block(), names)
    got = tbackward._find_sparse_params(tplain.global_block(), names)
    assert got == want and sorted(got) == ['shared']
    types = [op.type for op in tmain.global_block().ops]
    assert types.count('sparse_grad_assemble') == 1

    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.has(v.name)}
    tscope = scope_from_numpy(persist, 'cpu')
    texe = tfl.Executor(tfl.CPUPlace())
    ln = np.array([5, 2, 4])
    ids = np.array([[1, H - 1, 7, 7, -1], [H - 1, 2, 0, 0, 0],
                    [3, 4, 40, 1, 0]], np.int64)[..., None]
    feed = {'a': (ids, ln), 'b': (ids[::-1].copy(), ln)}
    fetch = ['shared@GRAD', 'mixed@GRAD', 'conflict@GRAD']
    want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
    jsel, tsel = want[0].item(), got[0].item()
    assert got[0].dtype == object and got[0].shape == ()
    assert isinstance(tsel, tsr.SelectedRows) and tsel.height == H
    assert np.array_equal(tsel.rows, np.asarray(jsel.rows))
    assert np.abs(tsel.values - np.asarray(jsel.values)).max() <= TOL
    # the padding row (-1 is row H - 1) is kept with zero values
    pad = tsel.rows == H - 1
    assert pad.any() and not tsel.values[pad].any()
    for a, b in zip(got[1:], want[1:]):
        assert np.abs(a - np.asarray(b)).max() <= TOL
    for name in persist:
        assert np.abs(tscope.get_numpy(name)
                      - np.asarray(jscope.get(name))).max() <= TOL, name

"""The LoD sequence ops of the sequence-labelling slice, against the
reference's ops on the same seeded numpy inputs, on the CPU:
``sequence_expand``, ``sequence_concat``, ``sequence_slice``,
``sequence_erase``, ``lod_reset`` (paddle_tpu_torch/ops/sequence.py),
``one_hot``, ``sequence_reshape``, ``im2sequence`` (ops/tensor_ops.py)
and ``row_conv`` (ops/conv.py), and their layers.

- Each op's every output, values and the ``OutLen`` lengths, dtype and
  shape equal to the reference's, over cases that reach the edges: rows
  of length 0 and of the full width, Y without lengths, three inputs to
  concatenate with and without lengths, slice offsets past the end and
  negative (clamped), erasing every token, no token or tokens absent,
  ``lod_reset`` from an attr and from Y, ids outside the one-hot depth,
  patches with asymmetric padding and strides, look-ahead windows of 1
  to 4 steps.
- The gradients of ``sequence_expand``, ``sequence_concat``,
  ``sequence_slice``, ``im2sequence`` and ``row_conv`` from
  ``torch.autograd`` against ``jax.vjp`` of the reference op.
- Through layers and both executors, the lengths an op writes reach its
  output's ``@LEN`` companion: ``sequence_pool`` of each output sums
  only the new valid steps, on both sides alike.
- Each layer of the slice (the nine of layers/sequence.py that were
  stubs, and warpctc, one_hot, im2sequence, row_conv of layers/nn.py)
  builds a program that serialises to exactly the reference's, its
  startup program (the parameters' initialisers) too.

Tolerances: exact for ids and lengths and for values copied or gathered;
1e-6 absolute for the sums of ``row_conv`` and the pooled fetches
(float32, O(1) values summed in the same order) and for gradients (sums
of at most 4 O(1) terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op_impl as jget_op

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op_impl as tget_op

from torch_seqlab_cases import SEQUENCE_CASES as CASES
from torch_seqlab_cases import SEQUENCE_GRAD_CASES as GRAD_CASES

TOL = 1e-6
_rng = np.random.default_rng(1)


def _ref(op, ins, attrs):
    return jget_op(op).compute(
        None, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))


def _narrow(v):
    """64-bit ints narrowed to 32 bits, as both executors feed them."""
    return v.astype(np.int32) if v.dtype == np.int64 else v


def _port(op, ins, attrs):
    return tget_op(op).compute(
        None, {k: [torch.tensor(_narrow(v)) for v in vs]
               for k, vs in ins.items()}, dict(attrs))


@pytest.mark.parametrize('case', list(CASES))
def test_op_matches_the_reference(case):
    op, ins, attrs = CASES[case]
    got, want = _port(op, ins, attrs), _ref(op, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        a, b = got[slot][0].numpy(), np.asarray(want[slot][0])
        assert a.shape == b.shape and a.dtype == b.dtype, (slot, a.dtype,
                                                            b.dtype)
        tol = TOL if op == 'row_conv' else 0.0
        assert np.abs(a.astype(np.float64) - b).max(initial=0.0) <= tol, \
            slot


@pytest.mark.parametrize('case', GRAD_CASES)
def test_gradients_match_jax_vjp(case):
    op, ins, attrs = CASES[case]
    diff = [(k, i) for k, vs in ins.items() for i, v in enumerate(vs)
            if v.dtype == np.float32]

    def ref_out(*vals):
        j = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
        for (k, i), v in zip(diff, vals):
            j[k][i] = v
        return jget_op(op).compute(None, j, dict(attrs))['Out'][0]
    primal, vjp = jax.vjp(ref_out, *[jnp.asarray(ins[k][i])
                                     for k, i in diff])
    ct = _rng.standard_normal(primal.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct))
    t = {k: [torch.tensor(_narrow(v)) for v in vs]
         for k, vs in ins.items()}
    leaves = []
    for k, i in diff:
        t[k][i] = t[k][i].clone().requires_grad_(True)
        leaves.append(t[k][i])
    o = tget_op(op).compute(None, t, dict(attrs))['Out'][0]
    got = torch.autograd.grad(o, leaves, torch.tensor(ct),
                              allow_unused=True)
    for a, b, leaf in zip(got, want, leaves):
        # an input the output does not read (sequence_expand's Y)
        a = torch.zeros_like(leaf) if a is None else a
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL


def _layers_program(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        a = L.data(name='a', shape=[2], dtype='float32', lod_level=1)
        b = L.data(name='b', shape=[2], dtype='float32', lod_level=1)
        ids = L.data(name='ids', shape=[], dtype='int64', lod_level=1)
        off = L.data(name='off', shape=[1], dtype='int64')
        ln = L.data(name='ln', shape=[1], dtype='int64')
        cat = L.sequence_concat(input=[a, b])
        sl = L.sequence_slice(input=a, offset=off, length=ln)
        er = L.sequence_erase(input=ids, tokens=[2])
        rs = L.lod_reset(x=a, target_lod=[1, 2, 3])
        ex = L.sequence_expand(x=L.sequence_pool(input=a, pool_type='sum'),
                               y=b)
        fetch = [L.sequence_pool(input=v, pool_type='sum')
                 for v in (cat, sl, rs, ex)] + [er]
    names = [v.name for v in fetch] + [er.name + '@LEN', cat.name + '@LEN']
    return main, names


def test_lengths_reach_the_outputs_companions():
    rng = np.random.default_rng(3)
    la, lb = np.asarray([3, 1, 2]), np.asarray([2, 2, 1])
    feed = {'a': (rng.standard_normal((3, 3, 2)).astype(np.float32), la),
            'b': (rng.standard_normal((3, 2, 2)).astype(np.float32), lb),
            'ids': (np.asarray([[2, 5, 2, 1], [3, 3, 0, 0], [2, 2, 2, 0]],
                               np.int64), np.asarray([4, 2, 3])),
            'off': np.asarray([[1], [0], [0]], np.int64),
            'ln': np.asarray([[2], [1], [1]], np.int64)}
    with jprog.reset_unique_name_guard():
        jmain, names = _layers_program(fluid)
    with tprog.reset_unique_name_guard():
        tmain, tnames = _layers_program(tfl)
    assert tnames == names and tmain.to_dict() == jmain.to_dict()
    want = fluid.Executor(fluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=names, scope=fluid.Scope())
    got = tfl.Executor(tfl.CPUPlace()).run(
        tmain, feed=feed, fetch_list=names, scope=tfl.Scope())
    for n, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, n
        assert np.abs(a.astype(np.float64) - b).max() <= TOL, n
    assert np.array_equal(got[-2], [2, 2, 0])   # 2s erased
    assert np.array_equal(got[-1], la + lb)


LAYERS = {
    'linear_chain_crf': lambda L, v: L.linear_chain_crf(
        v['x'], v['ids'], param_attr='crfw'),
    'crf_decoding': lambda L, v: L.crf_decoding(v['x'], param_attr='crfw'),
    'crf_decoding_label': lambda L, v: L.crf_decoding(
        v['x'], param_attr='crfw', label=v['ids']),
    'chunk_eval': lambda L, v: L.chunk_eval(v['ids'], v['ids'], 'IOBES', 2,
                                            excluded_chunk_types=[1]),
    'edit_distance': lambda L, v: L.edit_distance(v['tok'], v['tok'],
                                                  ignored_tokens=[0]),
    'warpctc': lambda L, v: L.warpctc(v['x'], v['tok'], blank=1,
                                      norm_by_times=True),
    'one_hot': lambda L, v: L.one_hot(v['ids'], depth=6),
    'im2sequence': lambda L, v: L.im2sequence(v['img'], filter_size=[2, 3],
                                              stride=2, padding=1),
    'row_conv': lambda L, v: L.row_conv(v['x'], future_context_size=2,
                                        act='relu'),
    'sequence_expand': lambda L, v: L.sequence_expand(
        L.sequence_pool(v['x'], 'max'), v['x']),
    'sequence_concat': lambda L, v: L.sequence_concat([v['x'], v['x']]),
    'sequence_slice': lambda L, v: L.sequence_slice(v['x'], v['off'],
                                                    v['off']),
    'lod_reset': lambda L, v: L.lod_reset(v['x'], y=v['off']),
}


def _layer_program(pkg, prog, layer):
    L = pkg.layers
    with prog.reset_unique_name_guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            v = dict(
                x=L.data(name='x', shape=[4], dtype='float32', lod_level=1),
                ids=L.data(name='ids', shape=[1], dtype='int64',
                           lod_level=1),
                tok=L.data(name='tok', shape=[], dtype='int64',
                           lod_level=1),
                img=L.data(name='img', shape=[2, 5, 6], dtype='float32'),
                off=L.data(name='off', shape=[1], dtype='int64'))
            LAYERS[layer](L, v)
    return main, startup


@pytest.mark.parametrize('layer', list(LAYERS))
def test_layer_serialises_to_the_reference_program(layer):
    jm, js = _layer_program(fluid, jprog, layer)
    tm, ts = _layer_program(tfl, tprog, layer)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()

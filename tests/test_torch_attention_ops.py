"""The serving attention ops and the composed attention, against the
reference on the CPU.

- ``paged_attention`` and ``chunked_prefill_attention`` as op types
  (paddle_tpu_torch/ops/attention.py): programs that name them, at
  tests/test_torch_attention.py's shapes (shuffled page tables, trash and
  out-of-pool ids, ragged context lengths; chunk starts 0, 8 and 12),
  built by the reference, handed over by ``to_dict`` and run by both
  executors on the same feeds, within 1e-5 absolute (float32 softmax
  over O(1) scores, other summation orders).  Their cost and memory
  models' reports equal the reference's on its sweep program; the decode
  engine reaches both through the registry.
- ``nets.scaled_dot_product_attention``'s composed form (``use_flash``
  False, or None with dropout): its program serialises to the
  reference's; at dropout 0 its output and the gradients of every
  parameter agree with the reference's within 1e-5 (float32 products
  and softmax; the reference's composed form never masks, so ``causal``
  changes nothing in either); with dropout the reference's masks are
  handed to the port's dropout op and the outputs agree within 1e-5;
  ``use_flash=True`` with dropout raises in both.
- ``paddle_tpu_torch::flash_fwd``: on CPU tensors it is
  ``_plain_forward``, bitwise; its fake implementation gives the shapes
  and dtypes of (o, lse); both refuse what the launcher refuses
  (non-contiguous, mixed or unsupported dtypes, mismatched or empty
  shapes).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog
from paddle_tpu.transpiler import cost_model as jcm
from paddle_tpu.transpiler import memory_model as jmm

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core.registry import get_op_impl
from paddle_tpu_torch.inference import decode as tdec
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.transpiler import cost_model, memory_model

from tests.test_zz_op_coverage import _sweep_program

import torch_serving_cases as cases

TOL = 1e-5


def _op_program(op, slots):
    """A reference program feeding ``slots`` ({slot: (name, shape,
    dtype)}) to one ``op`` writing ``out``."""
    with jprog.reset_unique_name_guard():
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            ins = {}
            for slot, (name, shape, dtype) in slots.items():
                ins[slot] = [fluid.layers.data(
                    name=name, shape=list(shape), dtype=dtype,
                    append_batch_size=False)]
            block = main.global_block()
            out = block.create_var(name='out', dtype='float32')
            block.append_op(type=op, inputs=ins, outputs={'Out': [out]},
                            attrs={})
    return main


def _run_both(main, feed):
    want, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=['out'], scope=fluid.Scope())
    tmain = tfl.Program.from_dict(main.to_dict())
    got, = tfl.Executor('cpu').run(tmain, feed=feed, fetch_list=['out'],
                                   scope=tfl.Scope())
    assert got.shape == np.shape(want)
    assert np.abs(got - np.asarray(want)).max() <= TOL
    return got


def _pools(rng, n, p, h, d):
    return (rng.standard_normal((n + 1, p, h, d)).astype(np.float32),
            rng.standard_normal((n + 1, p, h, d)).astype(np.float32))


def test_paged_attention_program_matches_reference():
    rng = np.random.default_rng(11)
    s, h, d, p, n, mpp = 3, 2, 8, 4, 16, 4
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k_pool, v_pool = _pools(rng, n, p, h, d)
    feed = {'q': q, 'kp': k_pool, 'vp': v_pool,
            'pt': np.asarray([[7, 2, 9, 16], [0, 5, 16, 16],
                              [3, 1, 4, 40]], np.int32),
            'ctx': np.asarray([13, 6, 16], np.int32)}
    main = _op_program('paged_attention', {
        'Q': ('q', q.shape, 'float32'),
        'KPool': ('kp', k_pool.shape, 'float32'),
        'VPool': ('vp', v_pool.shape, 'float32'),
        'PT': ('pt', (s, mpp), 'int32'), 'CtxLen': ('ctx', (s,), 'int32')})
    got = _run_both(main, feed)
    assert got.shape == (s, h, d)


@pytest.mark.parametrize('pos0,c', [(0, 8), (8, 8), (12, 5)])
def test_chunked_prefill_attention_program_matches_reference(pos0, c):
    rng = np.random.default_rng(13 + pos0)
    h, d, p, n, mpp = 2, 8, 4, 10, 6
    q = rng.standard_normal((c, h, d)).astype(np.float32)
    k_pool, v_pool = _pools(rng, n, p, h, d)
    feed = {'q': q, 'kp': k_pool, 'vp': v_pool,
            'pt': np.asarray([4, 9, 0, 7, 10, 10], np.int32),
            'pos0': np.asarray(pos0, np.int32)}
    main = _op_program('chunked_prefill_attention', {
        'Q': ('q', q.shape, 'float32'),
        'KPool': ('kp', k_pool.shape, 'float32'),
        'VPool': ('vp', v_pool.shape, 'float32'),
        'PT': ('pt', (mpp,), 'int32'), 'Pos0': ('pos0', (), 'int32')})
    _run_both(main, feed)


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except (ValueError, TypeError, IndexError, KeyError) as e:
        return type(e)


@pytest.mark.parametrize('op', ['paged_attention',
                                'chunked_prefill_attention'])
def test_ops_are_costed_and_sized_as_the_reference(op):
    p, fetches, feeds = _sweep_program(op)
    specs = {n: ((3, 4), 'float32') for n in feeds}
    tp = tfl.Program.from_dict(p.to_dict())
    assert _outcome(cost_model.analyze_cost, tp, fetches, specs) == \
        _outcome(jcm.analyze_cost, p, fetches, specs)
    assert _outcome(memory_model.analyze_memory, tp, fetches, specs) == \
        _outcome(jmm.analyze_memory, p, fetch_names=fetches,
                 feed_specs=specs)


def test_decode_engine_reaches_both_ops_through_the_registry(monkeypatch):
    cfg = ttr.TransformerConfig(vocab_size=64, seq_len=64, n_layers=2,
                                d_model=32, n_heads=4)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
    calls = {'paged_attention': 0, 'chunked_prefill_attention': 0}
    for op in calls:
        impl = get_op_impl(op)

        def counted(ctx, ins, attrs, _real=impl.compute, _op=op):
            calls[_op] += 1
            return _real(ctx, ins, attrs)
        monkeypatch.setattr(impl, 'compute', counted)
    eng = tdec.DecodeEngine(params, n_layers=2, n_heads=4, page_size=8,
                            max_streams=2, prefill_bucket=32,
                            device='cpu')
    prompt = np.arange(11) % 64
    pages = eng.cache.alloc(2)
    logits = eng.prefill_chunk(prompt[:8], pages, 0)
    logits = eng.prefill_chunk(prompt[8:], pages, 8)
    assert calls['chunked_prefill_attention'] == 2 * 2
    pt = np.full((2, eng.pages_per_stream), eng.cache.trash, np.int64)
    pt[0, :2] = pages
    _, step_logits = eng.step(np.asarray([int(np.argmax(logits)), 0]), pt,
                              np.asarray([11, 0]))
    assert calls['paged_attention'] == 2
    assert np.isfinite(logits).all() and step_logits.shape == (2, 64)


def _attention_net(use_flash=False, dropout=0.0, causal=False, heads=2):
    x = fluid.layers.data(name='x', shape=[6, 16], dtype='float32')
    q, k, v = (fluid.layers.fc(input=x, size=16, num_flatten_dims=2)
               for _ in range(3))
    ctx = fluid.nets.scaled_dot_product_attention(
        q, k, v, num_heads=heads, dropout_rate=dropout, use_flash=use_flash,
        causal=causal)
    return fluid.layers.mean(x=ctx), ctx


def _with_backward(**kw):
    loss, ctx = _attention_net(**kw)
    grads = fluid.backward.append_backward(loss)
    return loss, ctx, [g for _, g in grads]


@pytest.mark.parametrize('use_flash,dropout', [(False, 0.0), (None, 0.1)])
def test_composed_program_serialises_to_the_reference(use_flash, dropout):
    def build(pkg, prog_mod):
        with prog_mod.reset_unique_name_guard():
            main = pkg.Program()
            with pkg.program_guard(main, pkg.Program()):
                x = pkg.layers.data(name='x', shape=[6, 16],
                                    dtype='float32')
                pkg.nets.scaled_dot_product_attention(
                    x, x, x, num_heads=2, dropout_rate=dropout,
                    use_flash=use_flash)
        return main
    jmain = build(fluid, jprog)
    tmain = build(tfl, tfl.core.program)
    assert tmain.to_dict() == jmain.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    assert 'flash_attention' not in types
    assert types.count('matmul') == 2 and 'softmax' in types
    assert ('dropout' in types) == bool(dropout)


@pytest.mark.parametrize('causal', [False, True])
def test_composed_attention_and_grads_match_the_reference(causal):
    jmain, jexe, jscope, (loss, ctx, grads) = cases.reference(
        _with_backward, seed=4, causal=causal)
    tmain, texe, tscope = cases.handover(jmain, jscope)
    feed = {'x': np.random.default_rng(5).standard_normal(
        (2, 6, 16)).astype(np.float32)}
    names = [ctx.name] + [g.name for g in grads]
    want = jexe.run(jmain, feed=feed, fetch_list=names, scope=jscope)
    got = texe.run(tmain, feed=feed, fetch_list=names, scope=tscope)
    assert len(grads) == 6
    for n, g, w in zip(names, got, want):
        assert g.shape == np.shape(w), n
        assert np.abs(g - np.asarray(w)).max() <= TOL, n


def test_composed_attention_dropout_with_the_reference_masks(monkeypatch):
    jmain, jexe, jscope, (loss, ctx) = cases.reference(
        _attention_net, seed=6, dropout=0.25)
    drop, = [op for op in jmain.global_block().ops if op.type == 'dropout']
    mask_name = drop.outputs['Mask'][0]
    feed = {'x': np.random.default_rng(7).standard_normal(
        (2, 6, 16)).astype(np.float32)}
    want, mask = jexe.run(jmain, feed=feed, fetch_list=[ctx, mask_name],
                          scope=jscope)
    mask = np.asarray(mask)
    assert 0 < mask.mean() < 1
    tmain, texe, tscope = cases.handover(jmain, jscope)

    def replay(ctx_, ins, attrs):
        m = torch.from_numpy(mask.copy()).to(ins['X'][0].dtype)
        return {'Out': [ins['X'][0] * m], 'Mask': [m]}
    monkeypatch.setattr(get_op_impl('dropout'), 'compute', replay)
    got, = texe.run(tmain, feed=feed, fetch_list=[ctx.name], scope=tscope)
    assert np.abs(got - np.asarray(want)).max() <= TOL


def test_flash_with_dropout_raises_in_both():
    for pkg in (fluid, tfl):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            x = pkg.layers.data(name='x', shape=[6, 16], dtype='float32')
            with pytest.raises(ValueError, match='dropout'):
                pkg.nets.scaled_dot_product_attention(
                    x, x, x, num_heads=2, dropout_rate=0.1, use_flash=True)


def test_flash_fwd_operator_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((4, 9, 8), generator=g) for _ in range(3))
    for causal, qo in ((True, 0), (False, 0), (True, 3)):
        o, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, causal,
                                                      0.35, qo, 0)
        po, plse = tfa._plain_forward(q, k, v, causal, 0.35, qo, 0)
        assert torch.equal(o, po) and torch.equal(lse, plse)
    from torch._subclasses.fake_tensor import FakeTensorMode
    qb = q.to(torch.bfloat16)
    with FakeTensorMode() as mode:
        fq = mode.from_tensor(qb)
        o, lse = tfa.flash_fwd(fq, fq, fq, True, 0.35, 0, 0)
        assert o.shape == (4, 9, 8) and o.dtype == torch.bfloat16
        assert lse.shape == (4, 9) and lse.dtype == torch.float32
    assert tfa.launches == 0


def test_flash_fwd_operator_checks_its_inputs():
    """A loaded artifact calls the operator directly, so each of its
    implementations checks q, k and v as the launcher does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q = torch.zeros((2, 8, 16))
    bad = [((q.transpose(1, 2).contiguous().transpose(1, 2), q, q),
            ValueError, 'contiguous'),
           ((q, q.double(), q), TypeError, 'float32, bfloat16'),
           ((q, q.half(), q.half()), TypeError, 'dtypes differ'),
           ((q, q[:, :, :8].contiguous(), q), ValueError, 'do not match'),
           ((q[:, :0].contiguous(), q, q), ValueError, 'empty')]
    for (a, b, c), err, msg in bad:
        with pytest.raises(err, match=msg):
            torch.ops.paddle_tpu_torch.flash_fwd(a, b, c, True, 0.25, 0, 0)
        with FakeTensorMode() as mode:
            fa, fb, fc = (mode.from_tensor(x) for x in (a, b, c))
            with pytest.raises(err, match=msg):
                tfa.flash_fwd(fa, fb, fc, True, 0.25, 0, 0)
    assert tfa.launches == 0

"""The port's fused LSTM (paddle_tpu_torch/ops/kernels/lstm.py) and its
``lstm`` op (ops/rnn.py) against the reference's, on the CPU.

- The plain forward and backward, through the port's autograd Function on
  CPU tensors, against the reference's Pallas kernel ``lstm_scan`` in
  interpret mode and its ``jax.vjp``: peepholes on and off, cotangents on
  h only and on both h and c.
- The port's ``lstm`` op against the reference's ``lstm`` op on its kernel
  path (``use_pallas`` with ``pallas_interpret``) and on its scan path:
  outputs, and the gradients of Input, Weight and Bias, for ragged
  lengths, ``is_reverse``, with and without peepholes.  The port's kernel
  path (plain versions on the CPU) and scan path must agree as well.
- ``lstm_unit`` against the reference op; what the slice does not bring
  raises.

Sizes stay small (T <= 8, B <= 4, H <= 16): interpret mode unrolls every
step.  Tolerances, float32 on both sides with other summation orders:
outputs 1e-5 absolute; gradients 1e-4 absolute (sums over T * B terms of
O(1)); the port's two paths against each other 1e-5 / 1e-4 likewise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.ops.pallas.lstm_cell import lstm_scan as jlstm_scan

from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.ops.kernels import gru as tg
from paddle_tpu_torch.ops.kernels import lstm as tl

TOL_OUT = 1e-5
TOL_GRAD = 1e-4


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize('peepholes,with_ct_c', [(True, True), (True, False),
                                                 (False, True)])
def test_plain_kernel_versions_match_the_reference_kernel(peepholes,
                                                          with_ct_c):
    rng = np.random.default_rng(3)
    T, B, H = 6, 3, 8
    x = _rand(rng, (T, B, 4 * H))
    w = _rand(rng, (H, 4 * H), 0.5)
    pw = _rand(rng, (3, H), 0.3) if peepholes else None
    ct_h = _rand(rng, (T, B, H))
    ct_c = _rand(rng, (T, B, H)) if with_ct_c else np.zeros((T, B, H),
                                                            np.float32)
    jargs = [x, w] + ([pw] if peepholes else [])
    (hs, cs), vjp = jax.vjp(
        lambda *a: jlstm_scan(*a, interpret=True), *jargs)
    want = vjp((jnp.asarray(ct_h), jnp.asarray(ct_c)))

    targs = [torch.tensor(a, requires_grad=True) for a in jargs]
    ths, tcs = tl.lstm_scan(*targs)
    assert np.abs(ths.detach().numpy() - np.asarray(hs)).max() <= TOL_OUT
    assert np.abs(tcs.detach().numpy() - np.asarray(cs)).max() <= TOL_OUT
    outs, cts = [ths], [torch.tensor(ct_h)]
    if with_ct_c:   # else the cell's cotangent reaches the Function as None
        outs.append(tcs)
        cts.append(torch.tensor(ct_c))
    got = torch.autograd.grad(outs, targs, cts)
    for g, r, name in zip(got, want, ('dx', 'dw', 'dpw')):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= TOL_GRAD, name
    assert tl.launches == tl.bwd_launches == 0   # CPU: plain versions only


def test_no_grad_forward_matches_and_skips_the_gates():
    rng = np.random.default_rng(4)
    T, B, H = 5, 4, 16
    x, w, pw = (torch.tensor(_rand(rng, s, 0.5))
                for s in ((T, B, 4 * H), (H, 4 * H), (3, H)))
    hs, cs, gates = tl._lstm_forward(x, w, pw, with_gates=False)
    assert gates is None
    with torch.no_grad():
        hs2, cs2 = tl.lstm_scan(x, w, pw)
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2)
    want = jlstm_scan(x.numpy(), w.numpy(), pw.numpy(), interpret=True)
    assert np.abs(hs.numpy() - np.asarray(want[0])).max() <= TOL_OUT


def test_wrapper_rejects_what_the_kernels_do_not_take():
    x = torch.zeros((4, 2, 32))
    w = torch.zeros((8, 32))
    with pytest.raises(TypeError, match='takes float32'):
        tl.lstm_scan(x.bfloat16(), w)
    with pytest.raises(ValueError, match='do not match'):
        tl.lstm_scan(x, torch.zeros((8, 16)))
    with pytest.raises(ValueError, match='empty'):
        tl.lstm_scan(torch.zeros((0, 2, 32)), w)


def _op_inputs(rng, B, T, H, peepholes, lengths):
    ins = {'Input': _rand(rng, (B, T, 4 * H)),
           'Weight': _rand(rng, (H, 4 * H), 0.5),
           'Bias': _rand(rng, (1, (7 if peepholes else 4) * H), 0.3)}
    if lengths is not None:
        ins['XLen'] = np.asarray(lengths, np.int32)
    return ins


def _ref_op(ins, attrs, ct):
    """The reference op's outputs and d(sum(Hidden * ct))/d(Input, Weight,
    Bias) by jax.grad."""
    impl = jget_op('lstm')
    wrt = ('Input', 'Weight', 'Bias')

    class _Ctx(object):
        pass

    def run(*vals):
        staged = {k: [jnp.asarray(v)] for k, v in ins.items()}
        for k, v in zip(wrt, vals):
            staged[k] = [v]
        return impl.compute(_Ctx(), staged, dict(attrs))

    def loss(*vals):
        return jnp.sum(run(*vals)['Hidden'][0] * ct)

    vals = [jnp.asarray(ins[k]) for k in wrt]
    outs = run(*vals)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*vals)
    return ([np.asarray(outs['Hidden'][0]), np.asarray(outs['Cell'][0])],
            [np.asarray(g) for g in grads])


def _port_op(ins, attrs, ct):
    impl = tget_op('lstm')
    wrt = ('Input', 'Weight', 'Bias')
    staged = {k: [torch.tensor(v, requires_grad=k in wrt)]
              for k, v in ins.items()}
    outs = impl.compute(None, staged, dict(attrs))
    hid, cell = outs['Hidden'][0], outs['Cell'][0]
    grads = torch.autograd.grad((hid * torch.tensor(ct)).sum(),
                                [staged[k][0] for k in wrt])
    return ([hid.detach().numpy(), cell.detach().numpy()],
            [g.numpy() for g in grads])


OP_CASES = [
    # name, B, T, H, peepholes, lengths, is_reverse
    ('full', 3, 6, 8, True, None, False),
    ('ragged', 4, 7, 8, True, [7, 3, 5, 1], False),
    ('ragged_reverse', 4, 7, 8, True, [7, 3, 5, 1], True),
    ('reverse_no_peepholes', 3, 8, 16, False, [2, 8, 6], True),
    ('full_reverse', 2, 5, 8, False, None, True),
]


@pytest.mark.parametrize('name,B,T,H,peep,lengths,rev', OP_CASES,
                         ids=[c[0] for c in OP_CASES])
def test_lstm_op_matches_the_reference_op(name, B, T, H, peep, lengths, rev):
    rng = np.random.default_rng(len(name))
    ins = _op_inputs(rng, B, T, H, peep, lengths)
    ct = _rand(rng, (B, T, H))
    attrs = {'use_peepholes': peep, 'is_reverse': rev}
    kernel_attrs = dict(attrs, use_pallas=True, pallas_interpret=True)
    ref_kernel = _ref_op(ins, kernel_attrs, ct)
    ref_scan = _ref_op(ins, attrs, ct)
    port_kernel = _port_op(ins, kernel_attrs, ct)
    port_scan = _port_op(ins, attrs, ct)
    for got, want in ((port_kernel, ref_kernel), (port_scan, ref_scan),
                      (port_kernel, port_scan)):
        for a, b in zip(got[0], want[0]):
            assert np.abs(a - b).max() <= TOL_OUT
        for a, b, slot in zip(got[1], want[1], ('Input', 'Weight', 'Bias')):
            assert np.abs(a - b).max() <= TOL_GRAD, slot
    if lengths is not None:   # padded steps are zero on both paths
        pad = np.arange(T)[None, :] >= np.asarray(lengths)[:, None]
        assert not port_kernel[0][0][pad].any()
        assert not port_kernel[1][0][pad].any()   # nor reach dInput


def test_lstm_op_scan_path_for_custom_activations_and_initial_state():
    """Configurations the kernel does not take run the scan path, as in
    the reference: a relu candidate, and a chained H0 / C0."""
    rng = np.random.default_rng(9)
    B, T, H = 3, 5, 8
    ins = _op_inputs(rng, B, T, H, True, [5, 2, 4])
    cases = [({'use_pallas': True, 'candidate_activation': 'relu'}, {}),
             ({'use_pallas': True}, {'H0': _rand(rng, (B, H)),
                                     'C0': _rand(rng, (B, H))})]
    for attrs, extra in cases:
        both = dict(ins, **extra)
        want = jget_op('lstm').compute(
            None, {k: [jnp.asarray(v)] for k, v in both.items()}, attrs)
        got = tget_op('lstm').compute(
            None, {k: [torch.tensor(v)] for k, v in both.items()}, attrs)
        for slot in ('Hidden', 'Cell'):
            assert np.abs(got[slot][0].numpy()
                          - np.asarray(want[slot][0])).max() <= TOL_OUT
    assert tl.launches == 0


def test_lstm_unit_matches_the_reference_op():
    rng = np.random.default_rng(10)
    ins = {'X': _rand(rng, (4, 32)), 'C_prev': _rand(rng, (4, 8))}
    attrs = {'forget_bias': 0.5}
    want = jget_op('lstm_unit').compute(
        None, {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
    got = tget_op('lstm_unit').compute(
        None, {k: [torch.tensor(v)] for k, v in ins.items()}, attrs)
    for slot in ('C', 'H'):
        assert np.abs(got[slot][0].numpy()
                      - np.asarray(want[slot][0])).max() <= TOL_OUT


@pytest.mark.parametrize('op', ['gru', 'gru_unit'])
def test_gru_ops_raise_naming_the_seq2seq_slice(op):
    """The GRU ops came with the seq2seq slice (tests/test_torch_gru.py
    holds them against the reference).  The bfloat16 build of
    benchmarks/bench_seq2seq.py, which raised here until the AMP slice,
    now computes in float32 and hands Hidden back in bfloat16, as the
    reference's ops do (paddle_tpu/ops/rnn.py:235)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal(
        (2, 3, 24) if op == 'gru' else (2, 24)).astype(np.float32))
    w = torch.tensor(0.3 * rng.standard_normal((8, 24)).astype(np.float32))
    hp = torch.tensor(rng.standard_normal((2, 8)).astype(np.float32))
    low = {'Input': [x.bfloat16()], 'Weight': [w], 'HiddenPrev': [hp]}
    f32 = {'Input': [x.bfloat16().float()], 'Weight': [w],
           'HiddenPrev': [hp]}
    attrs = {'use_pallas': True}
    got = tget_op(op).compute(None, low, attrs)['Hidden'][0]
    want = tget_op(op).compute(None, f32, attrs)['Hidden'][0]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize('h, blocks', [(4, 1), (32, 1), (128, 4), (256, 8),
                                       (416, 13), (420, 0), (1024, 0),
                                       (1136, 0)])
def test_backward_path_rule_by_width(h, blocks):
    """#8's chain by hidden width: a cluster of ceil(H / 32) blocks holds
    W up to 416 units (H=32, phase 21b's padded 30, takes one block; the
    sentiment net's 128 four, the LM's 256 eight); the first width past it
    and wider ones take the row-tiled chain, up to the backward's cap."""
    assert tl.cluster_size(h) == blocks
    assert tl.bwd_path(h) == ('cluster' if blocks else 'wide')
    assert tl.kernel_takes(h)


@pytest.mark.parametrize('h, blocks', [(4, 1), (32, 1), (128, 4), (256, 8),
                                       (416, 13), (420, 0), (1024, 0),
                                       (1136, 0)])
def test_forward_path_rule_by_width(h, blocks):
    """#7's time loop by hidden width, by #8's rule: a cluster of ceil(H /
    32) blocks holds W's columns up to 416 units (the LM's 256 take eight
    blocks, the sentiment net's 128 four); the first width past it and
    wider ones take the row-tiled loop, up to its cap."""
    assert tl.cluster_size(h) == blocks
    assert tl.fwd_path(h) == tl.bwd_path(h) == ('cluster' if blocks
                                                 else 'wide')
    assert tl.padded_width(h) <= tl.max_hidden('lstm_fwd')


def test_forward_cluster_cap_is_what_shared_memory_holds():
    """#7's cluster holds 416 units as #8's does: W's columns of 32 units
    over four gate parts of 32 cs rows (+ 4 floats a row) and two h slices
    of one 16-row m-tile (16 x 32 floats each) fit a block's 232448 bytes
    at 13 blocks, not at 14, and so do they with the four gate regions
    where the m-tile's pre-activations meet (csrc/lstm_fwd.cu
    kChainMaxBlocks, gru_cluster.cuh smem_bytes)."""
    def smem(cs, slices):
        return 4 * (32 * (4 * 32 * cs + 4) + slices * 16 * 32)
    for slices in (2, 2 + 4):
        assert smem(13, slices) <= 232448 < smem(14, slices), slices
    assert smem(13, 2) == 217600 and smem(14, 2) == 233984
    assert tl.CLUSTER_UNITS * tl.MAX_CLUSTER_BLOCKS == 416


def test_cluster_cap_is_what_shared_memory_holds():
    """416 units: W's rows of 32 units over four gate parts of 32 cs
    columns (+ 4 floats a row) and two steps' slices of one 16-row m-tile
    (4 parts of 16 x 32 floats each) fit a block's 232448 bytes at 13
    blocks, not at 14 (csrc/gru_cluster.cuh smem_bytes, max_blocks)."""
    def smem(cs):
        return 4 * (32 * (4 * 32 * cs + 4) + 2 * 4 * 16 * 32)
    assert smem(13) <= 232448 < smem(14)
    assert tl.MAX_CLUSTER_BLOCKS == 13
    assert tl.CLUSTER_UNITS * tl.MAX_CLUSTER_BLOCKS == 416


@pytest.mark.parametrize('h, max_blocks, blocks', [
    (4, 13, 1), (32, 13, 1), (416, 13, 13), (420, 13, 0), (420, 16, 14),
    (512, 16, 16), (516, 16, 0), (0, 16, 0)])
def test_cluster_blocks_is_one_rule_for_every_cluster_chain(h, max_blocks,
                                                            blocks):
    """#8's rule (13 blocks at most) and #9's and #10's (16) are one
    helper with two caps: ceil(H / 32) blocks up to 32 units a block times
    the cap, none past it."""
    assert tl.cluster_blocks(h, max_blocks) == blocks
    assert tg.CLUSTER_UNITS is tl.CLUSTER_UNITS
    assert tl.cluster_size(h) == tl.cluster_blocks(h, tl.MAX_CLUSTER_BLOCKS)
    assert tg.cluster_size(h) == tl.cluster_blocks(h, tg.MAX_CLUSTER_BLOCKS)


def test_width_caps_and_route_are_unchanged():
    """The cluster path adds no width cap: the route still takes every
    multiple of 4 up to the backward's row-tiled cap at 8 rows a block,
    and sends wider ones to the eager scan."""
    assert tl.max_hidden('lstm_bwd') == tl.max_hidden('lstm_bwd', 8) == 1139
    assert tl.max_hidden('lstm_fwd') == 1210
    assert tl.max_hidden('lstm_bwd', 16) == 0
    assert tl.ROWS_PER_BLOCK == 8
    assert tl.kernel_takes(1136) and tl.kernel_takes(1133)
    assert not tl.kernel_takes(1137) and not tl.kernel_takes(1140)


@pytest.mark.parametrize('h', [8, 420])
def test_cpu_tensors_leave_the_launch_counters_at_zero(h):
    """On CPU tensors the wrappers run the plain versions and count no
    launch, at a width of either of #7's and #8's paths."""
    rng = np.random.default_rng(6)
    T, B = 3, 2
    x = torch.tensor(_rand(rng, (T, B, 4 * h)))
    w = torch.tensor(_rand(rng, (h, 4 * h), 0.5))
    pw = torch.tensor(_rand(rng, (3, h), 0.3))

    def counts():
        return (tl.launches, tl.fwd_cluster_launches, tl.bwd_launches,
                tl.bwd_cluster_launches)
    before = counts()
    hs, cs, gates = tl._lstm_forward(x, w, pw, with_gates=True)
    dx, dw, dpw = tl._lstm_backward(w, pw, hs, cs, gates,
                                    torch.ones_like(hs), None)
    assert dx.shape == (T, B, 4 * h) and dw.shape == (h, 4 * h)
    assert dpw.shape == (3, h)
    assert counts() == before == (0, 0, 0, 0)


@pytest.mark.parametrize('T,B,H,with_ct_c', [(4, 13, 100, True),
                                             (3, 13, 32, False),
                                             (5, 3, 100, False)])
def test_plain_backward_matches_the_reference_backward(T, B, H, with_ct_c):
    """``_plain_lstm_backward`` against the reference's ``_lstm_backward``
    (the Pallas BPTT kernel in interpret mode) on the reference forward's
    saved state, at the cluster path's edge shapes: a width with units
    past H within a block (100), a batch that is no multiple of 8 or 16
    rows (13), one block's width (32)."""
    from paddle_tpu.ops.pallas import lstm_cell
    rng = np.random.default_rng(T * 1000 + B * 10 + H)
    x = _rand(rng, (T, B, 4 * H))
    w = _rand(rng, (H, 4 * H), H ** -0.5)
    pw = _rand(rng, (3, H), 0.3)
    ct_h = _rand(rng, (T, B, H))
    ct_c = _rand(rng, (T, B, H)) if with_ct_c else np.zeros((T, B, H),
                                                            np.float32)
    hs, cs, gates = lstm_cell._lstm_forward(x, w, pw, True, True)
    want = lstm_cell._lstm_backward(w, pw, hs, cs, gates, ct_h, ct_c, True)
    got = tl._plain_lstm_backward(
        *(torch.tensor(np.asarray(a)) for a in (w, pw, hs, cs, gates, ct_h)),
        torch.tensor(ct_c) if with_ct_c else None)
    for g, r, name in zip(got, want, ('dx', 'dw', 'dpw')):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= TOL_GRAD, name


@pytest.mark.parametrize('H', [416, 420])
def test_plain_forward_matches_the_reference_kernel_at_the_cap(H):
    """``_plain_lstm_forward`` against the reference's ``_lstm_forward``
    (the Pallas kernel in interpret mode) at the cluster path's cap and
    the first width past it, where #7 changes path: hs, cs and the
    post-activation gates that #8 replays."""
    from paddle_tpu.ops.pallas import lstm_cell
    rng = np.random.default_rng(H)
    T, B = 3, 2
    x = _rand(rng, (T, B, 4 * H))
    w = _rand(rng, (H, 4 * H), H ** -0.5)
    pw = _rand(rng, (3, H), 0.3)
    want = lstm_cell._lstm_forward(x, w, pw, True, True)
    got = tl._plain_lstm_forward(*(torch.tensor(a) for a in (x, w, pw)))
    for g, r, name in zip(got, want, ('hs', 'cs', 'gates')):
        assert g.shape == np.asarray(r).shape, name
        assert np.abs(g.numpy() - np.asarray(r)).max() <= TOL_OUT, name

"""The port's fused GRU (paddle_tpu_torch/ops/kernels/gru.py) and its ``gru``
and ``gru_unit`` ops (ops/rnn.py) against the reference's, on the CPU.

- The plain forward and backward, through the port's autograd Function on
  CPU tensors, against the reference's Pallas kernel ``gru_scan`` in
  interpret mode and its ``jax.vjp``, with and without h0 (so dh0 is
  compared), with a cotangent on h.
- The port's ``gru`` op against the reference's ``gru`` op on its kernel
  path (``use_pallas`` with ``pallas_interpret``) and on its scan path:
  outputs, and the gradients of Input, Weight, Bias and H0, for ragged
  lengths, ``is_reverse`` and H0 with ragged lengths.  The port's kernel
  path (plain versions on the CPU) and scan path must agree as well.
- ``gru_unit`` against the reference op, its integer activation codes
  included; what the wrappers do not take raises.
- The kernels' path rule (the cluster chain up to 512 units, the wide
  kernels past it; one rule for the forward and the BPTT kernel), decided
  without a build, the kernels' width caps, and the launch counters,
  which CPU tensors leave at 0.

Sizes stay small (T <= 8, B <= 4, H <= 16): interpret mode unrolls every
step.  Tolerances, float32 on both sides with other summation orders:
outputs 1e-5 absolute; gradients 1e-4 absolute (sums over T * B terms of
O(1)); the port's two paths against each other likewise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op_impl as jget_op
from paddle_tpu.ops.pallas.lstm_cell import gru_scan as jgru_scan

from paddle_tpu_torch.core.registry import get_op_impl as tget_op
from paddle_tpu_torch.ops.kernels import gru as tg

TOL_OUT = 1e-5
TOL_GRAD = 1e-4


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize('with_h0', [True, False])
def test_plain_kernel_versions_match_the_reference_kernel(with_h0):
    rng = np.random.default_rng(3)
    T, B, H = 6, 3, 8
    x = _rand(rng, (T, B, 3 * H))
    w = _rand(rng, (H, 3 * H), 0.5)
    h0 = _rand(rng, (B, H), 0.5) if with_h0 else None
    ct = _rand(rng, (T, B, H))
    jargs = [x, w] + ([h0] if with_h0 else [])
    hs, vjp = jax.vjp(lambda *a: jgru_scan(*a, interpret=True), *jargs)
    want = vjp(jnp.asarray(ct))

    targs = [torch.tensor(a, requires_grad=True) for a in jargs]
    ths = tg.gru_scan(*targs)
    assert np.abs(ths.detach().numpy() - np.asarray(hs)).max() <= TOL_OUT
    got = torch.autograd.grad(ths, targs, torch.tensor(ct))
    for g, r, name in zip(got, want, ('dx', 'dw', 'dh0')):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= TOL_GRAD, name
    assert tg.launches == tg.bwd_launches == 0   # CPU: plain versions only


def test_backward_returns_dh0_and_treats_a_missing_cotangent_as_zero():
    rng = np.random.default_rng(4)
    T, B, H = 5, 4, 16
    x, w, h0 = (torch.tensor(_rand(rng, s, 0.5))
                for s in ((T, B, 3 * H), (H, 3 * H), (B, H)))
    hs, gates = tg._plain_gru_forward(x, w, h0)
    dx, dw, dh0 = tg._gru_backward(w, h0, hs, gates, None)
    assert not dx.any() and not dw.any() and not dh0.any()
    ct = torch.tensor(_rand(rng, (T, B, H)))
    dx, dw, dh0 = tg._gru_backward(w, h0, hs, gates, ct)
    assert dh0.shape == (B, H) and dh0.abs().max() > 0
    # h0 = None is a zero initial state: the same forward, dh0 still made
    hz, _ = tg._plain_gru_forward(x, w, torch.zeros((B, H)))
    hn, gn = tg._plain_gru_forward(x, w, None)
    assert torch.equal(hz, hn)
    assert tg._gru_backward(w, None, hn, gn, ct)[2].shape == (B, H)


def test_no_grad_forward_matches_and_skips_the_gates():
    rng = np.random.default_rng(5)
    T, B, H = 5, 4, 16
    x, w, h0 = (torch.tensor(_rand(rng, s, 0.5))
                for s in ((T, B, 3 * H), (H, 3 * H), (B, H)))
    hs, gates = tg._gru_forward(x, w, h0, with_gates=False)
    assert gates is None
    with torch.no_grad():
        assert torch.equal(tg.gru_scan(x, w, h0), hs)
    want = jgru_scan(x.numpy(), w.numpy(), h0.numpy(), interpret=True)
    assert np.abs(hs.numpy() - np.asarray(want)).max() <= TOL_OUT


def test_wrapper_rejects_what_the_kernels_do_not_take():
    x = torch.zeros((4, 2, 24))
    w = torch.zeros((8, 24))
    with pytest.raises(TypeError, match='takes float32'):
        tg.gru_scan(x.bfloat16(), w)
    with pytest.raises(ValueError, match='do not match'):
        tg.gru_scan(x, torch.zeros((8, 16)))
    with pytest.raises(ValueError, match='h0'):
        tg.gru_scan(x, w, torch.zeros((3, 8)))
    with pytest.raises(ValueError, match='empty'):
        tg.gru_scan(torch.zeros((0, 2, 24)), w)


def _op_inputs(rng, B, T, H, lengths, with_h0):
    ins = {'Input': _rand(rng, (B, T, 3 * H)),
           'Weight': _rand(rng, (H, 3 * H), 0.5),
           'Bias': _rand(rng, (1, 3 * H), 0.3)}
    if with_h0:
        ins['H0'] = _rand(rng, (B, H), 0.5)
    if lengths is not None:
        ins['XLen'] = np.asarray(lengths, np.int32)
    return ins


def _wrt(ins):
    return [k for k in ('Input', 'Weight', 'Bias', 'H0') if k in ins]


def _ref_op(ins, attrs, ct):
    """The reference op's Hidden and d(sum(Hidden * ct)) with respect to
    Input, Weight, Bias (and H0) by jax.grad."""
    impl = jget_op('gru')
    wrt = _wrt(ins)

    class _Ctx(object):
        pass

    def run(*vals):
        staged = {k: [jnp.asarray(v)] for k, v in ins.items()}
        for k, v in zip(wrt, vals):
            staged[k] = [v]
        return impl.compute(_Ctx(), staged, dict(attrs))['Hidden'][0]

    vals = [jnp.asarray(ins[k]) for k in wrt]
    grads = jax.grad(lambda *v: jnp.sum(run(*v) * ct),
                     argnums=tuple(range(len(wrt))))(*vals)
    return np.asarray(run(*vals)), [np.asarray(g) for g in grads]


def _port_op(ins, attrs, ct):
    wrt = _wrt(ins)
    staged = {k: [torch.tensor(v, requires_grad=k in wrt)]
              for k, v in ins.items()}
    hid = tget_op('gru').compute(None, staged, dict(attrs))['Hidden'][0]
    grads = torch.autograd.grad((hid * torch.tensor(ct)).sum(),
                                [staged[k][0] for k in wrt])
    return hid.detach().numpy(), [g.numpy() for g in grads]


OP_CASES = [
    # name, B, T, H, lengths, is_reverse, H0
    ('full', 3, 6, 8, None, False, False),
    ('ragged', 4, 7, 8, [7, 3, 5, 1], False, False),
    ('ragged_reverse', 4, 7, 8, [7, 3, 5, 1], True, False),
    ('ragged_h0', 4, 7, 16, [2, 7, 4, 6], False, True),
    ('ragged_reverse_h0', 3, 8, 8, [8, 1, 5], True, True),
    ('full_reverse', 2, 5, 8, None, True, False),
]


@pytest.mark.parametrize('name,B,T,H,lengths,rev,with_h0', OP_CASES,
                         ids=[c[0] for c in OP_CASES])
def test_gru_op_matches_the_reference_op(name, B, T, H, lengths, rev,
                                         with_h0):
    rng = np.random.default_rng(len(name))
    ins = _op_inputs(rng, B, T, H, lengths, with_h0)
    ct = _rand(rng, (B, T, H))
    attrs = {'is_reverse': rev}
    kernel_attrs = dict(attrs, use_pallas=True, pallas_interpret=True)
    ref_kernel = _ref_op(ins, kernel_attrs, ct)
    ref_scan = _ref_op(ins, attrs, ct)
    port_kernel = _port_op(ins, kernel_attrs, ct)
    port_scan = _port_op(ins, attrs, ct)
    for got, want in ((port_kernel, ref_kernel), (port_scan, ref_scan),
                      (port_kernel, port_scan)):
        assert np.abs(got[0] - want[0]).max() <= TOL_OUT
        for a, b, slot in zip(got[1], want[1], _wrt(ins)):
            assert np.abs(a - b).max() <= TOL_GRAD, slot
    if lengths is not None:   # padded steps are zero on both paths
        pad = np.arange(T)[None, :] >= np.asarray(lengths)[:, None]
        assert not port_kernel[0][pad].any()
        assert not port_kernel[1][0][pad].any()   # nor reach dInput


def test_gru_op_scan_path_for_custom_activations():
    """A relu candidate is not the kernels' function: both packages run
    their scan path."""
    rng = np.random.default_rng(9)
    ins = _op_inputs(rng, 3, 5, 8, [5, 2, 4], True)
    attrs = {'use_pallas': True, 'activation': 'relu'}
    want = jget_op('gru').compute(
        None, {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
    got = tget_op('gru').compute(
        None, {k: [torch.tensor(v)] for k, v in ins.items()}, attrs)
    assert np.abs(got['Hidden'][0].numpy()
                  - np.asarray(want['Hidden'][0])).max() <= TOL_OUT
    assert tg.launches == 0


@pytest.mark.parametrize('attrs', [
    {}, {'activation': 'tanh', 'gate_activation': 'sigmoid'},
    {'activation': 3, 'gate_activation': 2}, {'activation': 0}])
@pytest.mark.parametrize('with_bias', [True, False])
def test_gru_unit_matches_the_reference_op(attrs, with_bias):
    rng = np.random.default_rng(10)
    ins = {'Input': _rand(rng, (4, 24)), 'HiddenPrev': _rand(rng, (4, 8)),
           'Weight': _rand(rng, (8, 24), 0.5)}
    if with_bias:
        ins['Bias'] = _rand(rng, (1, 24), 0.3)
    want = jget_op('gru_unit').compute(
        None, {k: [jnp.asarray(v)] for k, v in ins.items()}, dict(attrs))
    got = tget_op('gru_unit').compute(
        None, {k: [torch.tensor(v)] for k, v in ins.items()}, dict(attrs))
    for slot in ('Hidden', 'ResetHiddenPrev', 'Gate'):
        assert np.abs(got[slot][0].numpy()
                      - np.asarray(want[slot][0])).max() <= TOL_OUT, slot


@pytest.mark.parametrize('h, blocks', [(4, 1), (32, 1), (256, 8), (512, 16),
                                       (516, 0), (1024, 0), (1816, 0)])
def test_backward_path_rule_by_width(h, blocks):
    """#10's chain by hidden width: a cluster of ceil(H / 32) blocks holds
    W up to 512 units (H=32, phase 21b's padded 30, takes one block; the
    seq2seq width 16, the most a cluster takes); the first width past it
    and wider ones take the wide chain, up to the backward's cap."""
    assert tg.cluster_size(h) == blocks
    assert tg.bwd_path(h) == ('cluster' if blocks else 'wide')
    assert tg.kernel_takes(h)


def test_width_caps_and_route_are_unchanged():
    """The cluster path adds no width cap: the route still takes every
    multiple of 4 up to the wide chain's shared-memory cap at 8 rows a
    block, and sends wider ones to the eager scan."""
    assert tg.max_hidden('gru_bwd') == tg.max_hidden('gru_bwd', 8) == 1816
    assert tg.max_hidden('gru_bwd', 16) == 908
    assert tg.max_hidden('gru_fwd') == 2421
    assert tg.max_hidden('gru_fwd', 16) == 1210
    assert tg.max_hidden('gru_bwd', 12) == 0
    assert tg.ROWS_PER_BLOCK == 8
    assert tg.kernel_takes(1816) and tg.kernel_takes(1813)
    assert not tg.kernel_takes(1817) and not tg.kernel_takes(1820)
    assert tg.CLUSTER_UNITS * tg.MAX_CLUSTER_BLOCKS == 512


@pytest.mark.parametrize('h', [4, 32, 256, 512, 516, 1024, 1816])
def test_forward_takes_the_backward_path_rule(h):
    """#9 takes #10's path at every width of chip_smoke.py's rule check:
    one cluster rule for both kernels, decided without a build."""
    assert tg.fwd_path(h) == tg.bwd_path(h)
    assert tg.fwd_path(h) == ('cluster' if h <= 512 else 'wide')


@pytest.mark.parametrize('h', [8, 40])
def test_cpu_tensors_leave_the_launch_counters_at_zero(h):
    """On CPU tensors the wrappers run the plain versions and count no
    launch, on either of #9's and #10's paths' widths."""
    rng = np.random.default_rng(5)
    T, B = 3, 2
    x = torch.tensor(_rand(rng, (T, B, 3 * h)))
    w = torch.tensor(_rand(rng, (h, 3 * h), 0.5))
    h0 = torch.tensor(_rand(rng, (B, h), 0.5))
    def counts():
        return (tg.launches, tg.fwd_cluster_launches, tg.bwd_launches,
                tg.bwd_cluster_launches)
    before = counts()
    hs, gates = tg._gru_forward(x, w, h0, with_gates=True)
    dx, dw, dh0 = tg._gru_backward(w, h0, hs, gates, torch.ones_like(hs))
    assert dx.shape == (T, B, 3 * h) and dw.shape == (h, 3 * h)
    assert dh0.shape == (B, h)
    assert counts() == before == (0, 0, 0, 0)

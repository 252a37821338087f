"""The dense op library's op types (paddle_tpu_torch/ops/{activations,
loss,math,tensor_ops,conv,pool,norm,detection,random}.py) against the
reference's ops on the same seeded numpy inputs
(tests/torch_op_library_cases.py), on the CPU.

- Every output of every case: slots, shapes and dtypes equal to the
  reference's; integer outputs exactly, float outputs within ``TOL``.
- The gradient of every differentiable case from ``torch.autograd``
  against ``jax.vjp`` of the reference op, with respect to every float
  input, under a seeded cotangent; the cases put inputs exactly on the
  bounds and ties the reference's gradients treat specially (the clips'
  bounds pass half a cotangent, ``jnp.abs`` has slope 1 at 0, a
  maximum's tie splits, ``jnp.max`` spreads over tied maxima).
- ``clip``'s gradient at both bounds against ``jax.grad`` (0.5 each).
- ``nce``: its cost and sample logits given the reference's samples
  (``loss.nce_cost``), with the gradients; the port's own draws are the
  labels first, then negatives uniform over ``num_total_classes``.
- ``random_crop``: the port's output is X's window at a start in range,
  one start for the batch, and the starts over 400 steps are uniform.
- Every layer of the slice (layers/nn.py, layers/tensor.py and the 16
  new activation layers of layers/ops.py) builds a program that
  serialises to exactly the reference's, its startup program too; run
  by both executors from the reference's initial state, every fetched
  output agrees within ``TOL`` (nce's cost: its shape and finiteness).
- Under AMP's bfloat16, the white ops (the convolution family,
  ``conv_shift``, ``bilinear_tensor_product``) take bf16 inputs and
  return bf16, within bf16 rounding of their float32 result.

Tolerances: ``TOL`` 1e-5 relative to max(1, |reference|) for the float
outputs and gradients (float32 sums of at most a few hundred O(1) terms,
summed in other orders: conv and einsum paths, the lrn window).  ``nce``
is held to the same.  bf16 white ops: 3e-2 relative to the float32
output's largest entry (bf16 keeps 8 bits; sums of up to 54 products).
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
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.ops import loss as tloss

from torch_op_library_cases import CASES, GRAD_OUT, NO_GRAD, RANDOM_CASES

TOL = 1e-5
TOL_BF16 = 3e-2


class _JaxCtx(object):
    """The reference's per-op key source, for its random ops."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def rng(self, extra=0):
        return jax.random.fold_in(self.key, extra)


class _TorchCtx(object):
    """The port's per-op generator source, on the CPU."""
    device = torch.device('cpu')

    def __init__(self, seed):
        self.seed = seed

    def generator(self, extra=0):
        return torch.Generator().manual_seed(self.seed * 1000 + extra)


def _narrow(v):
    return v.astype(np.int32) if v.dtype == np.int64 else v


def _ref(op, ins, attrs, ctx=None):
    return jget_op(op).compute(
        ctx, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))


def _port(op, ins, attrs, ctx=None):
    return tget_op(op).compute(
        ctx or _TorchCtx(0), {k: [torch.tensor(_narrow(v)) for v in vs]
                              for k, vs in ins.items()}, dict(attrs))


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not a.size:
        return 0.0
    diff = np.where(a == b, 0.0, np.abs(a - b))   # equal infinities
    return float((diff / np.maximum(1.0, np.abs(b))).max())


def _float_inputs(ins):
    return [(k, i) for k, vs in ins.items() for i, v in enumerate(vs)
            if v.dtype == np.float32]


def _with_values(ins, diff, vals, wrap):
    out = {k: [wrap(v) for v in vs] for k, vs in ins.items()}
    for (k, i), v in zip(diff, vals):
        out[k][i] = v
    return out


def _reference(compute, ins, slot, seed):
    """The reference's outputs of ``compute`` (a function of the inputs
    dict) and, when ``slot`` is not None, the gradients of its ``slot``
    output with respect to every float input under a cotangent drawn
    from ``seed``, in one jitted call.  Returns (outputs, cotangent,
    gradients)."""
    diff = _float_inputs(ins) if slot else []
    vals = [jnp.asarray(ins[k][i]) for k, i in diff]

    def outputs(*v):
        outs = compute(_with_values(ins, diff, v, jnp.asarray))
        return (outs[slot][0] if slot else 0.0), outs
    if not slot:
        return jax.jit(lambda: outputs()[1])(), None, []
    shape = jax.eval_shape(lambda *v: outputs(*v)[0], *vals)
    ct = np.random.default_rng(seed).standard_normal(shape.shape).astype(
        np.float32)

    def run(v, c):
        _, vjp, outs = jax.vjp(outputs, *v, has_aux=True)
        return outs, vjp(c)
    outs, grads = jax.jit(run)(vals, jnp.asarray(ct))
    return outs, ct, grads


def _port_grads(compute, ins, slot, ct):
    """The port's outputs of ``compute`` and the gradients of its
    ``slot`` output under ``ct``, with respect to every float input."""
    diff = _float_inputs(ins) if slot else []
    leaves = [torch.tensor(ins[k][i], requires_grad=True) for k, i in diff]
    outs = compute(_with_values(ins, diff, leaves,
                                lambda v: torch.tensor(_narrow(v))))
    if not slot:
        return outs, []
    got = torch.autograd.grad(outs[slot][0], leaves, torch.tensor(ct),
                              allow_unused=True)
    return outs, [torch.zeros_like(leaf) if g is None else g
                  for g, leaf in zip(got, leaves)]


def _grad_slot(op, ins):
    if op in NO_GRAD or not _float_inputs(ins):
        return None
    return GRAD_OUT.get(op, 'Out')


@pytest.mark.parametrize('case', sorted(
    n for n, (op, _, _) in CASES.items() if op != 'nce'))
def test_outputs_and_gradients_match_the_reference(case):
    op, ins, attrs = CASES[case]
    slot = _grad_slot(op, ins)
    want, ct, want_grads = _reference(
        lambda j: jget_op(op).compute(None, j, dict(attrs)), ins, slot,
        sum(map(ord, case)))
    got, grads = _port_grads(
        lambda t: tget_op(op).compute(_TorchCtx(0), t, dict(attrs)), ins,
        slot, ct)
    assert sorted(got) == sorted(want)
    for s in want:
        a, b = got[s][0].detach().numpy(), np.asarray(want[s][0])
        assert a.shape == b.shape and a.dtype == b.dtype, (s, a.dtype,
                                                          b.dtype)
        if np.issubdtype(b.dtype, np.floating):
            assert _gap(a, b) <= TOL, (s, _gap(a, b))
        else:
            assert np.array_equal(a, b), s
    for (k, i), a, b in zip(_float_inputs(ins), grads, want_grads):
        assert a.shape == np.shape(b)
        assert _gap(a.numpy(), b) <= TOL, ('grad', k, i, _gap(a.numpy(), b))


def test_clip_gradient_at_its_bounds_matches_jax():
    """``jnp.clip`` passes half the cotangent at either bound
    (``lax.max`` / ``lax.min`` split a tie); ``torch.clamp`` would pass
    all of it."""
    x = np.asarray([-2.0, -1.0, 0.0, 0.5, 1.0, 2.0], np.float32)
    attrs = {'min': -1.0, 'max': 1.0}
    want = jax.grad(lambda v: jget_op('clip').compute(
        None, {'X': [v]}, attrs)['Out'][0].sum())(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    tget_op('clip').compute(None, {'X': [t]}, attrs)['Out'][0].sum().backward()
    assert np.array_equal(np.asarray(want), [0, 0.5, 1, 1, 0.5, 0])
    assert np.array_equal(t.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize('case', ['nce', 'nce_two_true'])
def test_nce_given_the_reference_samples(case):
    op, ins, attrs = CASES[case]
    want, ct, want_grads = _reference(
        lambda j: jget_op(op).compute(_JaxCtx(3), j, dict(attrs)), ins,
        'Cost', 11)
    samples = np.asarray(want['SampleLabels'][0])
    num_true = ins['Label'][0].shape[1]
    assert samples.dtype == np.int32 and np.array_equal(
        samples[:, :num_true], ins['Label'][0])

    def port(t):
        cost, logits = tloss.nce_cost(
            t['Input'][0], t['Weight'][0], t['Bias'][0],
            torch.tensor(samples).long(), num_true,
            attrs['num_neg_samples'], attrs['num_total_classes'])
        return {'Cost': [cost], 'SampleLogits': [logits]}
    got, grads = _port_grads(port, ins, 'Cost', ct)
    for s in ('Cost', 'SampleLogits'):
        assert _gap(got[s][0].detach().numpy(), want[s][0]) <= TOL
    for a, b in zip(grads, want_grads):
        assert _gap(a.numpy(), b) <= TOL


def test_nce_draws_labels_then_uniform_negatives():
    op, ins, attrs = CASES['nce']
    rng = np.random.default_rng(4)
    n, classes, neg = 400, 20, 50
    ins = dict(ins, Input=[rng.standard_normal((n, 8)).astype(np.float32)],
               Label=[rng.integers(0, classes, (n, 1)).astype(np.int64)])
    attrs = dict(attrs, num_neg_samples=neg)
    got = _port(op, ins, attrs, _TorchCtx(5))
    samples = got['SampleLabels'][0].numpy()
    assert samples.shape == (n, 1 + neg) and samples.dtype == np.int32
    assert np.array_equal(samples[:, :1], ins['Label'][0])
    counts = np.bincount(samples[:, 1:].ravel(), minlength=classes)
    expect = n * neg / classes
    sigma = np.sqrt(n * neg * (1 / classes) * (1 - 1 / classes))
    assert len(counts) == classes and np.abs(counts - expect).max() <= \
        5 * sigma
    assert got['Cost'][0].shape == (n, 1)
    # another step's generator draws other negatives
    again = _port(op, ins, attrs, _TorchCtx(6))['SampleLabels'][0].numpy()
    assert not np.array_equal(again, samples)


def _window_start(x, y, lead):
    """The start of ``y`` as a window over the trailing dims of ``x``."""
    dims = y.shape[lead:]
    ranges = [range(xs - ys + 1) for xs, ys in zip(x.shape[lead:], dims)]
    for start in np.ndindex(*[len(r) for r in ranges]):
        sl = (slice(None),) * lead + tuple(
            slice(s, s + d) for s, d in zip(start, dims))
        if np.array_equal(x[sl], y):
            return start
    return None


@pytest.mark.parametrize('case', sorted(RANDOM_CASES))
def test_random_crop_is_a_uniform_window(case):
    op, ins, attrs = RANDOM_CASES[case]
    x = ins['X'][0]
    lead = x.ndim - len(attrs['shape'])
    want = np.asarray(_ref(op, ins, attrs, _JaxCtx(1))['Out'][0])
    assert _window_start(x, want, lead) is not None
    starts = []
    for step in range(400):
        y = _port(op, ins, attrs, _TorchCtx(step))['Out'][0].numpy()
        assert y.shape == want.shape and y.dtype == want.dtype
        start = _window_start(x, y, lead)
        assert start is not None
        starts.append(start)
    starts = np.asarray(starts)
    for d, (xs, ys) in enumerate(zip(x.shape[lead:], attrs['shape'])):
        counts = np.bincount(starts[:, d], minlength=xs - ys + 1)
        p = 1.0 / (xs - ys + 1)
        sigma = np.sqrt(400 * p * (1 - p))
        assert len(counts) == xs - ys + 1
        assert np.abs(counts - 400 * p).max() <= 5 * sigma, counts


def test_random_crop_gradient_is_its_window():
    op, ins, attrs = RANDOM_CASES['random_crop']
    x = torch.tensor(ins['X'][0], requires_grad=True)
    y = tget_op(op).compute(_TorchCtx(2), {'X': [x]}, dict(attrs))['Out'][0]
    y.sum().backward()
    start = _window_start(ins['X'][0], y.detach().numpy(), 2)
    mask = np.zeros_like(ins['X'][0])
    mask[:, :, start[0]:start[0] + 5, start[1]:start[1] + 4] = 1
    assert np.array_equal(x.grad.numpy(), mask)


WHITE_CASES = ['conv3d', 'conv2d_transpose', 'conv3d_transpose',
               'conv_shift', 'bilinear_tensor_product']


@pytest.mark.parametrize('case', WHITE_CASES)
def test_white_ops_run_bf16_and_return_it(case):
    op, ins, attrs = CASES[case]
    slot = GRAD_OUT.get(op, 'Out')
    full = _port(op, ins, attrs)[slot][0]
    low = tget_op(op).compute(None, {k: [torch.tensor(v).bfloat16()
                                         for v in vs]
                                     for k, vs in ins.items()},
                              dict(attrs))[slot][0]
    assert low.dtype == torch.bfloat16
    scale = full.abs().max()
    assert ((low.float() - full).abs().max() / scale) <= TOL_BF16


NEW_ACTIVATION_LAYERS = (
    'logsigmoid', 'tanh', 'tanh_shrink', 'softshrink', 'abs', 'round',
    'reciprocal', 'softplus', 'softsign', 'brelu', 'leaky_relu',
    'soft_relu', 'elu', 'relu6', 'stanh', 'hard_shrink',
    'thresholded_relu', 'hard_sigmoid', 'swish')


def _layers_program(pkg):
    """Every layer the slice brings, in one program; returns the fetched
    variables (nce's cost last)."""
    L = pkg.layers
    x = L.data(name='x', shape=[6], dtype='float32')
    y = L.data(name='y', shape=[5], dtype='float32')
    img = L.data(name='img', shape=[3, 6, 6], dtype='float32')
    vol = L.data(name='vol', shape=[2, 4, 5, 5], dtype='float32')
    ids = L.data(name='ids', shape=[1], dtype='int64')
    rois = L.data(name='rois', shape=[5], dtype='float32')
    loc = L.data(name='loc', shape=[12, 4], dtype='float32')
    conf = L.data(name='conf', shape=[12, 3], dtype='float32')
    prior = L.data(name='prior', shape=[8], dtype='float32')
    outs = [getattr(L, name)(x) for name in NEW_ACTIVATION_LAYERS]
    outs.append(L.leaky_relu(x, attrs={'alpha': 0.3}))
    outs += [L.conv3d(vol, num_filters=3, filter_size=2, padding=1,
                      act='relu'),
             L.pool3d(vol, pool_size=2, pool_type='avg', pool_stride=2),
             L.conv2d_transpose(img, num_filters=2, filter_size=3, stride=2),
             L.conv2d_transpose(img, num_filters=2, output_size=[13, 13],
                                stride=2),
             L.lrn(img, n=3),
             L.l2_normalize(x, axis=1),
             L.bilinear_tensor_product(x, y, size=4, act='tanh'),
             L.prelu(x, mode='all'), L.prelu(img, mode='channel'),
             L.prelu(img, mode='element'),
             L.multiplex([x, L.scale(x, scale=2.0), L.exp(x)],
                         L.cast(ids, 'int32')),
             L.roi_pool(img, rois, pooled_height=2, pooled_width=2),
             L.detection_output(loc, conf, prior, num_classes=3,
                                nms_top_k=6, keep_top_k=8)]
    outs += list(L.topk(x, 3))
    outs.append(L.argmax_like_topk(x))
    outs.append(L.ones(shape=[2, 3], dtype='float32'))
    holder = L.create_tensor(dtype='float32')
    L.assign(x, output=holder)
    outs.append(holder)
    outs.append(L.nce(x, ids, num_total_classes=7, num_neg_samples=3))
    return outs


def _layer_feed(rng, b=3):
    prior = np.concatenate([rng.uniform(0, 0.5, (12, 2)),
                            rng.uniform(0.5, 1.0, (12, 2)),
                            np.full((12, 4), 0.1)], axis=1)
    rois = np.stack([rng.integers(0, b, 4), rng.uniform(0, 2, 4),
                     rng.uniform(0, 2, 4), rng.uniform(2, 5, 4),
                     rng.uniform(2, 5, 4)], axis=1)
    return {'x': rng.standard_normal((b, 6)).astype(np.float32),
            'y': rng.standard_normal((b, 5)).astype(np.float32),
            'img': rng.standard_normal((b, 3, 6, 6)).astype(np.float32),
            'vol': rng.standard_normal((b, 2, 4, 5, 5)).astype(np.float32),
            'ids': rng.integers(0, 3, (b, 1)).astype(np.int64),
            'rois': rois.astype(np.float32),
            'loc': rng.standard_normal((b, 12, 4)).astype(np.float32),
            'conf': rng.standard_normal((b, 12, 3)).astype(np.float32),
            'prior': prior.astype(np.float32)}


def test_layers_build_and_run_as_the_reference():
    built = []
    for pkg, pm in ((fluid, jprog), (tfl, tprog)):
        with pm.reset_unique_name_guard():
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup):
                fetch = _layers_program(pkg)
        built.append((main, startup, [v.name for v in fetch]))
    (jm, js, names), (tm, ts, tnames) = built
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    assert names == tnames
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy(
        {v.name: np.asarray(jscope.get(v.name)) for v in jm.list_vars()
         if v.persistable and jscope.has(v.name)}, 'cpu')
    feed = _layer_feed(np.random.default_rng(7))
    want = jexe.run(jm, feed=feed, fetch_list=names, scope=jscope)
    got = tfl.Executor(tfl.CPUPlace()).run(tm, feed=feed, fetch_list=names,
                                           scope=tscope)
    for name, a, b in zip(names[:-1], got[:-1], want[:-1]):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _gap(a, b) <= TOL, (name, _gap(a, b))
    assert got[-1].shape == (3, 1) and np.isfinite(got[-1]).all()


def test_box_helpers_match_the_reference():
    """``decode_box``, ``iou_matrix`` and ``nms_mask`` (the single-image
    NMS the detection op runs batched) against the reference's
    paddle_tpu/ops/detection.py helpers."""
    from paddle_tpu.ops import detection as jdet
    from paddle_tpu_torch.ops import detection as tdet
    ins = CASES['detection_output'][1]
    prior, loc = ins['PriorBox'][0], ins['Loc'][0][0]
    boxes = jdet.decode_box(jnp.asarray(prior), jnp.asarray(loc))
    tboxes = tdet.decode_box(torch.tensor(prior), torch.tensor(loc))
    assert _gap(tboxes.numpy(), boxes) <= TOL
    assert _gap(tdet.iou_matrix(tboxes).numpy(),
                jdet.iou_matrix(boxes)) <= TOL
    scores = np.random.default_rng(2).random(len(prior)).astype(np.float32)
    for thr, keep in ((0.3, 10), (0.6, 24), (0.0, 3)):
        want = jdet.nms_mask(boxes, jnp.asarray(scores), thr, 0.2, keep)
        got = tdet.nms_mask(tboxes, torch.tensor(scores), thr, 0.2, keep)
        assert np.array_equal(got.numpy(), np.asarray(want)), thr

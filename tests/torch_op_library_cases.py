"""The seeded numpy inputs of the dense op library's tests
(tests/test_torch_op_library.py, test_torch_detection.py), shared with
``chip_smoke.py``'s op-library sweep, which runs the same cases on the
card.  numpy only: no JAX, no torch.

``CASES`` is {name: (op type, {slot: [arrays]}, attrs)}; int arrays are
int64, as a feeder makes them (both executors narrow them to int32).
Inputs sit on every bound and tie the ops' gradients treat specially:
the clips' bounds (brelu, relu6, hard_sigmoid, soft_relu, clip), the
hinges of hinge_loss and margin_rank_loss, 0 for abs and l1_norm, the
where-conditions' edges (leaky_relu, elu, softshrink, hard_shrink,
thresholded_relu, the losses' branch points), halves for round, and tied
maxima for maxout.  ``GRAD_OUT`` names the output each differentiable
op's gradient is taken of.
"""
import numpy as np

__all__ = ['CASES', 'GRAD_OUT', 'NO_GRAD', 'NEW_OPS', 'RANDOM_CASES',
           'ssd300_case', 'ssd300_priors', 'detection_case', 'roi_case']

# the op types this slice brings, and the repaired clip
NEW_OPS = (
    'logsigmoid', 'tanh_shrink', 'abs', 'round', 'reciprocal', 'softplus',
    'softsign', 'softshrink', 'hard_shrink', 'brelu', 'leaky_relu',
    'soft_relu', 'elu', 'relu6', 'stanh', 'thresholded_relu',
    'hard_sigmoid', 'swish', 'prelu',
    'smooth_l1', 'smooth_l1_loss', 'hinge_loss', 'huber_loss', 'log_loss',
    'rank_loss', 'margin_rank_loss', 'modified_huber_loss', 'nce',
    'elementwise_mod', 'minus', 'l1_norm', 'squared_l2_norm',
    'squared_l2_distance', 'norm', 'maxout', 'bilinear_tensor_product',
    'crop', 'fill', 'gather', 'scatter', 'multiplex', 'sign_of',
    'conv3d', 'conv2d_transpose', 'conv3d_transpose', 'conv_shift',
    'pool3d', 'max_pool2d_with_index', 'unpool', 'spp',
    'lrn', 'roi_pool', 'detection_output', 'random_crop')


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _with(x, *values):
    """x (flattened) with its first entries set to ``values``."""
    x = x.copy().reshape(-1)
    x[:len(values)] = values
    return x


def _act(seed, *edges, shape=(3, 8)):
    x = _with(_f32(_rng(seed), *shape, scale=2.0), *edges)
    return {'X': [x.reshape(shape)]}


def _activation_cases():
    c = {
        'logsigmoid': ('logsigmoid', _act(1, 0.0, 30.0, -30.0), {}),
        'tanh_shrink': ('tanh_shrink', _act(2, 0.0), {}),
        'abs': ('abs', _act(3, 0.0, -0.0, 1.0, -1.0), {}),
        'round': ('round', _act(4, 0.5, 1.5, 2.5, -0.5, -1.5, 0.49), {}),
        'reciprocal': ('reciprocal', {'X': [_with(
            _f32(_rng(5), 3, 8) + 3.0, 0.5, -2.0).reshape(3, 8)]}, {}),
        'softplus': ('softplus', _act(6, 0.0, 25.0, -25.0, 50.0), {}),
        'softsign': ('softsign', _act(7, 0.0), {}),
        'softshrink': ('softshrink', _act(8, 0.5, -0.5, 0.0), {}),
        'softshrink_lambda': ('softshrink', _act(9, 0.3, -0.3),
                              {'lambda': 0.3}),
        'hard_shrink': ('hard_shrink', _act(10, 0.5, -0.5, 0.0), {}),
        'brelu': ('brelu', _act(11, 0.0, 24.0, 30.0, -1.0), {}),
        'brelu_bounds': ('brelu', _act(12, 1.0, -1.0, 0.0),
                         {'t_min': -1.0, 't_max': 1.0}),
        'leaky_relu': ('leaky_relu', _act(13, 0.0, -0.0), {'alpha': 0.1}),
        'soft_relu': ('soft_relu', _act(14, 2.0, -2.0, 0.0),
                      {'threshold': 2.0}),
        'soft_relu_default': ('soft_relu', _act(15, 0.0), {}),
        'elu': ('elu', _act(16, 0.0, -0.0), {'alpha': 1.5}),
        'relu6': ('relu6', _act(17, 0.0, 6.0, 7.0), {}),
        'relu6_threshold': ('relu6', _act(18, 0.0, 2.0), {'threshold': 2.0}),
        'stanh': ('stanh', _act(19, 0.0), {'scale_a': 0.5, 'scale_b': 2.0}),
        'thresholded_relu': ('thresholded_relu', _act(20, 1.0, 0.5),
                             {'threshold': 0.5}),
        'hard_sigmoid': ('hard_sigmoid', _act(21, 2.0, -2.0, 0.0),
                         {'slope': 0.25, 'offset': 0.5}),
        'hard_sigmoid_default': ('hard_sigmoid', _act(22, 0.0), {}),
        'swish': ('swish', _act(23, 0.0), {'beta': 1.5}),
        'clip': ('clip', _act(24, -1.0, 1.0, 0.0, 2.0, -2.0),
                 {'min': -1.0, 'max': 1.0}),
    }
    rng = _rng(25)
    x = _with(_f32(rng, 2, 3, 4, 4), 0.0, -0.0).reshape(2, 3, 4, 4)
    c['prelu_all'] = ('prelu', {'X': [x], 'Alpha': [np.asarray(
        [0.25], np.float32)]}, {'mode': 'all'})
    c['prelu_channel'] = ('prelu', {'X': [x], 'Alpha': [_f32(
        rng, 1, 3, 1, 1)]}, {'mode': 'channel'})
    c['prelu_element'] = ('prelu', {'X': [x], 'Alpha': [_f32(
        rng, 1, 3, 4, 4)]}, {'mode': 'element'})
    return c


def _loss_cases():
    rng = _rng(30)
    c = {}
    x, y = _f32(rng, 4, 6), _f32(rng, 4, 6)
    # |x - y| exactly at 1 / sigma^2 (sigma 1: 1; sigma 2: 0.25) and 0
    x[0, :3] = y[0, :3] + np.asarray([1.0, 0.0, -1.0], np.float32)
    x[1, :2] = y[1, :2] + np.asarray([0.25, -0.25], np.float32)
    c['smooth_l1'] = ('smooth_l1', {'X': [x], 'Y': [y]}, {})
    c['smooth_l1_loss_weights'] = ('smooth_l1_loss', {
        'X': [x], 'Y': [y], 'InsideWeight': [np.abs(_f32(rng, 4, 6))],
        'OutsideWeight': [np.abs(_f32(rng, 4, 6))]}, {'sigma': 2.0})
    logits = _with(_f32(rng, 8, 1), 1.0, -1.0, 1.0, -1.0, 0.0).reshape(8, 1)
    labels = _with(rng.integers(0, 2, (8, 1)).astype(np.float32),
                   1.0, 0.0, 0.0, 1.0).reshape(8, 1)
    c['hinge_loss'] = ('hinge_loss', {'Logits': [logits],
                                      'Labels': [labels]}, {})
    hx, hy = _f32(rng, 6, 1), _f32(rng, 6, 1)
    hy[:3, 0] = hx[:3, 0] + np.asarray([0.5, -0.5, 0.0], np.float32)
    c['huber_loss'] = ('huber_loss', {'X': [hx], 'Y': [hy]},
                       {'delta': 0.5})
    p = rng.uniform(0.05, 0.95, (6, 1)).astype(np.float32)
    c['log_loss'] = ('log_loss', {'Predicted': [p], 'Labels': [
        rng.integers(0, 2, (6, 1)).astype(np.float32)]}, {'epsilon': 1e-4})
    c['rank_loss'] = ('rank_loss', {
        'Label': [rng.integers(0, 2, (6, 1)).astype(np.float32)],
        'Left': [_f32(rng, 6, 1)], 'Right': [_f32(rng, 6, 1)]}, {})
    x1, x2 = _f32(rng, 6, 1), _f32(rng, 6, 1)
    lab = np.where(rng.random((6, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
    # -label * (x1 - x2) + margin == 0 on the first two rows
    x1[:2, 0] = x2[:2, 0] + lab[:2, 0] * 0.1
    c['margin_rank_loss'] = ('margin_rank_loss', {
        'Label': [lab], 'X1': [x1], 'X2': [x2]}, {'margin': 0.1})
    mx = _with(_f32(rng, 8, 1), 1.0, -1.0, 0.5, -2.0, 1.0).reshape(8, 1)
    my = _with(rng.integers(0, 2, (8, 1)).astype(np.float32),
               1.0, 1.0, 1.0, 1.0, 0.0).reshape(8, 1)
    c['modified_huber_loss'] = ('modified_huber_loss',
                                {'X': [mx], 'Y': [my]}, {})
    for name, label in (('nce', rng.integers(0, 20, (5, 1))),
                        ('nce_two_true', rng.integers(0, 20, (5, 2)))):
        c[name] = ('nce', {
            'Input': [_f32(rng, 5, 8)], 'Label': [label.astype(np.int64)],
            'Weight': [_f32(rng, 20, 8, scale=0.5)],
            'Bias': [_f32(rng, 20, scale=0.1)]},
            {'num_total_classes': 20, 'num_neg_samples': 6})
    return c


def _math_cases():
    rng = _rng(40)
    c = {}
    x = _f32(rng, 3, 4, 5, scale=4.0)
    x.reshape(-1)[:4] = [-3.0, 3.0, 0.0, -7.5]
    y = np.where(rng.random((4, 5)) < 0.5, -1.0, 1.0).astype(
        np.float32) * rng.uniform(0.5, 2.0, (4, 5)).astype(np.float32)
    c['elementwise_mod'] = ('elementwise_mod', {'X': [x], 'Y': [y]}, {})
    c['elementwise_mod_axis'] = ('elementwise_mod', {
        'X': [x], 'Y': [np.asarray([1.5, -2.0, 0.75, 3.0], np.float32)]},
        {'axis': 1})
    c['elementwise_mod_int'] = ('elementwise_mod', {
        'X': [rng.integers(-9, 9, (3, 4)).astype(np.int64)],
        'Y': [np.asarray([2, -3, 4, 5], np.int64)]}, {})
    c['minus'] = ('minus', {'X': [_f32(rng, 3, 4)],
                            'Y': [_f32(rng, 3, 4)]}, {})
    c['l1_norm'] = ('l1_norm', {'X': [_with(
        _f32(rng, 3, 4), 0.0, 0.0, -0.0).reshape(3, 4)]}, {})
    c['squared_l2_norm'] = ('squared_l2_norm', {'X': [_f32(rng, 3, 4)]}, {})
    c['squared_l2_distance'] = ('squared_l2_distance', {
        'X': [_f32(rng, 4, 3, 2)], 'Y': [_f32(rng, 4, 3, 2)]}, {})
    c['squared_l2_distance_row'] = ('squared_l2_distance', {
        'X': [_f32(rng, 4, 6)], 'Y': [_f32(rng, 1, 6)]}, {})
    c['norm'] = ('norm', {'X': [_f32(rng, 2, 3, 4)]}, {'axis': 1})
    c['norm_last'] = ('norm', {'X': [_f32(rng, 3, 5)]},
                      {'axis': -1, 'epsilon': 1e-6})
    mx = np.round(_f32(rng, 2, 6, 3, 3)).astype(np.float32)   # ties
    c['maxout'] = ('maxout', {'X': [mx]}, {'groups': 3})
    c['maxout_2'] = ('maxout', {'X': [_f32(rng, 2, 4, 3, 3)]}, {'groups': 2})
    c['bilinear_tensor_product'] = ('bilinear_tensor_product', {
        'X': [_f32(rng, 4, 3)], 'Y': [_f32(rng, 4, 5)],
        'Weight': [_f32(rng, 6, 3, 5)], 'Bias': [_f32(rng, 1, 6)]}, {})
    c['bilinear_tensor_product_nobias'] = ('bilinear_tensor_product', {
        'X': [_f32(rng, 4, 3)], 'Y': [_f32(rng, 4, 5)],
        'Weight': [_f32(rng, 2, 3, 5)]}, {})
    return c


def _tensor_cases():
    rng = _rng(50)
    c = {}
    x = _f32(rng, 5, 6, 4)
    c['crop'] = ('crop', {'X': [x]}, {'offsets': [1, 2, 0],
                                      'shape': [3, 2, 4]})
    c['crop_leading'] = ('crop', {'X': [x]}, {'offsets': [2],
                                              'shape': [2]})
    c['fill_float'] = ('fill', {}, {'value': list(np.arange(6) * 0.5),
                                    'shape': [2, 3], 'dtype': 'float32'})
    c['fill_int64'] = ('fill', {}, {'value': [3, -1, 7, 9], 'shape': [4, 1],
                                    'dtype': 'int64'})
    c['gather'] = ('gather', {'X': [x], 'Index': [np.asarray(
        [4, 0, 2, 2], np.int64)]}, {})
    c['scatter'] = ('scatter', {'X': [x], 'Ids': [np.asarray(
        [3, 0, 1], np.int64)], 'Updates': [_f32(rng, 3, 6, 4)]}, {})
    c['multiplex'] = ('multiplex', {
        'X': [_f32(rng, 4, 3), _f32(rng, 4, 3), _f32(rng, 4, 3)],
        'Ids': [np.asarray([[2], [0], [1], [2]], np.int64)]}, {})
    c['sign_of'] = ('sign_of', {'X': [_with(_f32(rng, 3, 4), 0.0, -0.0)
                                      .reshape(3, 4)]}, {})
    return c


def _conv_cases():
    rng = _rng(60)
    c = {}
    c['conv3d'] = ('conv3d', {'Input': [_f32(rng, 2, 3, 5, 6, 6)],
                              'Filter': [_f32(rng, 4, 3, 3, 3, 3)]},
                   {'strides': [1, 2, 1], 'paddings': [1, 0, 1]})
    c['conv3d_groups'] = ('conv3d', {'Input': [_f32(rng, 1, 4, 4, 4, 4)],
                                     'Filter': [_f32(rng, 6, 2, 2, 2, 2)]},
                          {'groups': 2, 'dilations': [1, 1, 2]})
    c['conv2d_transpose'] = ('conv2d_transpose', {
        'Input': [_f32(rng, 2, 3, 5, 4)], 'Filter': [_f32(rng, 3, 4, 3, 3)]},
        {'strides': [2, 1], 'paddings': [1, 0]})
    c['conv2d_transpose_dilated'] = ('conv2d_transpose', {
        'Input': [_f32(rng, 1, 2, 4, 4)], 'Filter': [_f32(rng, 2, 3, 2, 3)]},
        {'strides': [1, 2], 'paddings': [0, 1], 'dilations': [2, 1]})
    c['conv3d_transpose'] = ('conv3d_transpose', {
        'Input': [_f32(rng, 1, 2, 3, 4, 3)],
        'Filter': [_f32(rng, 2, 3, 2, 3, 2)]},
        {'strides': [2, 1, 2], 'paddings': [0, 1, 0]})
    c['conv_shift'] = ('conv_shift', {'X': [_f32(rng, 3, 7)],
                                      'Y': [_f32(rng, 3, 3)]}, {})
    c['conv_shift_wide'] = ('conv_shift', {'X': [_f32(rng, 2, 5)],
                                           'Y': [_f32(rng, 2, 5)]}, {})
    return c


def _pool_cases():
    rng = _rng(70)
    c = {}
    x3 = _f32(rng, 2, 3, 5, 6, 6)
    c['pool3d_max'] = ('pool3d', {'X': [x3]}, {
        'pooling_type': 'max', 'ksize': [2, 3, 3], 'strides': [2, 2, 1],
        'paddings': [1, 1, 0]})
    c['pool3d_avg'] = ('pool3d', {'X': [x3]}, {
        'pooling_type': 'avg', 'ksize': [3, 2, 2], 'strides': [1, 2, 2],
        'paddings': [1, 1, 1]})
    c['pool3d_global'] = ('pool3d', {'X': [x3]}, {
        'pooling_type': 'avg', 'ksize': [1, 1, 1], 'global_pooling': True})
    c['pool3d_wide_pad'] = ('pool3d', {'X': [x3]}, {
        'pooling_type': 'max', 'ksize': [2, 2, 2], 'strides': [2, 2, 2],
        'paddings': [1, 1, 1]})
    x = _f32(rng, 2, 3, 7, 6)
    c['max_pool2d_with_index'] = ('max_pool2d_with_index', {'X': [x]},
                                  {'ksize': [2, 2], 'strides': [2, 2]})
    c['max_pool2d_with_index_pad'] = ('max_pool2d_with_index', {'X': [x]},
                                      {'ksize': [3, 3], 'strides': [2, 2],
                                       'paddings': [1, 1]})
    c['max_pool2d_with_index_global'] = ('max_pool2d_with_index',
                                         {'X': [x]}, {'global_pooling': True})
    # indices of a 2x2 / 2 max pool of a 6x6 plane, and repeated ones
    idx = np.stack([np.arange(0, 36, 4)[:9]] * 6).reshape(2, 3, 3, 3)
    idx[0, 0, 0, :2] = 7
    c['unpool'] = ('unpool', {'X': [_f32(rng, 2, 3, 3, 3)],
                              'Indices': [idx.astype(np.int64)]},
                   {'unpooled_height': 6, 'unpooled_width': 6})
    c['spp_max'] = ('spp', {'X': [_f32(rng, 2, 3, 5, 7)]},
                    {'pyramid_height': 3, 'pooling_type': 'max'})
    c['spp_avg'] = ('spp', {'X': [_f32(rng, 2, 2, 8, 8)]},
                    {'pyramid_height': 2, 'pooling_type': 'avg'})
    return c


def _earlier_cases():
    """Ops of earlier slices that no op-level parity test named:
    elementwise_{sub,mul,div,pow,max,min} (with ties for max and min),
    the reductions max, min, mean and prod (ties for max and min), pad,
    transpose and sigmoid_cross_entropy_with_logits (x = 0, where the
    maximum ties and |x| has slope 1)."""
    rng = _rng(100)
    c = {}
    x = np.round(_f32(rng, 3, 4, 2))
    y = np.round(_f32(rng, 4))
    for op in ('elementwise_sub', 'elementwise_mul', 'elementwise_max',
               'elementwise_min'):
        c[op] = (op, {'X': [x], 'Y': [y]}, {'axis': 1})
    pos = np.abs(_f32(rng, 3, 4)) + 0.5
    c['elementwise_div'] = ('elementwise_div', {'X': [_f32(rng, 3, 4)],
                                                'Y': [pos]}, {})
    c['elementwise_pow'] = ('elementwise_pow', {'X': [pos],
                                                'Y': [_f32(rng, 3, 4)]}, {})
    r = np.round(_f32(rng, 3, 4, 5))
    for op, attrs in (('reduce_max', {'dim': [1, 2]}),
                      ('reduce_min', {'dim': 1}),
                      ('reduce_mean', {'dim': -1, 'keep_dim': True}),
                      ('reduce_prod', {'dim': 0})):
        c[op] = (op, {'X': [r if op in ('reduce_max', 'reduce_min')
                            else _f32(rng, 3, 4, 5)]}, attrs)
    c['pad'] = ('pad', {'X': [_f32(rng, 2, 3)]},
                {'paddings': [1, 0, 2, 1], 'pad_value': 0.5})
    c['transpose'] = ('transpose', {'X': [_f32(rng, 2, 3, 4)]},
                      {'axis': [2, 0, 1]})
    c['sigmoid_cross_entropy_with_logits'] = (
        'sigmoid_cross_entropy_with_logits',
        {'X': [_with(_f32(rng, 3, 4), 0.0, 0.0).reshape(3, 4)],
         'Label': [rng.random((3, 4)).astype(np.float32)]}, {})
    return c


def roi_case(seed=80, n=2, c=3, h=9, w=11):
    """X [2, 3, 9, 11] and rois covering a whole image, malformed
    (x2 < x1), past the edge, one cell, and halves that round up."""
    rng = _rng(seed)
    rois = np.asarray([
        [0, 0, 0, w - 1, h - 1],
        [1, 2.5, 1.5, 7.4, 6.6],
        [0, 6, 5, 3, 2],            # malformed: one cell
        [1, 8, 6, 20, 15],          # past the edge
        [0, 4, 4, 4, 4],            # one cell
        [1, 0.5, 0.49, 5.5, 3.5],
    ], np.float32)
    return {'X': [_f32(rng, n, c, h, w)], 'ROIs': [rois]}


def detection_case(seed=90, n=2, p=24, classes=4):
    """Loc [N, P, 4], Conf [N, P, C] and PriorBox [P, 8]: priors on a grid
    with overlaps, class logits scaled so the NMS keeps some and
    suppresses others."""
    rng = _rng(seed)
    cx = rng.uniform(0.1, 0.9, p)
    cy = rng.uniform(0.1, 0.9, p)
    s = rng.uniform(0.1, 0.4, p)
    prior = np.stack([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2,
                      np.full(p, 0.1), np.full(p, 0.1), np.full(p, 0.2),
                      np.full(p, 0.2)], axis=1).astype(np.float32)
    return {'Loc': [_f32(rng, n, p, 4)],
            'Conf': [_f32(rng, n, p, classes, scale=3.0)],
            'PriorBox': [prior]}


def ssd300_priors():
    """SSD300's 8732 prior boxes [8732, 8] (Liu et al. 2016, the VOC
    model): feature maps 38, 19, 10, 5, 3, 1; box sizes 30-315 of 300;
    aspect ratios 2 (and 3 on the middle four maps), each cell a box at
    the min size, one at sqrt(min * max), and one pair a ratio; clipped
    to the image; variances 0.1, 0.1, 0.2, 0.2."""
    maps = (38, 19, 10, 5, 3, 1)
    sizes = (30, 60, 111, 162, 213, 264, 315)
    ratios = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
    boxes = []
    for k, m in enumerate(maps):
        lo, hi = sizes[k] / 300.0, sizes[k + 1] / 300.0
        shapes = [(lo, lo), (np.sqrt(lo * hi),) * 2]
        for r in ratios[k]:
            shapes += [(lo * np.sqrt(r), lo / np.sqrt(r)),
                       (lo / np.sqrt(r), lo * np.sqrt(r))]
        for i in range(m):
            for j in range(m):
                cx, cy = (j + 0.5) / m, (i + 0.5) / m
                for w, h in shapes:
                    boxes.append([cx - w / 2, cy - h / 2,
                                  cx + w / 2, cy + h / 2])
    boxes = np.clip(np.asarray(boxes), 0.0, 1.0)
    var = np.tile([0.1, 0.1, 0.2, 0.2], (len(boxes), 1))
    return np.concatenate([boxes, var], axis=1).astype(np.float32)


def ssd300_case(seed=91, n=8):
    """SSD300 on VOC's shape: its 8732 priors, 21 classes, batch ``n``.
    The class logits lie on a lattice of 0.25 and the size offsets are 0,
    so that no two scores or IoUs the NMS compares sit within float32
    rounding of each other or of a threshold: a card and a CPU, whose
    exp and softmax round differently, then make the same choices."""
    rng = _rng(seed)
    prior = ssd300_priors()
    loc = _f32(rng, n, len(prior), 4, scale=0.5)
    loc[..., 2:] = 0.0
    conf = np.round(_f32(rng, n, len(prior), 21, scale=2.0) * 4) / 4
    return {'Loc': [loc], 'Conf': [conf.astype(np.float32)],
            'PriorBox': [prior]}


def _detection_cases():
    return {
        'roi_pool': ('roi_pool', roi_case(), {
            'pooled_height': 3, 'pooled_width': 2, 'spatial_scale': 1.0}),
        'roi_pool_scaled': ('roi_pool', roi_case(81, h=6, w=7), {
            'pooled_height': 2, 'pooled_width': 4, 'spatial_scale': 0.5}),
        'lrn': ('lrn', {'X': [_f32(_rng(82), 2, 7, 3, 4)]}, {}),
        'lrn_attrs': ('lrn', {'X': [_f32(_rng(83), 2, 4, 3, 3)]}, {
            'n': 3, 'k': 1.0, 'alpha': 0.01, 'beta': 0.5}),
        'detection_output': ('detection_output', detection_case(), {
            'num_classes': 4, 'nms_threshold': 0.3,
            'confidence_threshold': 0.05, 'nms_top_k': 10,
            'keep_top_k': 12}),
        'detection_output_short': ('detection_output', detection_case(
            92, 1, 5, 3), {'num_classes': 3, 'background_label_id': 2,
                           'keep_top_k': 20}),
    }


# the random ops: checked by distribution and by their outputs' relation
# to the inputs, and nce's cost given the reference's samples
RANDOM_CASES = {
    'random_crop': ('random_crop', {'X': [_f32(_rng(95), 2, 3, 8, 9)]},
                    {'shape': [5, 4]}),
    'random_crop_1d': ('random_crop', {'X': [_f32(_rng(96), 4, 10)]},
                       {'shape': [3]}),
}

CASES = {}
for _group in (_activation_cases, _loss_cases, _math_cases, _tensor_cases,
               _conv_cases, _pool_cases, _detection_cases, _earlier_cases):
    CASES.update(_group())

# output slot whose gradient each differentiable op's test takes
GRAD_OUT = {'smooth_l1': 'Out', 'smooth_l1_loss': 'Out', 'hinge_loss': 'Loss',
            'huber_loss': 'Out', 'log_loss': 'Loss', 'margin_rank_loss': 'Out',
            'modified_huber_loss': 'Out', 'nce': 'Cost', 'conv3d': 'Output',
            'conv2d_transpose': 'Output', 'conv3d_transpose': 'Output'}
# ops with no gradient to compare: rounding, sign, constants, and the
# ops the reference cannot differentiate (max_pool2d_with_index's
# reduce_window of (value, index) pairs) or sorts (detection_output)
NO_GRAD = ('round', 'sign_of', 'fill', 'detection_output',
           'max_pool2d_with_index')

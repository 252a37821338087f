"""Fused LSTM time loop, forward and backward through time: hand-written
Hopper kernels and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/lstm_cell.py: the forward (``_lstm_kernel``,
``_lstm_forward``) and the BPTT backward (``_lstm_bwd_kernel``,
``_lstm_backward``), joined by a ``torch.autograd.Function`` as the
reference joins them by ``jax.custom_vjp`` (``_lstm_scan_core``), plus
``lstm_scan``.  The kernels are CUDA C++ in
``paddle_tpu_torch/csrc/lstm_fwd.cu`` and ``lstm_bwd.cu``, compiled for
``sm_90a`` at first use (ops/kernels/build.py) and called through ctypes on
the tensors' current stream.  Their designs and what bounds them are noted
in those sources.  The forward is the PyTorch operator
``paddle_tpu_torch::lstm_fwd`` (``lstm_fwd``), which ``lstm_scan`` and
``_LSTMScan`` call, so that ``torch.export`` records it and an exported
artifact launches it; the backward, reached only in training, stays a
direct ctypes launch, which the kernel loader refuses under tracing.

The recurrence, time-major: x [T, B, 4H] holds the pre-projected gate
inputs (bias added), w [H, 4H] the recurrent weight, pw [3, H] the
peephole weights (w_ic, w_fc, w_oc; zeros without peepholes); the state
starts at zero; gate order (i, f, cand, o).

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernels (a failed build or launch raises, as does a shape the kernels
do not take), CPU tensors take the plain versions ``_plain_lstm_forward``
and ``_plain_lstm_backward``, eager loops over T that restate the
reference's ``_scan_reference`` and its BPTT math.  They are what the CPU
tests and ``chip_smoke.py`` hold the kernels against.  The reference's
VMEM fit test and batch tiling (``pick_batch_tile``) are not ported.  Both
kernels walk T on one of two paths, by one rule on the width alone
(``fwd_path``, ``bwd_path``, ``cluster_size``; decided without a build,
as ``kernel_takes`` is): up to 416 units a persistent thread-block
cluster of ceil(H / 32) blocks keeps W in shared memory, split by hidden
units, and computes its products on the tensor cores (csrc/gru_cluster.cuh,
the GRU kernels' engine: W's columns for the forward's h W, its rows for
the backward's dh chain, whose dW then runs on the tensor cores too);
wider ones take the row-tiled kernels, which tile the batch by 8 rows a
block and keep one tile's state in shared memory, which caps the hidden
width (``max_hidden``; the LM runs 256 units, the sentiment net 128).  The
kernels read h as float4, so
``lstm_scan`` pads another width with zero units up to a multiple of 4
(a zero unit stays zero and feeds nothing) and slices them off again;
``kernel_takes`` says whether the padded width fits both caps.  A width
past them raises on a CUDA tensor, and the ``lstm`` op (ops/rnn.py)
sends it to its eager scan instead, as the reference sends a shape its
VMEM cannot hold to ``lax.scan``.  Float32 only: bfloat16 inputs come
with the AMP slice.
"""
import ctypes

import torch

__all__ = ['lstm_scan', 'lstm_fwd', 'launches', 'fwd_cluster_launches', 'bwd_launches',
           'bwd_cluster_launches', 'ROWS_PER_BLOCK', 'max_hidden',
           'kernel_takes', 'cluster_size', 'fwd_path', 'bwd_path',
           'fwd_plan', 'bwd_plan']

# kernel launches in this process (plain-version calls excluded); one
# backward launch is the call that runs its chain, the dW tiles and their
# finish
launches = 0              # forward (#7), both paths
fwd_cluster_launches = 0  # forward on the cluster path
bwd_launches = 0          # backward (#8), both paths
bwd_cluster_launches = 0  # backward on the cluster path

# batch rows per block of both kernels' wide paths
ROWS_PER_BLOCK = 8

# The kernels' hidden-width caps, as the built libraries report them
# (``paddle_<name>_max_hidden``): a block's 232448 bytes of shared memory
# over the floats one tile of ``rows`` batch rows of the wide path keeps
# there per hidden unit, 6 * rows for the forward (h, c, the gate
# pre-activations) and 6 * rows + 3 for the backward (the carry, one
# step's dx, the dpw sums).  chip_smoke.py holds them against the
# libraries.
_SMEM = 232448
_FLOATS_PER_UNIT = {'lstm_fwd': lambda rows: 6 * rows,
                    'lstm_bwd': lambda rows: 6 * rows + 3}


def max_hidden(name, rows=ROWS_PER_BLOCK):
    """The largest hidden width kernel ``name`` takes at ``rows`` batch
    rows per block (8 only); 0 at another row count."""
    if rows != ROWS_PER_BLOCK:
        return 0
    return _SMEM // (_FLOATS_PER_UNIT[name](rows) * 4)


def padded_width(h):
    """h rounded up to a multiple of 4, the width the kernels run."""
    return -(-h // 4) * 4


def pad_units(v, groups, p, rows=0):
    """v [..., groups * H] with p zero units after each group's H, and
    ``rows`` zero rows after the first dim's H (the recurrent weight)."""
    v = v.reshape(v.shape[:-1] + (groups, v.shape[-1] // groups))
    pad = [0, p] + [0, 0] * (v.dim() - 2) + ([0, rows] if rows else [])
    v = torch.nn.functional.pad(v, pad)
    return v.reshape(v.shape[:-2] + (-1,))


def kernel_takes(h):
    """Whether both kernels take hidden width ``h`` at ROWS_PER_BLOCK
    batch rows per block once ``lstm_scan`` has padded it to a multiple of
    4; decided without a build."""
    return 1 <= h and padded_width(h) <= min(
        max_hidden(n) for n in _FLOATS_PER_UNIT)


# the cluster engine of the recurrent kernels (csrc/gru_cluster.cuh): 32
# hidden units a block
CLUSTER_UNITS = 32
# #7's and #8's cluster chains: as many blocks as W's 32 units a block (all
# four gate parts) and two h or dx slice buffers (with the forward's four
# gate regions) leave room for in a block's 232448 bytes of shared memory:
# 13, so widths up to 416 (csrc/lstm_fwd.cu and lstm_bwd.cu
# kChainMaxBlocks); chip_smoke.py holds the rule against both libraries'
MAX_CLUSTER_BLOCKS = 13


def cluster_blocks(h, max_blocks):
    """Blocks of the cluster engine's chain at hidden width ``h`` (a
    multiple of 4) with at most ``max_blocks`` blocks: ceil(h / 32), or 0
    past 32 * max_blocks units (the wide path); csrc/gru_cluster.cuh
    cluster_blocks."""
    if 1 <= h <= CLUSTER_UNITS * max_blocks:
        return -(-h // CLUSTER_UNITS)
    return 0


def cluster_size(h):
    """Blocks of the cluster whose chain #7 and #8 run at hidden width
    ``h``: ceil(h / 32) up to 416 units, 0 past them (the wide path).
    Decided by the width alone, without a build."""
    return cluster_blocks(h, MAX_CLUSTER_BLOCKS)


def bwd_path(h):
    """#8's chain at hidden width ``h``: 'cluster' (W resident in a
    cluster's shared memory) or 'wide' (the row-tiled chain)."""
    return 'cluster' if cluster_size(h) else 'wide'


def fwd_path(h):
    """#7's time loop at hidden width ``h``, by #8's rule: 'cluster' (W's
    columns resident in a cluster's shared memory) or 'wide' (the
    row-tiled loop)."""
    return bwd_path(h)


def _plan(name, keys, t, b, h):
    lib = _lib(name)
    out = (ctypes.c_int * len(keys))()
    _launch_check(lib, getattr(lib, 'paddle_%s_plan' % name)(
        t, b, h, ctypes.cast(out, ctypes.c_void_p)), '%s plan' % name)
    return dict(zip(keys, list(out)), path=bwd_path(h))


_CHAIN_PLAN = ('cluster_size', 'rows_per_cluster', 'active_clusters',
               'clusters')


def fwd_plan(t, b, h):
    """#7's launch for (T, B, H) on the current card, as the library plans
    it: its cluster size (0 on the wide path), batch rows per cluster, the
    clusters of that size the card runs at once, the clusters launched.
    Builds the library."""
    return _plan('lstm_fwd', _CHAIN_PLAN, t, b, h)


def bwd_plan(t, b, h):
    """#8's launch for (T, B, H) on the current card, as the library plans
    it: #7's keys, then dW's row ranges and blocks.  Builds the
    library."""
    return _plan('lstm_bwd', _CHAIN_PLAN + ('dw_splits', 'dw_blocks'), t, b,
                 h)


def _check_width(name, h):
    if h % 4 or not 1 <= h <= max_hidden(name):
        raise ValueError("the %s kernel takes hidden widths that are "
                         "multiples of 4 up to %d, not %d"
                         % (name, max_hidden(name), h))


def _lib(name):
    from . import build
    lib = build.load(name)
    fn = getattr(lib, 'paddle_' + name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (7 if name == 'lstm_fwd' else 11) + [i, i, i, p]
        fn.restype = ctypes.c_int
        ws = getattr(lib, 'paddle_%s_workspace_bytes' % name)
        ws.argtypes, ws.restype = [i, i, i], ctypes.c_int64
        rule = getattr(lib, 'paddle_%s_cluster_size' % name)
        rule.argtypes, rule.restype = [i], i
        plan = getattr(lib, 'paddle_%s_plan' % name)
        plan.argtypes, plan.restype = [i, i, i, p], i
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w, pw):
    if x.dim() != 3 or w.dim() != 2 or pw.dim() != 2:
        raise ValueError("lstm takes x [T, B, 4H], w [H, 4H], pw [3, H]; "
                         "got %s, %s, %s" % (tuple(x.shape), tuple(w.shape),
                                             tuple(pw.shape)))
    t, b, four_h = x.shape
    h = w.shape[0]
    if four_h != 4 * h or tuple(w.shape) != (h, 4 * h) or \
            tuple(pw.shape) != (3, h):
        raise ValueError("lstm shapes do not match: x %s, w %s, pw %s"
                         % (tuple(x.shape), tuple(w.shape), tuple(pw.shape)))
    if t < 1 or b < 1 or h < 1:
        raise ValueError("empty lstm input %s" % (tuple(x.shape),))
    for name, v in (('x', x), ('w', w), ('pw', pw)):
        if v.dtype != torch.float32:
            # the lstm op casts a 16-bit Input to float32 before the call
            raise TypeError("lstm takes float32; %s is %s" % (name, v.dtype))
        if v.device != x.device:
            raise ValueError("lstm inputs lie on %s and %s"
                             % (x.device, v.device))
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError("lstm runs on cuda or cpu tensors, not %s"
                         % x.device)


def _plain_lstm_forward(x, w, pw):
    """The forward kernel's function in plain PyTorch: (hs, cs, gates),
    [T, B, H], [T, B, H], [T, B, 4H] float32, gates being the
    post-activation (i, f, cand, o).  ``_scan_reference`` of
    lstm_cell.py as an eager loop over T."""
    t, b, four_h = x.shape
    h = four_h // 4
    h_p = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    c_p = torch.zeros_like(h_p)
    hs, cs, gates = [], [], []
    for s in range(t):
        g = x[s] + torch.matmul(h_p, w)
        i = torch.sigmoid(g[:, :h] + c_p * pw[0])
        f = torch.sigmoid(g[:, h:2 * h] + c_p * pw[1])
        cand = torch.tanh(g[:, 2 * h:3 * h])
        c = f * c_p + i * cand
        o = torch.sigmoid(g[:, 3 * h:] + c * pw[2])
        h_p = o * torch.tanh(c)
        c_p = c
        hs.append(h_p)
        cs.append(c)
        gates.append(torch.cat([i, f, cand, o], dim=1))
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def _plain_lstm_backward(w, pw, hs, cs, gates, ct_h, ct_c):
    """The backward kernel's function in plain PyTorch: (dx [T, B, 4H],
    dw [H, 4H], dpw [3, H]) from the forward's saved state and the
    cotangents of hs and cs (None means zeros).  The reverse-time loop of
    ``_lstm_bwd_kernel`` (lstm_cell.py :112-146); h_prev and c_prev are
    hs and cs shifted by one step with a zero first row (:248-250)."""
    t, b, four_h = gates.shape
    h = four_h // 4
    zrow = torch.zeros((1, b, h), dtype=torch.float32, device=hs.device)
    h_prev = torch.cat([zrow, hs[:-1]])
    c_prev = torch.cat([zrow, cs[:-1]])
    dh_c = torch.zeros((b, h), dtype=torch.float32, device=hs.device)
    dc_c = torch.zeros_like(dh_c)
    dw = torch.zeros_like(w)
    dpw = torch.zeros_like(pw)
    dx = torch.empty_like(gates)
    for s in range(t - 1, -1, -1):
        g = gates[s]
        i, f = g[:, :h], g[:, h:2 * h]
        cand, o = g[:, 2 * h:3 * h], g[:, 3 * h:]
        c_t, c_p = cs[s], c_prev[s]
        dh = dh_c if ct_h is None else ct_h[s] + dh_c
        tc = torch.tanh(c_t)
        dgo = dh * tc * o * (1.0 - o)
        dc = dc_c if ct_c is None else ct_c[s] + dc_c
        dc = dc + dh * o * (1.0 - tc * tc) + dgo * pw[2]
        dgi = dc * cand * i * (1.0 - i)
        dgf = dc * c_p * f * (1.0 - f)
        dgc = dc * i * (1.0 - cand * cand)
        dg = torch.cat([dgi, dgf, dgc, dgo], dim=1)
        dx[s] = dg
        dw += torch.matmul(h_prev[s].t(), dg)
        dpw[0] += (dgi * c_p).sum(dim=0)
        dpw[1] += (dgf * c_p).sum(dim=0)
        dpw[2] += (dgo * c_t).sum(dim=0)
        dh_c = torch.matmul(dg, w.t())
        dc_c = dc * f + dgi * pw[0] + dgf * pw[1]
    return dx, dw, dpw


def _launch_check(lib, err, name):
    if err != 0:
        raise RuntimeError("%s launch failed: %s"
                           % (name, lib.paddle_cuda_error_string(err)
                              .decode()))


def _aligned(v):
    """v, or a copy where it does not start on 16 bytes (the kernels read
    rows by 8- and 16-byte loads)."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _lstm_forward(x, w, pw, with_gates):
    """(hs, cs, gates or None) of the LSTM over x [T, B, 4H]: the kernel
    on CUDA tensors, ``_plain_lstm_forward`` on CPU tensors.  The no-grad
    path skips the gates' write."""
    _check(x, w, pw)
    if x.device.type == 'cpu':
        hs, cs, gates = _plain_lstm_forward(x, w, pw)
        return hs, cs, gates if with_gates else None
    global launches, fwd_cluster_launches
    t, b, four_h = x.shape
    h = four_h // 4
    _check_width('lstm_fwd', h)
    lib = _lib('lstm_fwd')
    # the kernels read rows by 8- and 16-byte loads: an offset view is
    # copied
    x, w, pw = (_aligned(v.contiguous()) for v in (x, w, pw))
    hs = torch.empty((t, b, h), dtype=torch.float32, device=x.device)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(x) if with_gates else None
    ws = torch.empty((lib.paddle_lstm_fwd_workspace_bytes(t, b, h),),
                     dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.paddle_lstm_fwd(
            x.data_ptr(), w.data_ptr(), pw.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), None if gates is None else gates.data_ptr(),
            ws.data_ptr(), t, b, h, stream)
    _launch_check(lib, err, 'lstm_fwd')
    launches += 1
    if cluster_size(h):
        fwd_cluster_launches += 1
    return hs, cs, gates


def _lstm_backward(w, pw, hs, cs, gates, ct_h, ct_c):
    """(dx, dw, dpw) of the LSTM from its saved state: the kernel on CUDA
    tensors, ``_plain_lstm_backward`` on CPU tensors.  ``ct_h`` / ``ct_c``
    are the cotangents of hs / cs, None for zeros (the LM never reads its
    cells, so ``ct_c`` is None there and no zero tensor is made)."""
    t, b, four_h = gates.shape
    h = four_h // 4
    _check(gates, w, pw)
    for name, v in (('hs', hs), ('cs', cs), ('ct_h', ct_h), ('ct_c', ct_c)):
        if v is not None and (tuple(v.shape) != (t, b, h) or
                              v.dtype != torch.float32 or
                              v.device != gates.device):
            raise ValueError("%s must be a float32 [%d, %d, %d] tensor on %s"
                             % (name, t, b, h, gates.device))
    if gates.device.type == 'cpu':
        return _plain_lstm_backward(w, pw, hs, cs, gates, ct_h, ct_c)
    global bwd_launches, bwd_cluster_launches
    _check_width('lstm_bwd', h)
    lib = _lib('lstm_bwd')
    args = [v if v is None else _aligned(v.contiguous())
            for v in (gates, hs, cs, ct_h, ct_c, w, pw)]
    dx = torch.empty((t, b, four_h), dtype=torch.float32,
                     device=gates.device)
    dw = torch.empty((h, four_h), dtype=torch.float32, device=gates.device)
    dpw = torch.empty((3, h), dtype=torch.float32, device=gates.device)
    ws = torch.empty((lib.paddle_lstm_bwd_workspace_bytes(t, b, h),),
                     dtype=torch.uint8, device=gates.device)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream(gates.device).cuda_stream
        err = lib.paddle_lstm_bwd(
            *[None if v is None else v.data_ptr() for v in args],
            dx.data_ptr(), dw.data_ptr(), dpw.data_ptr(), ws.data_ptr(),
            t, b, h, stream)
    _launch_check(lib, err, 'lstm_bwd')
    bwd_launches += 1
    if cluster_size(h):
        bwd_cluster_launches += 1
    return dx, dw, dpw


def _lstm_fwd_impl(x, w, pw, with_gates):
    hs, cs, gates = _lstm_forward(x, w, pw, with_gates)
    return hs, cs, gates if gates is not None else x.new_empty((0,))


# #7 as the PyTorch operator paddle_tpu_torch::lstm_fwd, as #1 is
# paddle_tpu_torch::flash_fwd (flash_attention.py), so that torch.export
# records it as one node and an inference program of the LSTM models
# exports: its CUDA implementation is ``_lstm_forward``'s launch, its CPU
# one the plain version, its fake one gives the shapes.  A schema cannot
# return an optional tensor, so without ``with_gates`` the gates come back
# as an empty tensor.  The route helpers (``kernel_takes``, ``fwd_path``,
# ``cluster_size``, ``padded_width``) stay outside the operator and decide
# without a build, so tracing never reaches the loader.
_LIB = torch.library.Library('paddle_tpu_torch', 'FRAGMENT')
_LIB.define('lstm_fwd(Tensor x, Tensor w, Tensor pw, bool with_gates) '
            '-> (Tensor, Tensor, Tensor)')
_LIB.impl('lstm_fwd', _lstm_fwd_impl, 'CUDA')
_LIB.impl('lstm_fwd', _lstm_fwd_impl, 'CPU')


@torch.library.register_fake('paddle_tpu_torch::lstm_fwd', lib=_LIB)
def _lstm_fwd_fake(x, w, pw, with_gates):
    _check(x, w, pw)
    t, b, four_h = x.shape
    hs = x.new_empty((t, b, four_h // 4))
    return (hs, torch.empty_like(hs),
            torch.empty_like(x) if with_gates else x.new_empty((0,)))


lstm_fwd = torch.ops.paddle_tpu_torch.lstm_fwd.default


class _LSTMScan(torch.autograd.Function):
    """(hs, cs) of the LSTM, differentiable in x, w and pw: the forward
    saves (w, pw, hs, cs, gates) and the backward replays them in the BPTT
    kernel (the reference's ``_fwd`` / ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, pw):
        hs, cs, gates = lstm_fwd(x, w, pw, True)
        ctx.save_for_backward(w, pw, hs, cs, gates)
        ctx.set_materialize_grads(False)
        return hs, cs

    @staticmethod
    def backward(ctx, ct_h, ct_c):
        w, pw, hs, cs, gates = ctx.saved_tensors
        return _lstm_backward(w, pw, hs, cs, gates, ct_h, ct_c)


def lstm_scan(x_tm, w, pw=None):
    """Fused LSTM over time-major gate inputs x_tm [T, B, 4H] (bias
    added), recurrent weight w [H, 4H] and optional peephole weights pw
    [3, H]; zero initial state.  Returns (hs, cs), [T, B, H] each.
    Differentiable; without gradients the forward skips the gates.  A
    width that is not a multiple of 4 runs padded with zero units."""
    h = w.shape[0]
    if pw is None:
        pw = torch.zeros((3, h), dtype=torch.float32, device=w.device)
    p = padded_width(h) - h
    if p:
        x_tm, w, pw = (pad_units(x_tm, 4, p), pad_units(w, 4, p, p),
                       pad_units(pw, 1, p))
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x_tm, w, pw)):
        hs, cs = _LSTMScan.apply(x_tm, w, pw)
    else:
        hs, cs, _ = lstm_fwd(x_tm, w, pw, False)
    return (hs[..., :h], cs[..., :h]) if p else (hs, cs)

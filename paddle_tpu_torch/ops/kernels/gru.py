"""Fused GRU time loop, forward and backward through time: hand-written
Hopper kernels and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/lstm_cell.py's GRU half: the forward
(``_gru_kernel``, ``_gru_forward``) and the BPTT backward
(``_gru_bwd_kernel``, ``_gru_backward``), joined by a
``torch.autograd.Function`` as the reference joins them by
``jax.custom_vjp`` (``_gru_scan_core``), plus ``gru_scan``.  The kernels
are CUDA C++ in ``paddle_tpu_torch/csrc/gru_fwd.cu`` and ``gru_bwd.cu``,
compiled for ``sm_90a`` at first use (ops/kernels/build.py) and called
through ctypes on the tensors' current stream.  Their designs and what
bounds them are noted in those sources.

The recurrence, time-major: x [T, B, 3H] holds the pre-projected gate
inputs (bias added), w [H, 3H] the recurrent weight (``[:, :2H]`` update
and reset, ``[:, 2H:]`` candidate), h0 [B, H] the initial state (zeros
when None); the reset gate multiplies h before the candidate's product:

    u, r = sigmoid(x_t[:, :2H] + h W[:, :2H]) split in two
    c = tanh(x_t[:, 2H:] + (r * h) W[:, 2H:]);  h' = u * h + (1 - u) * c

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernels (a failed build or launch raises, as does a shape the kernels
do not take), CPU tensors take the plain versions ``_plain_gru_forward``
and ``_plain_gru_backward``, eager loops over T that restate the
reference's ``_gru_scan_reference`` (with h0) and its BPTT math.  They are
what the CPU tests and ``chip_smoke.py`` hold the kernels against.  The
reference's VMEM fit test and batch tiling are not ported.  Both kernels
walk T on one of two paths, by one rule on the width alone (``fwd_path``,
``bwd_path``, ``cluster_size``; decided without a build, as
``kernel_takes`` is): up to 512 units (the seq2seq translator's width) a
persistent thread-block cluster of ceil(H / 32) blocks keeps W in shared
memory, split by hidden units, and computes its products on the tensor
cores (csrc/gru_cluster.cuh: W's columns for the forward's h W, its rows
for the backward's products with W^T); wider ones take the row-tiled
kernels, which tile the batch by ``ROWS_PER_BLOCK`` rows a block and keep
one tile's state in shared memory, which caps the hidden width
(``max_hidden``).  The backward then computes dW on the tensor cores.
The kernels read h as float4, so ``gru_scan`` pads
another width with zero units up to a multiple of 4 (a zero unit stays
zero and feeds nothing) and slices them off again; ``kernel_takes`` says
whether the padded width fits both caps.  A width past them raises on a
CUDA tensor, and the ``gru`` op (ops/rnn.py) sends it to its eager scan
instead, as the reference sends a shape its VMEM cannot hold to
``lax.scan``.  Float32 only: bfloat16 inputs, which
benchmarks/bench_seq2seq.py builds, come with the AMP slice.
"""
import ctypes

import torch

from .lstm import CLUSTER_UNITS, _aligned, cluster_blocks, pad_units, \
    padded_width

__all__ = ['gru_scan', 'launches', 'fwd_cluster_launches', 'bwd_launches',
           'bwd_cluster_launches', 'ROWS_PER_BLOCK', 'max_hidden',
           'kernel_takes', 'cluster_size', 'fwd_path', 'bwd_path',
           'fwd_plan', 'bwd_plan']

# kernel launches in this process (plain-version calls excluded); one
# backward launch is the call that runs its chain, the dW tiles and their
# finish
launches = 0              # forward (#9), both paths
fwd_cluster_launches = 0  # forward on the cluster path
bwd_launches = 0          # backward (#10), both paths
bwd_cluster_launches = 0  # backward on the cluster path

# batch rows per block of both kernels' wide paths (8 or 16; gru_fwd.cu
# says why 8)
ROWS_PER_BLOCK = 8

# The kernels' hidden-width caps, as the built libraries report them
# (``paddle_<name>_max_hidden(rows)``): a block's 232448 bytes of shared
# memory over the floats one tile of ``rows`` batch rows keeps there per
# hidden unit, 3 * rows for the forward (h, r * h, u) and 4 * rows for the
# backward (the carry, dc_pre, [du_pre, dr_pre]).  chip_smoke.py holds
# them against the libraries.
_SMEM = 232448
_FLOATS_PER_UNIT = {'gru_fwd': lambda rows: 3 * rows,
                    'gru_bwd': lambda rows: 4 * rows}


def max_hidden(name, rows=ROWS_PER_BLOCK):
    """The largest hidden width kernel ``name`` takes at ``rows`` batch
    rows per block (8 or 16); 0 at another row count."""
    if rows not in (8, 16):
        return 0
    return _SMEM // (_FLOATS_PER_UNIT[name](rows) * 4)


def kernel_takes(h):
    """Whether both kernels take hidden width ``h`` at ROWS_PER_BLOCK
    batch rows per block once ``gru_scan`` has padded it to a multiple of
    4; decided without a build."""
    return 1 <= h and padded_width(h) <= min(
        max_hidden(n) for n in _FLOATS_PER_UNIT)


# the cluster chains of #9 and #10: at most 16 blocks (the non-portable
# cluster size), so widths up to 512 (csrc/gru_cluster.cuh kMaxBlocks);
# chip_smoke.py holds the rule against both libraries'
MAX_CLUSTER_BLOCKS = 16


def cluster_size(h):
    """Blocks of the cluster whose chain #9 and #10 run at hidden width
    ``h``: ceil(h / 32) up to 512 units, 0 past them (the wide path).
    Decided by the width alone, without a build."""
    return cluster_blocks(h, MAX_CLUSTER_BLOCKS)


def bwd_path(h):
    """#10's chain at hidden width ``h``: 'cluster' (W resident in a
    cluster's shared memory) or 'wide' (the row-tiled chain)."""
    return 'cluster' if cluster_size(h) else 'wide'


def fwd_path(h):
    """#9's time loop at hidden width ``h``, by #10's rule: 'cluster' (W's
    columns resident in a cluster's shared memory) or 'wide' (the
    row-tiled loop)."""
    return bwd_path(h)


def _plan(name, keys, t, b, h):
    lib = _lib(name)
    fn = getattr(lib, 'paddle_%s_plan' % name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(keys))()
    _launch_check(lib, fn(t, b, h, ctypes.cast(out, ctypes.c_void_p)),
                  '%s plan' % name)
    return dict(zip(keys, list(out)), path=bwd_path(h))


_CHAIN_PLAN = ('cluster_size', 'rows_per_cluster', 'active_clusters',
               'clusters')


def fwd_plan(t, b, h):
    """#9's launch for (T, B, H) on the current card, as the library plans
    it: its cluster size (0 on the wide path), batch rows per cluster, the
    clusters of that size the card runs at once, the clusters launched.
    Builds the library."""
    return _plan('gru_fwd', _CHAIN_PLAN, t, b, h)


def bwd_plan(t, b, h):
    """#10's launch for (T, B, H) on the current card, as the library
    plans it: #9's keys, then dW's row ranges and blocks.  Builds the
    library."""
    return _plan('gru_bwd', _CHAIN_PLAN + ('dw_splits', 'dw_blocks'), t, b,
                 h)


def _check_width(name, h, rows):
    if h % 4 or not 1 <= h <= max_hidden(name, rows):
        raise ValueError("the %s kernel takes hidden widths that are "
                         "multiples of 4 up to %d at 8 or 16 rows per block, "
                         "not H=%d at %d rows"
                         % (name, max_hidden(name, rows), h, rows))


def _lib(name):
    from . import build
    lib = build.load(name)
    fn = getattr(lib, 'paddle_' + name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (6 if name == 'gru_fwd' else 9) + [i, i, i, i, p]
        fn.restype = ctypes.c_int
        ws = getattr(lib, 'paddle_%s_workspace_bytes' % name)
        ws.argtypes = [i, i, i]
        ws.restype = ctypes.c_int64
        rule = getattr(lib, 'paddle_%s_cluster_size' % name)
        rule.argtypes, rule.restype = [i], i
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w, h0):
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError("gru takes x [T, B, 3H] and w [H, 3H]; got %s, %s"
                         % (tuple(x.shape), tuple(w.shape)))
    t, b, three_h = x.shape
    h = w.shape[0]
    if three_h != 3 * h or tuple(w.shape) != (h, 3 * h):
        raise ValueError("gru shapes do not match: x %s, w %s"
                         % (tuple(x.shape), tuple(w.shape)))
    if h0 is not None and tuple(h0.shape) != (b, h):
        raise ValueError("gru h0 must be [%d, %d], got %s"
                         % (b, h, tuple(h0.shape)))
    if t < 1 or b < 1 or h < 1:
        raise ValueError("empty gru input %s" % (tuple(x.shape),))
    for name, v in (('x', x), ('w', w), ('h0', h0)):
        if v is None:
            continue
        if v.dtype != torch.float32:
            # the gru ops cast a 16-bit Input to float32 before the call
            raise TypeError("gru takes float32; %s is %s" % (name, v.dtype))
        if v.device != x.device:
            raise ValueError("gru inputs lie on %s and %s"
                             % (x.device, v.device))
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError("gru runs on cuda or cpu tensors, not %s"
                         % x.device)


def _plain_gru_forward(x, w, h0):
    """The forward kernel's function in plain PyTorch: (hs [T, B, H], gates
    [T, B, 3H]) float32, gates being the post-activation (u, r, c).
    ``_gru_scan_reference`` of lstm_cell.py, from h0, as an eager loop over
    T."""
    t, b, three_h = x.shape
    h = three_h // 3
    w_rz, w_c = w[:, :2 * h], w[:, 2 * h:]
    h_p = (torch.zeros((b, h), dtype=torch.float32, device=x.device)
           if h0 is None else h0)
    hs, gates = [], []
    for s in range(t):
        rz = x[s, :, :2 * h] + torch.matmul(h_p, w_rz)
        u = torch.sigmoid(rz[:, :h])
        r = torch.sigmoid(rz[:, h:])
        c = torch.tanh(x[s, :, 2 * h:] + torch.matmul(r * h_p, w_c))
        h_p = u * h_p + (1.0 - u) * c
        hs.append(h_p)
        gates.append(torch.cat([u, r, c], dim=1))
    return torch.stack(hs), torch.stack(gates)


def _plain_gru_backward(w, h0, hs, gates, ct_h):
    """The backward kernel's function in plain PyTorch: (dx [T, B, 3H], dw
    [H, 3H], dh0 [B, H]) from the forward's saved state and the cotangent
    of hs (None means zeros).  The reverse-time loop of ``_gru_bwd_kernel``
    (lstm_cell.py :378-413); h_prev is hs shifted by one step with h0
    (zeros when None) as its first row."""
    t, b, three_h = gates.shape
    h = three_h // 3
    w_rz, w_c = w[:, :2 * h], w[:, 2 * h:]
    first = (torch.zeros((1, b, h), dtype=torch.float32, device=hs.device)
             if h0 is None else h0[None])
    h_prev = torch.cat([first, hs[:-1]])
    dh_c = torch.zeros((b, h), dtype=torch.float32, device=hs.device)
    dw = torch.zeros_like(w)
    dx = torch.empty_like(gates)
    for s in range(t - 1, -1, -1):
        u, r, c = gates[s, :, :h], gates[s, :, h:2 * h], gates[s, :, 2 * h:]
        h_p = h_prev[s]
        dh = dh_c if ct_h is None else ct_h[s] + dh_c
        du = dh * (h_p - c)
        dc = dh * (1.0 - u)
        dc_pre = dc * (1.0 - c * c)
        drh = torch.matmul(dc_pre, w_c.t())
        dr = drh * h_p
        du_pre = du * u * (1.0 - u)
        dr_pre = dr * r * (1.0 - r)
        dg_rz = torch.cat([du_pre, dr_pre], dim=1)
        dx[s] = torch.cat([dg_rz, dc_pre], dim=1)
        dw[:, :2 * h] += torch.matmul(h_p.t(), dg_rz)
        dw[:, 2 * h:] += torch.matmul((r * h_p).t(), dc_pre)
        dh_c = dh * u + drh * r + torch.matmul(dg_rz, w_rz.t())
    return dx, dw, dh_c


def _launch_check(lib, err, name):
    if err != 0:
        raise RuntimeError("%s launch failed: %s"
                           % (name, lib.paddle_cuda_error_string(err)
                              .decode()))


def _ptr(v):
    return None if v is None else v.data_ptr()


def _gru_forward(x, w, h0, with_gates, rows=None):
    """(hs, gates or None) of the GRU over x [T, B, 3H] from h0 (None for
    zeros): the kernel on CUDA tensors, ``_plain_gru_forward`` on CPU
    tensors.  The no-grad path skips the gates' write.  ``rows`` overrides
    ROWS_PER_BLOCK on the wide path."""
    _check(x, w, h0)
    if x.device.type == 'cpu':
        hs, gates = _plain_gru_forward(x, w, h0)
        return hs, gates if with_gates else None
    global launches, fwd_cluster_launches
    t, b, three_h = x.shape
    h = three_h // 3
    rows = rows or ROWS_PER_BLOCK
    _check_width('gru_fwd', h, rows)
    lib = _lib('gru_fwd')
    # the kernels read rows by 8- and 16-byte loads: an offset view is
    # copied
    x, w, h0 = (None if v is None else _aligned(v.contiguous())
                for v in (x, w, h0))
    dev = x.device
    hs = torch.empty((t, b, h), dtype=torch.float32, device=dev)
    gates = torch.empty_like(x) if with_gates else None
    ws = torch.empty((lib.paddle_gru_fwd_workspace_bytes(t, b, h),),
                     dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paddle_gru_fwd(x.data_ptr(), w.data_ptr(), _ptr(h0),
                                 hs.data_ptr(), _ptr(gates), ws.data_ptr(),
                                 t, b, h, rows, stream)
    _launch_check(lib, err, 'gru_fwd')
    launches += 1
    if cluster_size(h):
        fwd_cluster_launches += 1
    return hs, gates


def _gru_backward(w, h0, hs, gates, ct_h, rows=None):
    """(dx, dw, dh0) of the GRU from its saved state: the kernel on CUDA
    tensors, ``_plain_gru_backward`` on CPU tensors.  ``h0`` and ``ct_h``
    (the cotangent of hs) may be None for zeros; dh0 is computed either
    way."""
    t, b, three_h = gates.shape
    h = three_h // 3
    _check(gates, w, h0)
    for name, v in (('hs', hs), ('ct_h', ct_h)):
        if v is not None and (tuple(v.shape) != (t, b, h) or
                              v.dtype != torch.float32 or
                              v.device != gates.device):
            raise ValueError("%s must be a float32 [%d, %d, %d] tensor on %s"
                             % (name, t, b, h, gates.device))
    if gates.device.type == 'cpu':
        return _plain_gru_backward(w, h0, hs, gates, ct_h)
    global bwd_launches, bwd_cluster_launches
    rows = rows or ROWS_PER_BLOCK
    _check_width('gru_bwd', h, rows)
    lib = _lib('gru_bwd')
    # the kernel reads rows by 16-byte copies: an offset view is copied
    args = [None if v is None else _aligned(v.contiguous())
            for v in (gates, hs, h0, ct_h, w)]
    dev = gates.device
    dx = torch.empty((t, b, three_h), dtype=torch.float32, device=dev)
    dw = torch.empty((h, three_h), dtype=torch.float32, device=dev)
    dh0 = torch.empty((b, h), dtype=torch.float32, device=dev)
    ws = torch.empty((lib.paddle_gru_bwd_workspace_bytes(t, b, h),),
                     dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paddle_gru_bwd(
            *[_ptr(v) for v in args], dx.data_ptr(), dw.data_ptr(),
            dh0.data_ptr(), ws.data_ptr(), t, b, h, rows, stream)
    _launch_check(lib, err, 'gru_bwd')
    bwd_launches += 1
    if cluster_size(h):
        bwd_cluster_launches += 1
    return dx, dw, dh0


class _GRUScan(torch.autograd.Function):
    """hs of the GRU, differentiable in x, w and h0: the forward saves (w,
    h0, hs, gates) and the backward replays them in the BPTT kernel (the
    reference's ``_gru_fwd`` / ``_gru_bwd``), returning dh0 as well."""

    @staticmethod
    def forward(ctx, x, w, h0):
        hs, gates = _gru_forward(x, w, h0, with_gates=True)
        ctx.save_for_backward(w, h0, hs, gates)
        ctx.set_materialize_grads(False)
        return hs

    @staticmethod
    def backward(ctx, ct_h):
        w, h0, hs, gates = ctx.saved_tensors
        dx, dw, dh0 = _gru_backward(w, h0, hs, gates, ct_h)
        return dx, dw, (dh0 if h0 is not None else None)


def gru_scan(x_tm, w, h0=None):
    """Fused GRU over time-major gate inputs x_tm [T, B, 3H] (bias added)
    and recurrent weight w [H, 3H]; h0 [B, H] is the initial state (zeros
    when None; the seq2seq decoder chains its encoder summary in).  Returns
    hs [T, B, H].  Differentiable; without gradients the forward skips the
    gates.  A width that is not a multiple of 4 runs padded with zero
    units."""
    h = w.shape[0]
    p = padded_width(h) - h
    if p:
        x_tm, w = pad_units(x_tm, 3, p), pad_units(w, 3, p, p)
        h0 = None if h0 is None else pad_units(h0, 1, p)
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad for v in (x_tm, w, h0)):
        hs = _GRUScan.apply(x_tm, w, h0)
    else:
        hs, _ = _gru_forward(x_tm, w, h0, with_gates=False)
    return hs[..., :h] if p else hs

"""Row-sparse (SelectedRows) optimizer applies: a hand-written Hopper kernel
and its plain PyTorch versions.

Port of paddle_tpu/ops/pallas/table_update.py (``_rowwise_kernel`` through
``_rowwise_call``, rules ``sparse_apply_sgd`` / ``sparse_apply_adagrad`` /
``sparse_apply_adam``).  The kernel is CUDA C++ in
``paddle_tpu_torch/csrc/table_update.cu``: a warp per short run of equal
ids, and for a long run one warp per 32-column slice with its value rows
streamed far ahead of the sums, updates that row of every state table in
place, so untouched rows are never read or written; each column's sum
runs in slot order.  Its design and what bounds it are noted in that
source.

Each ``sparse_apply_*`` takes float32 tables [height, D], ids [K] (any
integer type; the reference's index rules: negatives wrap, other ids
outside [0, height) are skipped) and values [K, D], updates the tables in
place and returns them.  Outside the kernel the ids are normalised and
sorted stably (``torch.sort``, a library sort, as the reference's
``argsort`` is XLA outside its kernel); the kernel finds the runs itself,
so a call makes no host sync and can be captured in a CUDA graph.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (a failed build or launch raises), CPU tensors take the plain
version (``plain_sparse_apply_sgd`` / ``_adagrad`` / ``_adam``).  The plain
versions restate the reference's scatter branches (paddle_tpu/ops/
optim_ops.py ``_sgd`` :141, ``_adagrad`` :286-291, ``_adam`` :216-223) in
eager torch over the port's ``merge_rows_sentinel``; on the card the
kernel is bitwise equal to them (every product, sum, quotient and square
root rounded separately in the same order).  sgd applies duplicates one
by one in slot order; adagrad and adam merge them first.  The reference's
switch between its two lowerings (PADDLE_TPU_SPARSE_APPLY,
``sparse_apply_mode``) is not ported.

``lr`` / ``lr_t`` are one-element float32 tensors on the tables' device;
beta1, beta2 and epsilon are host floats, rounded to float32 as torch
rounds a Python scalar in the plain versions.
"""
import ctypes

import torch

from ...core.selected_rows import (_fold_runs, _runs, merge_rows_sentinel,
                                   normalize_rows)
from .dense_update import _f32

__all__ = ['sparse_apply_sgd', 'sparse_apply_adagrad', 'sparse_apply_adam',
           'plain_sparse_apply_sgd', 'plain_sparse_apply_adagrad',
           'plain_sparse_apply_adam', 'sort_rows', 'launch_sorted', 'RULES',
           'launches']

launches = 0   # kernel launches in this process (plain-version calls excluded)

# the kernel's rule codes (csrc/table_update.cu)
RULES = {'sgd': 0, 'adagrad': 1, 'adam': 2}


def _lib():
    from . import build
    lib = build.load('table_update')
    fn = lib.paddle_table_update
    if fn.argtypes is None:
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        fn.argtypes = [i, p, p, p, ctypes.c_int64, i, i, p, p, p, p,
                       f, f, f, f, f, p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(tables, rows, values, lr):
    height, width = tables[0].shape if tables[0].dim() == 2 else (None, None)
    dev = tables[0].device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError("sparse apply runs on cuda or cpu tensors, not %s"
                         % dev)
    for t in tables:
        if t.dim() != 2 or tuple(t.shape) != (height, width):
            raise ValueError("sparse apply takes [height, D] tables of one "
                             "shape, got %s" % (tuple(t.shape),))
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("sparse apply takes contiguous float32 tables")
    if rows.dim() != 1 or rows.dtype.is_floating_point:
        raise ValueError("ids must be a 1-D integer tensor")
    if values.dtype != torch.float32 or values.dim() != 2 or \
            tuple(values.shape) != (rows.shape[0], width):
        raise ValueError("values must be float32 [K, %s], got %s %s"
                         % (width, values.dtype, tuple(values.shape)))
    for name, v in (('ids', rows), ('values', values), ('lr', lr)):
        if v.device != dev:
            raise ValueError("%s lie on %s, the tables on %s"
                             % (name, v.device, dev))
    if lr.numel() != 1 or lr.dtype != torch.float32:
        raise ValueError("the learning rate must be a one-element float32 "
                         "tensor")
    if height < 1 or height >= 2 ** 31:
        raise ValueError("table height %d out of the kernel's range"
                         % height)


def sort_rows(rows, height):
    """(sorted ids int32, sort order int64): the ids normalised to the
    reference's rules and sorted stably, the kernel's input."""
    srows, order = torch.sort(normalize_rows(rows, height).int(),
                              stable=True)
    return srows, order


def _launch(rule, tables, rows, values, lr, **scalars):
    if rows.numel():
        srows, order = sort_rows(rows, tables[0].shape[0])
        launch_sorted(rule, tables, srows, order, values, lr, **scalars)


def launch_sorted(rule, tables, srows, order, values, lr, a=0.0, b=0.0,
                  c=0.0, d=0.0, e=0.0):
    """The kernel alone on ids already through ``sort_rows``: ``rule``
    from RULES; adagrad's a = epsilon, adam's a..e = beta1, beta2,
    epsilon, 1 - beta1, 1 - beta2, each rounded to float32."""
    global launches
    height, width = tables[0].shape
    k = int(srows.numel())
    values = values.contiguous()
    lib = _lib()
    ptrs = [t.data_ptr() for t in tables] + [None] * (3 - len(tables))
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.paddle_table_update(
            rule, srows.data_ptr(), order.data_ptr(), values.data_ptr(), k,
            width, height, ptrs[0], ptrs[1], ptrs[2], lr.data_ptr(), a, b, c,
            d, e, stream)
    if err != 0:
        raise RuntimeError("table_update launch failed: %s"
                           % lib.paddle_cuda_error_string(err).decode())
    launches += 1


def plain_sparse_apply_sgd(param, rows, values, lr):
    """param[rows] += -lr * values, duplicates one by one in slot order
    (optim_ops.py _sgd's scatter-add), in place; returns param."""
    height = param.shape[0]
    rows = normalize_rows(rows, height)
    keep = rows < height
    if not bool(keep.any()):
        return param
    ids, starts, counts, order = _runs(rows[keep])
    u = -lr * values[keep]
    param[ids] = _fold_runs(u, order, starts, counts, init=param[ids])
    return param


def _merged(rows, values, height):
    """(unique touched rows, their merged values) by merge_rows_sentinel."""
    mrows, g, valid = merge_rows_sentinel(normalize_rows(rows, height),
                                          values, height)
    return mrows[valid], g[valid]


def plain_sparse_apply_adagrad(param, moment, rows, values, lr, epsilon):
    """optim_ops.py _adagrad's sparse branch on the merged rows, in place:
    moment += g * g; param += -lr * g / (sqrt(moment) + epsilon).  Returns
    (param, moment)."""
    ids, g = _merged(rows, values, param.shape[0])
    if ids.numel() == 0:
        return param, moment
    mom_row = moment[ids] + g * g
    step = -lr * g / (torch.sqrt(mom_row) + epsilon)
    moment[ids] = mom_row
    param[ids] = param[ids] + step
    return param, moment


def plain_sparse_apply_adam(param, moment1, moment2, rows, values, lr_t,
                            beta1, beta2, epsilon):
    """optim_ops.py _adam's sparse branch (lazy Adam) on the merged rows,
    in place; ``lr_t`` is the bias-corrected rate.  Returns (param,
    moment1, moment2)."""
    ids, g = _merged(rows, values, param.shape[0])
    if ids.numel() == 0:
        return param, moment1, moment2
    m, v = moment1[ids], moment2[ids]
    m_row = beta1 * m + (1 - beta1) * g
    v_row = beta2 * v + (1 - beta2) * (g * g)
    step = -lr_t * m_row / (torch.sqrt(v_row) + epsilon)
    moment1[ids] = m + (m_row - m)
    moment2[ids] = v + (v_row - v)
    param[ids] = param[ids] + step
    return param, moment1, moment2


def sparse_apply_sgd(param, rows, values, lr):
    """In place: param[rows] -= lr * values.  Returns param."""
    _check([param], rows, values, lr)
    if param.device.type == 'cpu':
        return plain_sparse_apply_sgd(param, rows, values, lr)
    _launch(RULES['sgd'], [param], rows, values, lr)
    return param


def sparse_apply_adagrad(param, moment, rows, values, lr, epsilon):
    """In place: sparse Adagrad on the merged touched rows.  Returns
    (param, moment)."""
    _check([param, moment], rows, values, lr)
    if param.device.type == 'cpu':
        return plain_sparse_apply_adagrad(param, moment, rows, values, lr,
                                          epsilon)
    _launch(RULES['adagrad'], [param, moment], rows, values, lr,
            a=_f32(epsilon))
    return param, moment


def sparse_apply_adam(param, moment1, moment2, rows, values, lr_t, beta1,
                      beta2, epsilon):
    """In place: lazy Adam on the merged touched rows with the
    bias-corrected rate ``lr_t``.  Returns (param, moment1, moment2)."""
    _check([param, moment1, moment2], rows, values, lr_t)
    if param.device.type == 'cpu':
        return plain_sparse_apply_adam(param, moment1, moment2, rows, values,
                                       lr_t, beta1, beta2, epsilon)
    _launch(RULES['adam'], [param, moment1, moment2], rows, values, lr_t,
            a=_f32(beta1), b=_f32(beta2), c=_f32(epsilon), d=_f32(1 - beta1),
            e=_f32(1 - beta2))
    return param, moment1, moment2

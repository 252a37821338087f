"""Dense optimizer applies: a hand-written Hopper kernel and its plain
PyTorch versions.

Port of paddle_tpu/ops/pallas/dense_update.py (``_flat_kernel`` through
``_flat_call``, rules ``dense_apply_sgd`` / ``dense_apply_momentum`` /
``dense_apply_adam``).  The kernel is CUDA C++ in
``paddle_tpu_torch/csrc/dense_update.cu``: one elementwise pass over the
flattened parameter that reads param, grad and moments once and writes
param and moments in place.  Its design and what bounds it are noted in
that source.

Each ``dense_apply_*`` updates its float32 tensors in place and returns
them.  Dispatch is by the tensors' device and nothing else: CUDA tensors
launch the kernel (a failed build or launch raises), CPU tensors take the
plain version (``plain_sgd`` / ``plain_momentum`` / ``plain_adam``) and
copy its result back.  The plain versions restate the reference's eager
expressions (paddle_tpu/ops/optim_ops.py dense branches) term for term;
on the card the kernel is bitwise equal to them, because it rounds every
product, sum, quotient and square root separately in the same order (no
fused multiply-add).  The reference's switch between its two lowerings
(PADDLE_TPU_DENSE_APPLY) is not ported.

The grid is capped at the card's SM count times
``PADDLE_TPU_TORCH_DENSE_APPLY_BLOCKS_PER_SM`` (the autotuner's
``dense_apply_blocks_per_sm``, default 16), read at every launch; the
rule is per element, so every cap gives the same bits.  The reference's
tunable here is ``flat_tile_budget``, a per-block VMEM budget of its tile
walk, which a CUDA block does not have.

``lr`` / ``lr_t`` are one-element float32 tensors on the params' device:
the kernel reads them through a pointer, so the 78 applies of a
transformer step add no host sync.  beta1, beta2, epsilon, mu and the
weight decay are host floats, rounded to float32 as torch rounds a
Python scalar in the plain version.
"""
import ctypes

import numpy as np
import torch

__all__ = ['dense_apply_sgd', 'dense_apply_momentum', 'dense_apply_adam',
           'plain_sgd', 'plain_momentum', 'plain_adam', 'launches',
           'grid_cap', 'launches_by_cap']

launches = 0   # kernel launches in this process (plain-version calls excluded)
launches_by_cap = {}   # blocks per SM -> launches at it
_sms = {}              # device index -> SM count

_RULE_SGD, _RULE_MOMENTUM, _RULE_ADAM = 0, 1, 2


def _lib():
    from . import build
    lib = build.load('dense_update')
    fn = lib.paddle_dense_update
    if fn.argtypes is None:
        p, f = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_int64, f, f, f,
                       f, f, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _f32(x):
    """A Python float rounded to float32, as torch rounds a scalar
    operand of a float32 tensor op."""
    return float(np.float32(x))


def plain_sgd(p, g, lr, weight_decay=None):
    """p - lr * g, or p - lr * (g + wd * p): optim_ops.py _sgd."""
    if weight_decay:
        return p - lr * (g + weight_decay * p)
    return p - lr * g


def plain_momentum(p, v, g, lr, mu, use_nesterov=False):
    """optim_ops.py _momentum: (p_new, v_new)."""
    v_new = mu * v + g
    if use_nesterov:
        return p - (g + mu * v_new) * lr, v_new
    return p - lr * v_new, v_new


def plain_adam(p, m, v, g, lr_t, beta1, beta2, epsilon):
    """optim_ops.py _adam dense tail: (p_new, m_new, v_new)."""
    m_new = beta1 * m + (1 - beta1) * g
    v_new = beta2 * v + (1 - beta2) * (g * g)
    return p - lr_t * m_new / (torch.sqrt(v_new) + epsilon), m_new, v_new


def _check(tables, g, lr):
    shape, dev = g.shape, g.device
    for t in tables + [g]:
        if t.dtype != torch.float32:
            raise TypeError("dense apply takes float32 tensors, got %s"
                            % t.dtype)
        if t.shape != shape:
            raise ValueError("dense apply shapes differ: %s vs %s"
                             % (tuple(t.shape), tuple(shape)))
        if t.device != dev:
            raise ValueError("dense apply tensors lie on %s and %s"
                             % (t.device, dev))
        if not t.is_contiguous():
            raise ValueError("dense apply needs contiguous tensors")
    if lr.numel() != 1 or lr.dtype != torch.float32 or lr.device != dev:
        raise ValueError("the learning rate must be a one-element float32 "
                         "tensor on %s" % dev)


def grid_cap(device):
    """(blocks per SM, most blocks a launch on ``device`` takes): the
    SM count from the device's properties times
    PADDLE_TPU_TORCH_DENSE_APPLY_BLOCKS_PER_SM, read now."""
    from ...flags import FLAGS
    per_sm = int(FLAGS.dense_apply_blocks_per_sm)
    if per_sm < 1:
        raise ValueError("PADDLE_TPU_TORCH_DENSE_APPLY_BLOCKS_PER_SM must be "
                         ">= 1, got %d" % per_sm)
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    sms = _sms.get(idx)
    if sms is None:
        sms = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return per_sm, sms * per_sm


def _launch(rule, tables, g, lr, a=0.0, b=0.0, c=0.0, d=0.0, e=0.0,
            flag=0):
    global launches
    n = g.numel()
    if n == 0:
        return
    lib = _lib()
    per_sm, max_blocks = grid_cap(g.device)
    ptrs = [t.data_ptr() for t in tables] + [None] * (3 - len(tables))
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.paddle_dense_update(
            rule, ptrs[0], ptrs[1], ptrs[2], g.data_ptr(), lr.data_ptr(), n,
            a, b, c, d, e, flag, max_blocks, stream)
    if err != 0:
        raise RuntimeError("dense_update launch failed: %s"
                           % lib.paddle_cuda_error_string(err).decode())
    launches += 1
    launches_by_cap[per_sm] = launches_by_cap.get(per_sm, 0) + 1


def _on_cpu(tables, new):
    for t, x in zip(tables, new):
        # a 0-d parameter's rule broadcasts against the [1] learning rate;
        # the kernel writes its one element in place, as this does
        t.copy_(x.reshape(t.shape))
    return tables[0] if len(tables) == 1 else tuple(tables)


def _device(t):
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError("dense apply runs on cuda or cpu tensors, not %s"
                         % t.device)
    return t.device.type


def dense_apply_sgd(param, grad, lr, weight_decay=None):
    """In place: param -= lr * grad (or lr * (grad + wd * param)).
    Returns param."""
    _check([param], grad, lr)
    if _device(param) == 'cpu':
        return _on_cpu([param], [plain_sgd(param, grad, lr, weight_decay)])
    wd = _f32(weight_decay) if weight_decay else 0.0
    _launch(_RULE_SGD, [param], grad, lr, a=wd, flag=int(bool(weight_decay)))
    return param


def dense_apply_momentum(param, velocity, grad, lr, mu, use_nesterov=False):
    """In place: velocity = mu * velocity + grad, then the param step
    (Nesterov or plain).  Returns (param, velocity)."""
    _check([param, velocity], grad, lr)
    if _device(param) == 'cpu':
        return _on_cpu([param, velocity],
                       plain_momentum(param, velocity, grad, lr, mu,
                                      use_nesterov))
    _launch(_RULE_MOMENTUM, [param, velocity], grad, lr, a=_f32(mu),
            flag=int(bool(use_nesterov)))
    return param, velocity


def dense_apply_adam(param, moment1, moment2, grad, lr_t, beta1, beta2,
                     epsilon):
    """In place: the Adam rule with the bias-corrected rate ``lr_t``.
    Returns (param, moment1, moment2)."""
    _check([param, moment1, moment2], grad, lr_t)
    if _device(param) == 'cpu':
        return _on_cpu([param, moment1, moment2],
                       plain_adam(param, moment1, moment2, grad, lr_t,
                                  beta1, beta2, epsilon))
    _launch(_RULE_ADAM, [param, moment1, moment2], grad, lr_t,
            a=_f32(beta1), b=_f32(beta2), c=_f32(epsilon),
            d=_f32(1 - beta1), e=_f32(1 - beta2))
    return param, moment1, moment2

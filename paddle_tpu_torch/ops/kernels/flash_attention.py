"""Flash attention, forward and backward: hand-written Hopper kernels
and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/flash_attention.py: the forward
(``_fa_kernel``, ``_fa_forward``) and the fused backward
(``_fa_bwd_fused_kernel``, ``_fa_backward_pallas``), joined by a
``torch.autograd.Function`` as the reference joins them by
``jax.custom_vjp``, plus ``_to_bhtd``, ``attention_with_lse`` and
``flash_attention``.  The kernels are CUDA C++ in
``paddle_tpu_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu``, compiled for ``sm_90a`` at first use
(ops/kernels/build.py) and called through ctypes on the tensors' current
stream.  Their designs and what bounds them are noted in those sources.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernels (a failed build or launch raises), CPU tensors take the plain
versions ``_plain_forward`` / ``_plain_backward``.  The plain versions
compute the same functions densely in float32 and are what the CPU tests
and ``chip_smoke.py`` hold the kernels against.  The reference's switches
between its backward lowerings (PADDLE_TPU_FLASH_BWD_*) are not ported:
there is one backward kernel.

The TPU tile sizes (2048 x 2048 on v5e) and the ones-column l-sum trick
(which exists for the TPU's 128-lane padding) do not carry over: the
kernel's 64-row tiles are fixed in its source.
"""
import ctypes

import torch

__all__ = ['flash_attention', 'attention_with_lse', 'launches',
           'bwd_launches', 'MAX_HEAD_DIM']

_NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches in this process (plain-version calls excluded)
launches = 0       # forward
bwd_launches = 0   # backward


def _lib(name):
    from . import build
    lib = build.load(name)
    fn = getattr(lib, 'paddle_' + name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        n_ptr = 5 if name == 'flash_attention_fwd' else 10
        fn.argtypes = [p] * n_ptr + [i, i, i, i, i, i, ctypes.c_float, i,
                                     i, p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v):
    for name, x in (('q', q), ('k', k), ('v', v)):
        if x.dim() != 3:
            raise ValueError("flash attention takes [BH, T, D] tensors; %s "
                             "has shape %s" % (name, tuple(x.shape)))
        if x.dtype not in _DTYPES:
            raise TypeError("flash attention takes float32 or bfloat16; "
                            "%s is %s" % (name, x.dtype))
        if not x.is_contiguous():
            raise ValueError("flash attention needs contiguous inputs; %s "
                             "is not" % name)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v dtypes differ: %s %s %s"
                        % (q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v devices differ: %s %s %s"
                         % (q.device, k.device, v.device))
    bh, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError("shapes do not match: q %s, k %s, v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError("head dim %d outside [1, %d]" % (d, MAX_HEAD_DIM))
    if bh < 1 or tq < 1 or k.shape[1] < 1:
        raise ValueError("empty attention: q %s, k %s"
                         % (tuple(q.shape), tuple(k.shape)))


def _plain_forward(q, k, v, causal, scale, q_offset=0, k_offset=0):
    """The kernel's function in plain PyTorch: [BH, Tq, D] x [BH, Tk, D]
    -> (o [BH, Tq, D] in q's dtype, lse [BH, Tq] float32).  Dense float32
    math with the kernel's conventions: scale folded into q, masked
    probabilities zeroed, a fully masked row gives o = 0, lse = -1e30."""
    s = torch.einsum('btd,bsd->bts', q.float() * scale, k.float())
    valid = None
    if causal:
        tq, tk = s.shape[1], s.shape[2]
        qpos = int(q_offset) + torch.arange(tq, device=s.device)
        kpos = int(k_offset) + torch.arange(tk, device=s.device)
        valid = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum('bts,bsd->btd', p, v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _fa_forward(q, k, v, causal, scale, q_offset=0, k_offset=0):
    """q/k/v [BH, T, D] -> (o [BH, Tq, D], lse [BH, Tq] float32).
    ``q_offset``/``k_offset`` shift the causal mask's global positions."""
    _check(q, k, v)
    if q.device.type == 'cpu':
        return _plain_forward(q, k, v, causal, scale, q_offset, k_offset)
    if q.device.type != 'cuda':
        raise ValueError("flash attention runs on cuda or cpu tensors, "
                         "not %s" % q.device)
    global launches
    bh, tq, d = q.shape
    if bh > 65535:
        raise ValueError("batch*heads %d exceeds the grid's 65535" % bh)
    lib = _lib('flash_attention_fwd')
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paddle_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, tq, k.shape[1], d, _DTYPES[q.dtype],
            int(bool(causal)), float(scale), int(q_offset), int(k_offset),
            stream)
    if err != 0:
        raise RuntimeError("flash_attention_fwd launch failed: %s"
                           % lib.paddle_cuda_error_string(err).decode())
    launches += 1
    return o, lse


def _plain_backward(q, k, v, lse, do, di, causal, scale, q_offset=0,
                    k_offset=0):
    """The backward kernel's function in plain PyTorch: (dq, dk, dv) in
    the inputs' dtypes from q/k/v [BH, T, D], the forward's lse [BH, Tq],
    the output cotangent do [BH, Tq, D] and di = rowsum(do * o) - dlse
    [BH, Tq] (float32).  Dense float32 math with the kernel's
    conventions: q is pre-scaled, p is recomputed from lse and masked by
    select (a fully masked row has lse = -1e30, where exp(s - lse) is
    inf), ds = p * (dp - di), and dq takes the scale once."""
    qf = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    s = torch.einsum('btd,bsd->bts', qf, kf)
    p = torch.exp(s - lse[..., None])
    if causal:
        tq, tk = s.shape[1], s.shape[2]
        qpos = int(q_offset) + torch.arange(tq, device=s.device)
        kpos = int(k_offset) + torch.arange(tk, device=s.device)
        valid = qpos[:, None] >= kpos[None, :]
        p = torch.where(valid, p, torch.zeros_like(p))
    dv = torch.einsum('bts,btd->bsd', p, dof)
    dp = torch.einsum('btd,bsd->bts', dof, vf)
    ds = p * (dp - di[..., None])
    dq = torch.einsum('bts,bsd->btd', ds, kf) * scale
    dk = torch.einsum('bts,btd->bsd', ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fa_backward(q, k, v, lse, do, di, causal, scale, q_offset=0,
                 k_offset=0):
    """(dq, dk, dv) of the flash attention at (q, k, v): the kernel on
    CUDA tensors, ``_plain_backward`` on CPU tensors.  ``lse`` and ``di``
    are float32 [BH, Tq]; ``do`` has q's shape and dtype."""
    _check(q, k, v)
    bh, tq, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("do must be a contiguous %s tensor of shape %s"
                         % (q.dtype, tuple(q.shape)))
    for name, x in (('lse', lse), ('di', di)):
        if x.shape != (bh, tq) or x.dtype != torch.float32 or \
                not x.is_contiguous():
            raise ValueError("%s must be a contiguous float32 [%d, %d] "
                             "tensor" % (name, bh, tq))
    if not (do.device == lse.device == di.device == q.device):
        raise ValueError("backward inputs lie on different devices")
    if q.device.type == 'cpu':
        return _plain_backward(q, k, v, lse, do, di, causal, scale,
                               q_offset, k_offset)
    if q.device.type != 'cuda':
        raise ValueError("flash attention runs on cuda or cpu tensors, "
                         "not %s" % q.device)
    global bwd_launches
    if bh > 65535:
        raise ValueError("batch*heads %d exceeds the grid's 65535" % bh)
    lib = _lib('flash_attention_bwd')
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dq_acc = torch.empty((bh, tq, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paddle_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dq_acc.data_ptr(), bh, tq, k.shape[1], d,
            _DTYPES[q.dtype], int(bool(causal)), float(scale),
            int(q_offset), int(k_offset), stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd launch failed: %s"
                           % lib.paddle_cuda_error_string(err).decode())
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """[BH, T, D] flash attention returning (o, lse), differentiable in
    q, k, v through both outputs (the reference's ``_flash_with_lse``
    custom VJP): the forward saves (q, k, v, o, lse); the backward folds
    the lse cotangent into di = rowsum(do * o) - dlse, as
    ``_fa_backward_pallas`` does, and runs the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset):
        o, lse = _fa_forward(q, k, v, causal, scale, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, q_offset, k_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        do = do.to(q.dtype).contiguous()
        di = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            di = di - dlse.float()
        dq, dk, dv = _fa_backward(q, k, v, lse, do, di.contiguous(),
                                  *ctx.args)
        return dq, dk, dv, None, None, None, None


def _to_bhtd(q, k, v):
    """[B, T, H, D] (or [BH, T, D] pass-through) -> contiguous
    [B*H, T, D] plus the info to restore the layout."""
    if q.dim() == 3:
        return q.contiguous(), k.contiguous(), v.contiguous(), None
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qf = q.transpose(1, 2).reshape(b * h, tq, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, tk, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, tk, d).contiguous()
    return qf, kf, vf, (b, h, tq, d)


def attention_with_lse(q, k, v, causal=False, scale=None, q_offset=0,
                       k_offset=0):
    """Fused attention returning (o, lse) for online-softmax merging.
    q/k/v [B, T, H, D] -> o [B, T, H, D], lse [B, H, T]; a 3-D
    [BH, T, D] input passes through as is (lse [BH, T]).  q_offset and
    k_offset place the blocks on the global sequence axis for the causal
    mask.  Differentiable in q, k and v through o and lse."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    qf, kf, vf, restore = _to_bhtd(q, k, v)
    o, lse = _FlashAttention.apply(qf, kf, vf, bool(causal), float(scale),
                                   int(q_offset), int(k_offset))
    if restore is None:
        return o, lse
    b, h, tq, d = restore
    return o.reshape(b, h, tq, d).transpose(1, 2), lse.reshape(b, h, tq)


def flash_attention(q, k, v, causal=False, scale=None):
    """softmax(q k^T * scale [+ causal mask]) v over [B, T, H, D] tensors
    (a 3-D [B, T, D] input is one head), never holding the [Tq, Tk]
    score matrix in device memory.  Differentiable."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = (x[:, :, None, :] for x in (q, k, v))
    o, _ = attention_with_lse(q, k, v, causal=causal, scale=scale)
    return o[:, :, 0, :] if squeeze else o

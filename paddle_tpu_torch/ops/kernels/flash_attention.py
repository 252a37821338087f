"""Flash attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Port of the forward half of paddle_tpu/ops/pallas/flash_attention.py
(``_fa_kernel``, ``_fa_forward``, ``_to_bhtd``, ``attention_with_lse``,
``flash_attention``).  The kernel is CUDA C++ in
``paddle_tpu_torch/csrc/flash_attention_fwd.cu``, compiled for ``sm_90a``
at first use (ops/kernels/build.py) and called through ctypes on the
tensors' current stream.  Its design and what bounds it are noted in that
source.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (a failed build or launch raises), CPU tensors take the plain
version ``_plain_forward``.  The plain version computes the same function
densely in float32 and is what the CPU tests and ``chip_smoke.py`` hold
the kernel against.

The TPU tile sizes (2048 x 2048 on v5e) and the ones-column l-sum trick
(which exists for the TPU's 128-lane padding) do not carry over: the
kernel's 64-row tiles are fixed in its source.
"""
import ctypes

import torch

__all__ = ['flash_attention', 'attention_with_lse', 'launches',
           'MAX_HEAD_DIM']

_NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0   # kernel launches in this process (plain-version calls excluded)


def _lib():
    from . import build
    lib = build.load('flash_attention_fwd')
    fn = lib.paddle_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i,
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
    lib = _lib()
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
    mask.  Forward only: the backward kernels are not ported yet."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    qf, kf, vf, restore = _to_bhtd(q, k, v)
    o, lse = _fa_forward(qf, kf, vf, causal, scale, q_offset, k_offset)
    if restore is None:
        return o, lse
    b, h, tq, d = restore
    return o.reshape(b, h, tq, d).transpose(1, 2), lse.reshape(b, h, tq)


def flash_attention(q, k, v, causal=False, scale=None):
    """softmax(q k^T * scale [+ causal mask]) v over [B, T, H, D] tensors
    (a 3-D [B, T, D] input is one head), never holding the [Tq, Tk]
    score matrix in device memory."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = (x[:, :, None, :] for x in (q, k, v))
    o, _ = attention_with_lse(q, k, v, causal=causal, scale=scale)
    return o[:, :, 0, :] if squeeze else o

"""Flash attention, forward and backward: hand-written Hopper kernels
and their plain PyTorch versions.

Port of paddle_tpu/ops/pallas/flash_attention.py: the forward
(``_fa_kernel``, ``_fa_forward``) and the three backward kernels of
``_fa_backward_pallas``, the fused one (``_fa_bwd_fused_kernel``) and the
split pair (``_fa_bwd_dkv_kernel`` for dk and dv, ``_fa_bwd_dq_kernel``
for dq), joined by a ``torch.autograd.Function`` as the reference joins
them by ``jax.custom_vjp``, plus ``_to_bhtd``, ``attention_with_lse`` and
``flash_attention``.  The kernels are CUDA C++ in
``paddle_tpu_torch/csrc/flash_attention_fwd.cu``,
``flash_attention_bwd.cu`` and ``flash_attention_bwd_split.cu``, compiled
for ``sm_90a`` at first use (ops/kernels/build.py) and called through
ctypes on the tensors' current stream.  Their designs and what bounds them
are noted in those sources.

The forward is also the PyTorch operator ``paddle_tpu_torch::flash_fwd``
(``torch.library.Library``), which ``_fa_forward`` calls: tracing by
``torch.export`` cannot follow a ctypes launch, so an exported program
records the operator, and calling the program launches the kernel.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernels (a failed build or launch raises), CPU tensors take the plain
versions ``_plain_forward``, ``_plain_backward`` (fused) and
``_plain_backward_dkv`` / ``_plain_backward_dq`` (split).  The plain
versions compute the same functions densely in float32 and are what the
CPU tests and ``chip_smoke.py`` hold the kernels against.  On bfloat16
and float16 inputs they round where the reference's kernels round: q
times the scale in the storage type (the scale rounded to it first, as
JAX's weak typing does), p to the input type before p.v, and p and ds to
the input type before dv, dk and dq.  l sums the float32 p, where the
reference's ones-column l-sum (D % 128 != 0) sums the rounded p.  On
float32 inputs every rounding is the identity.  Between the
fused backward and the split pair the reference's size rule decides
(``_split_backward``: the fused kernel's dq accumulator against
``_FUSED_DQ_BYTES``); the reference's switches between its backward
lowerings (PADDLE_TPU_FLASH_BWD_*) are not ported.

The TPU tile sizes (2048 x 2048 on v5e) and the ones-column l-sum trick
(which exists for the TPU's 128-lane padding) do not carry over: the
kernels' 64-row tiles are fixed in their sources.
"""
import collections
import ctypes

import torch

__all__ = ['flash_attention', 'attention_with_lse', 'flash_fwd', 'launches',
           'bwd_launches', 'dkv_launches', 'dq_launches', 'dtype_launches',
           'MAX_HEAD_DIM']

_NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches in this process (plain-version calls excluded)
launches = 0       # forward
bwd_launches = 0   # fused backward
dkv_launches = 0   # split backward, dk and dv
dq_launches = 0    # split backward, dq
# the same launches by (C entry point, element type): {(fn, 'bfloat16'): n}
dtype_launches = collections.Counter()

# The reference's cap on its fused backward's dq accumulator (float32
# [tq_p, d] in TPU VMEM, flash_attention.py:527): past it,
# ``_fa_backward_pallas`` runs the split pair.  No VMEM limits the card's
# fused kernel (it adds dq by atomics into device memory), but the port
# takes the kernel the reference takes, so that each Hopper kernel stands
# where its TPU counterpart stands and a 128K-context step runs the split
# pair on both.
_FUSED_DQ_BYTES = 16 * 1024 * 1024


def _split_backward(tq, d):
    """Whether the reference's backward takes its split pair at this
    query length and head dim: the fused kernel's dq accumulator, Tq
    padded to the q tile of ``attention_with_lse``'s default backward
    tiles (1024 for d <= 64, else 512; a shorter Tq is its own tile, as
    ``_shared_padding`` clamps), exceeds ``_FUSED_DQ_BYTES``."""
    block = 1024 if d <= 64 else 512
    tq_p = tq if tq <= block else -(-tq // block) * block
    return tq_p * d * 4 > _FUSED_DQ_BYTES


def _launch(source, fn_name, device, tensors, bh, tq, tk, d, dtype, causal,
            scale, q_offset, k_offset):
    """Call the C entry ``fn_name`` of ``csrc/<source>.cu`` (compiled on
    first use) on ``tensors``' data and ``device``'s current stream;
    raises if the launch fails."""
    from . import build
    lib = build.load(source)
    ptrs = [x.data_ptr() for x in tensors]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * len(ptrs) + [i] * 6 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, bh, tq, tk, d, _DTYPES[dtype], int(bool(causal)),
                 float(scale), int(q_offset), int(k_offset), stream)
    if err != 0:
        raise RuntimeError("%s launch failed: %s" % (
            fn_name, lib.paddle_cuda_error_string(err).decode()))
    dtype_launches[(fn_name, str(dtype).replace('torch.', ''))] += 1


def _check(q, k, v):
    for name, x in (('q', q), ('k', k), ('v', v)):
        if x.dim() != 3:
            raise ValueError("flash attention takes [BH, T, D] tensors; %s "
                             "has shape %s" % (name, tuple(x.shape)))
        if x.dtype not in _DTYPES:
            raise TypeError("flash attention takes float32, bfloat16 or "
                            "float16; %s is %s" % (name, x.dtype))
        if not x.is_contiguous():
            raise ValueError("flash attention needs contiguous inputs; %s "
                             "is not" % name)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v dtypes differ: %s %s %s"
                        % (q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v devices differ: %s %s %s"
                         % (q.device, k.device, v.device))
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError("flash attention runs on cuda or cpu tensors, "
                         "not %s" % q.device)
    bh, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError("shapes do not match: q %s, k %s, v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError("head dim %d outside [1, %d]" % (d, MAX_HEAD_DIM))
    if bh < 1 or tq < 1 or k.shape[1] < 1:
        raise ValueError("empty attention: q %s, k %s"
                         % (tuple(q.shape), tuple(k.shape)))


def _check_backward(q, k, v, lse, do, di):
    _check(q, k, v)
    bh, tq, _ = q.shape
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


def _prescaled(q, scale):
    """q times the softmax scale as float32: on 16-bit q the product is
    taken in q's type with the scale rounded to it, as the reference's
    launchers compute ``(q * scale).astype(q.dtype)``."""
    if q.dtype == torch.float32:
        return q * scale
    # the rounded scale as a host number (exact in q's type, so the
    # product rounds once), which a CUDA graph can capture
    return (q * float(torch.tensor(scale, dtype=q.dtype))).float()


def _rounded(x, dtype):
    """float32 ``x`` rounded to ``dtype`` and back, as the reference's
    kernels round p and ds before their 16-bit products; the identity
    for float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _plain_forward(q, k, v, causal, scale, q_offset=0, k_offset=0):
    """The kernel's function in plain PyTorch: [BH, Tq, D] x [BH, Tk, D]
    -> (o [BH, Tq, D] in q's dtype, lse [BH, Tq] float32).  Dense float32
    math with the kernel's conventions: scale folded into q, masked
    probabilities zeroed, a fully masked row gives o = 0, lse = -1e30;
    on 16-bit inputs q times the scale and p rounded to the input type
    (l sums the float32 p)."""
    s = torch.einsum('btd,bsd->bts', _prescaled(q, scale), k.float())
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
    o = torch.einsum('bts,bsd->btd', _rounded(p, v.dtype),
                     v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _launch_forward(q, k, v, causal, scale, q_offset=0, k_offset=0):
    """The forward kernel's launch on CUDA tensors, checked by ``_check``:
    (o, lse) written by #1 on the current stream."""
    global launches
    _check(q, k, v)
    bh, tq, d = q.shape
    if bh > 65535:
        raise ValueError("batch*heads %d exceeds the grid's 65535" % bh)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    _launch('flash_attention_fwd', 'paddle_flash_attention_fwd', q.device,
            (q, k, v, o, lse), bh, tq, k.shape[1], d, q.dtype, causal, scale,
            q_offset, k_offset)
    launches += 1
    return o, lse


def _flash_fwd_cpu(q, k, v, causal, scale, q_offset, k_offset):
    _check(q, k, v)
    return _plain_forward(q, k, v, causal, scale, q_offset, k_offset)


# #1 as the PyTorch operator paddle_tpu_torch::flash_fwd, so that
# torch.export records it as one node (tracing cannot follow the ctypes
# launch, which reads data_ptr()): CUDA tensors launch the kernel, CPU
# tensors run _plain_forward, fake tensors get (o, lse) of the right shapes
# and dtypes; a loaded artifact calls it again.  Defined and implemented
# through torch.library.Library, whose C++ dispatch costs less host time
# a call than a torch.library.custom_op's.  Every implementation checks
# its inputs, since a loaded artifact calls the operator directly.
_LIB = torch.library.Library('paddle_tpu_torch', 'DEF')
_LIB.define('flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, '
            'float scale, int q_offset, int k_offset) -> (Tensor, Tensor)')
_LIB.impl('flash_fwd', _launch_forward, 'CUDA')
_LIB.impl('flash_fwd', _flash_fwd_cpu, 'CPU')


@torch.library.register_fake('paddle_tpu_torch::flash_fwd', lib=_LIB)
def _flash_fwd_fake(q, k, v, causal, scale, q_offset, k_offset):
    _check(q, k, v)
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


flash_fwd = torch.ops.paddle_tpu_torch.flash_fwd.default


def _fa_forward(q, k, v, causal, scale, q_offset=0, k_offset=0):
    """q/k/v [BH, T, D] -> (o [BH, Tq, D], lse [BH, Tq] float32).
    ``q_offset``/``k_offset`` shift the causal mask's global positions.
    Runs through the ``flash_fwd`` operator."""
    return flash_fwd(q, k, v, bool(causal), float(scale), int(q_offset),
                     int(k_offset))


def _plain_probs(q, k, v, lse, do, di, causal, scale, q_offset, k_offset):
    """What every backward kernel recomputes, densely in float32: the
    pre-scaled q, k, do, p = exp(s - lse) masked by select (a fully masked
    row has lse = -1e30, where exp(s - lse) is inf) and
    ds = p * (dp - di), p and ds rounded to the input type (the operands
    of dv, dk and dq)."""
    qf = _prescaled(q, scale)
    kf, vf, dof = k.float(), v.float(), do.float()
    s = torch.einsum('btd,bsd->bts', qf, kf)
    p = torch.exp(s - lse[..., None])
    if causal:
        tq, tk = s.shape[1], s.shape[2]
        qpos = int(q_offset) + torch.arange(tq, device=s.device)
        kpos = int(k_offset) + torch.arange(tk, device=s.device)
        valid = qpos[:, None] >= kpos[None, :]
        p = torch.where(valid, p, torch.zeros_like(p))
    dp = torch.einsum('btd,bsd->bts', dof, vf)
    ds = p * (dp - di[..., None])
    return qf, kf, dof, _rounded(p, q.dtype), _rounded(ds, q.dtype)


def _plain_backward_dkv(q, k, v, lse, do, di, causal, scale, q_offset=0,
                        k_offset=0):
    """The dk/dv kernel's function in plain PyTorch: (dk, dv) in k's and
    v's dtypes, dv = p^T do and dk = ds^T (scale q), p and ds rounded to
    the input type; the arguments as
    ``_plain_backward``'s."""
    qf, _, dof, p, ds = _plain_probs(q, k, v, lse, do, di, causal, scale,
                                     q_offset, k_offset)
    dv = torch.einsum('bts,btd->bsd', p, dof)
    dk = torch.einsum('bts,btd->bsd', ds, qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def _plain_backward_dq(q, k, v, lse, do, di, causal, scale, q_offset=0,
                       k_offset=0):
    """The dq kernel's function in plain PyTorch: dq = (ds k) * scale in
    q's dtype (the scale taken once, ds rounded to the input type); the
    arguments as
    ``_plain_backward``'s."""
    _, kf, _, _, ds = _plain_probs(q, k, v, lse, do, di, causal, scale,
                                   q_offset, k_offset)
    dq = torch.einsum('bts,bsd->btd', ds, kf) * scale
    return dq.to(q.dtype)


def _plain_backward(q, k, v, lse, do, di, causal, scale, q_offset=0,
                    k_offset=0):
    """The fused backward kernel's function in plain PyTorch: (dq, dk, dv)
    in the inputs' dtypes from q/k/v [BH, T, D], the forward's lse
    [BH, Tq], the output cotangent do [BH, Tq, D] and
    di = rowsum(do * o) - dlse [BH, Tq] (float32): ``_plain_backward_dq``
    and ``_plain_backward_dkv`` from one recompute of p and ds."""
    qf, kf, dof, p, ds = _plain_probs(q, k, v, lse, do, di, causal, scale,
                                      q_offset, k_offset)
    dv = torch.einsum('bts,btd->bsd', p, dof)
    dq = torch.einsum('bts,bsd->btd', ds, kf) * scale
    dk = torch.einsum('bts,btd->bsd', ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fa_backward_dkv(q, k, v, lse, do, di, causal, scale, q_offset=0,
                     k_offset=0):
    """(dk, dv) of the flash attention at (q, k, v): the split pair's
    dk/dv kernel on CUDA tensors, ``_plain_backward_dkv`` on CPU
    tensors."""
    _check_backward(q, k, v, lse, do, di)
    if q.device.type == 'cpu':
        return _plain_backward_dkv(q, k, v, lse, do, di, causal, scale,
                                   q_offset, k_offset)
    global dkv_launches
    bh, tq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch('flash_attention_bwd_split', 'paddle_flash_attention_bwd_dkv',
            q.device, (q, k, v, do, lse, di, dk, dv),
            bh, tq, k.shape[1], d, q.dtype, causal, scale, q_offset,
            k_offset)
    dkv_launches += 1
    return dk, dv


def _fa_backward_dq(q, k, v, lse, do, di, causal, scale, q_offset=0,
                    k_offset=0):
    """dq of the flash attention at (q, k, v): the split pair's dq kernel
    on CUDA tensors, ``_plain_backward_dq`` on CPU tensors."""
    _check_backward(q, k, v, lse, do, di)
    if q.device.type == 'cpu':
        return _plain_backward_dq(q, k, v, lse, do, di, causal, scale,
                                  q_offset, k_offset)
    global dq_launches
    bh, tq, d = q.shape
    dq = torch.empty_like(q)
    _launch('flash_attention_bwd_split', 'paddle_flash_attention_bwd_dq',
            q.device, (q, k, v, do, lse, di, dq),
            bh, tq, k.shape[1], d, q.dtype, causal, scale, q_offset,
            k_offset)
    dq_launches += 1
    return dq


def _fa_backward_fused(q, k, v, lse, do, di, causal, scale, q_offset=0,
                       k_offset=0):
    """(dq, dk, dv) of the flash attention at (q, k, v): the fused
    backward kernel on CUDA tensors, ``_plain_backward`` on CPU
    tensors."""
    _check_backward(q, k, v, lse, do, di)
    if q.device.type == 'cpu':
        return _plain_backward(q, k, v, lse, do, di, causal, scale,
                               q_offset, k_offset)
    global bwd_launches
    bh, tq, d = q.shape
    if bh > 65535:
        raise ValueError("batch*heads %d exceeds the grid's 65535" % bh)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dq_acc = torch.empty((bh, tq, d), dtype=torch.float32, device=q.device)
    _launch('flash_attention_bwd', 'paddle_flash_attention_bwd', q.device,
            (q, k, v, do, lse, di, dq, dk, dv, dq_acc),
            bh, tq, k.shape[1], d, q.dtype, causal, scale, q_offset,
            k_offset)
    bwd_launches += 1
    return dq, dk, dv


def _fa_backward(q, k, v, lse, do, di, causal, scale, q_offset=0,
                 k_offset=0):
    """(dq, dk, dv) of the flash attention at (q, k, v) by the backward
    the reference's size rule picks (``_split_backward``): the fused
    kernel, or the split pair (dk/dv, then dq).  ``lse`` and ``di`` are
    float32 [BH, Tq]; ``do`` has q's shape and dtype."""
    args = (q, k, v, lse, do, di, causal, scale, q_offset, k_offset)
    if not _split_backward(q.shape[1], q.shape[2]):
        return _fa_backward_fused(*args)
    dk, dv = _fa_backward_dkv(*args)
    return _fa_backward_dq(*args), dk, dv


class _FlashAttention(torch.autograd.Function):
    """[BH, T, D] flash attention returning (o, lse), differentiable in
    q, k, v through both outputs (the reference's ``_flash_with_lse``
    custom VJP): the forward saves (q, k, v, o, lse); the backward folds
    the lse cotangent into di = rowsum(do * o) - dlse, as
    ``_fa_backward_pallas`` does, and runs the backward the reference's
    size rule picks."""

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

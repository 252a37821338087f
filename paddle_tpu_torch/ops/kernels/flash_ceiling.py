"""The flash inner-loop ceiling probe's kernel: a hand-written Hopper
kernel and its plain PyTorch version.

Port of the TPU kernel of benchmarks/exp_flash_ceiling.py (the
``pl.pallas_call`` at :106 over ``make_kernel(variant)``, :48-87).  For
each (bh, logical q tile of ``bq`` rows) it computes the sum over the live
logical k tiles of f(q k^T) v, where k tile ki (``bk`` keys) is live for
q tile qi when qi * bq + bq - 1 >= ki * bk (:59): no element mask, no
normalisation, no scale, no lse.  f is the identity for ``mm`` and
``mmT``, exp(s) for ``exp`` and exp(s - the row max over the logical k
tile) for ``maxexp`` (:73-78); p is rounded to v's dtype before p v, the
sum is float32 and the output [BH, T, D] is in the input dtype (:79-90).
``mmT`` takes k as [BH, D, T] (:99).  The probe splits the flash
forward's time into its stages; ``flash_ceiling_probe.py`` times the four
variants beside the flash forward (#1) itself.

The kernel is CUDA C++ in ``paddle_tpu_torch/csrc/flash_ceiling.cu``, on
the engine #1 runs for the input type: 64-row q tiles and a cp.async ring
of 64-key tiles in both; float32 as 3xTF32 products on the tensor cores
(``csrc/flash_tf32.cuh``), bfloat16 as one m16n8k16 bf16 ``mma.sync`` a
product on 16-bit tiles read by ``ldmatrix`` (``csrc/flash_f16.cuh``).
So each variant differs from #1 only in its tail, in either type.  It is
compiled for ``sm_90a`` at first use (ops/kernels/build.py) and called
through ctypes on the tensors' current stream.  Dispatch is by the
tensors' device and nothing else: CUDA tensors launch the kernel (a
failed build or launch raises), CPU tensors take ``_plain_ceiling``,
which loops over the logical tiles as the TPU grid does.

Tolerance against the plain version, norm-relative (``tolerance``):
float32 1e-5 (both sum in float32 in other orders; at most 1.3e-6 read on
an H100 by chip_smoke.py phase 62).  bfloat16 rounds p to bfloat16 before
p v on both sides, so a last-bit difference in s moves a term by a
bfloat16 ulp now and then: 5e-4 (read: 0 to 1.2e-4, on the 16-bit engine
as on the 3xTF32 one it replaced; a kernel that left out the cast of p
would read 2.3e-3 to 2.9e-3).  The exception is ``maxexp`` with bk > 64:
there the kernel rounds p at exp(s - the running max) and rescales it in
float32, where the plain version rounds exp(s - the tile's max), which
moves every term by up to a bfloat16 rounding: 1e-2 (read: 1.6e-3 to
2.3e-3 on either engine).  At bk = 64 the running max is the tile's and
the 5e-4 holds (read: 0 to 8.2e-5).
"""
import ctypes

import torch

__all__ = ['flash_ceiling', 'VARIANTS', 'live_tiles', 'executed_flops',
           'launches', 'variant_launches', 'tolerance', 'DTYPES']

VARIANTS = ('mm', 'mmT', 'exp', 'maxexp')
_CODES = {name: i for i, name in enumerate(VARIANTS)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64   # the kernel's physical tiles; bq and bk are multiples

# kernel launches in this process (plain-version calls excluded), and by
# (variant, dtype name)
launches = 0
variant_launches = {}


def live_tiles(t, bq, bk):
    """The (q tile, k tile) pairs the probe's tile-level causal test
    leaves live (exp_flash_ceiling.py:95-96)."""
    return sum(1 for qi in range(t // bq) for ki in range(t // bk)
               if qi * bq + bq - 1 >= ki * bk)


def executed_flops(bh, t, d, bq, bk):
    """The probe's ``executed`` (exp_flash_ceiling.py:97): 4 * D flops
    per (q, k) pair of the live tiles."""
    return 4 * t * t * d * bh * (live_tiles(t, bq, bk) /
                                 ((t // bq) * (t // bk)))


def tolerance(dtype, variant, bk):
    """The kernel's norm-relative tolerance against the plain version
    (the module's docstring gives the reasons and the readings)."""
    if dtype == torch.float32:
        return 1e-5
    return 1e-2 if variant == 'maxexp' and bk > _TILE else 5e-4


def _check(q, k, v, variant, bq, bk):
    if variant not in _CODES:
        raise ValueError("variant %r is not one of %s" % (variant, VARIANTS))
    for name, x in (('q', q), ('k', k), ('v', v)):
        if x.dim() != 3:
            raise ValueError("the ceiling probe takes [BH, T, D] tensors "
                             "(k [BH, D, T] for mmT); %s has shape %s"
                             % (name, tuple(x.shape)))
        if x.dtype not in DTYPES:
            raise TypeError("the ceiling probe takes float32 or bfloat16; "
                            "%s is %s" % (name, x.dtype))
        if not x.is_contiguous():
            raise ValueError("the ceiling probe needs contiguous inputs; %s "
                             "is not" % name)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v dtypes differ: %s %s %s"
                        % (q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v devices differ: %s %s %s"
                         % (q.device, k.device, v.device))
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError("the ceiling probe runs on cuda or cpu tensors, "
                         "not %s" % q.device)
    bh, t, d = q.shape
    k_shape = (bh, d, t) if variant == 'mmT' else (bh, t, d)
    if tuple(k.shape) != k_shape or v.shape != q.shape:
        raise ValueError("shapes do not match: q %s, k %s (want %s), v %s"
                         % (tuple(q.shape), tuple(k.shape), k_shape,
                            tuple(v.shape)))
    if not 1 <= d <= 128 or not 1 <= bh <= 65535:
        raise ValueError("head dim %d outside [1, 128] or batch*heads %d "
                         "outside [1, 65535]" % (d, bh))
    for name, b in (('bq', bq), ('bk', bk)):
        if b < _TILE or b % _TILE or t % b:
            raise ValueError("%s = %d must be a positive multiple of %d "
                             "that divides T = %d (the probe's grid would "
                             "cut T, exp_flash_ceiling.py:43-44)"
                             % (name, b, _TILE, t))


def _plain_ceiling(q, k, v, variant, bq, bk):
    """The kernel's function in plain PyTorch, tile by logical tile as the
    TPU grid walks it: for q tile qi, the sum over the live k tiles of
    f(s).astype(v.dtype) @ v in float32, s = q k^T in float32."""
    bh, t, d = q.shape
    kt = k if variant == 'mmT' else k.transpose(1, 2)   # [BH, D, T]
    out = torch.empty((bh, t, d), dtype=torch.float32, device=q.device)
    for qi in range(t // bq):
        qs = q[:, qi * bq:(qi + 1) * bq].float()
        acc = torch.zeros((bh, bq, d), dtype=torch.float32, device=q.device)
        for ki in range(t // bk):
            if qi * bq + bq - 1 < ki * bk:
                break
            s = torch.bmm(qs, kt[:, :, ki * bk:(ki + 1) * bk].float())
            if variant == 'exp':
                s = torch.exp(s)
            elif variant == 'maxexp':
                s = torch.exp(s - s.amax(dim=-1, keepdim=True))
            acc += torch.bmm(s.to(v.dtype).float(),
                             v[:, ki * bk:(ki + 1) * bk].float())
        out[:, qi * bq:(qi + 1) * bq] = acc
    return out.to(q.dtype)


def _launch(q, k, v, o, variant, bq, bk):
    from . import build
    lib = build.load('flash_ceiling')
    fn = lib.paddle_flash_ceiling
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    bh, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                 t, d, DTYPES[q.dtype], _CODES[variant], bq, bk, stream)
    if err != 0:
        raise RuntimeError("paddle_flash_ceiling launch failed: %s"
                           % lib.paddle_cuda_error_string(err).decode())


def flash_ceiling(q, k, v, variant, bq=1024, bk=1024):
    """One call of the probe's kernel ``variant`` over q, v [BH, T, D] and
    k [BH, T, D] ([BH, D, T] for ``mmT``) with logical tiles ``bq`` x
    ``bk`` (multiples of 64 dividing T): the kernel on CUDA tensors,
    ``_plain_ceiling`` on CPU tensors.  Returns o [BH, T, D] in q's
    dtype."""
    _check(q, k, v, variant, bq, bk)
    if q.device.type == 'cpu':
        return _plain_ceiling(q, k, v, variant, bq, bk)
    global launches
    o = torch.empty_like(q)
    _launch(q, k, v, o, variant, bq, bk)
    launches += 1
    key = (variant, str(q.dtype).replace('torch.', ''))
    variant_launches[key] = variant_launches.get(key, 0) + 1
    return o

"""Design probe of the split backward's dq kernel (#4) on the card.

    python3 -m paddle_tpu_torch.ops.kernels.flash_dq_probe

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds variants of ``csrc/flash_attention_bwd_split.cu`` into
``build/kernels/probe/`` (one nvcc each, all started together; ptxas's
registers and spills of every ``fa_bwd_dq_kernel`` instance printed) and
runs each through ``_fa_backward_dq``:

- small cases at the kernel's edges (head-dim tiers 32, 50 and 128,
  masked tiles, ragged lengths that are no multiple of 32, bfloat16),
  against ``_plain_backward_dq`` over every row;
- the training shape, BH=256 T=512 D=64 float32 causal, against the
  plain version over every row, timed in device time (a CUDA graph of 20
  calls replayed between CUDA events);
- one layer at 128K context, BH=8 T=131072 D=64 float32 causal, lse and
  o from the forward kernel, against the plain version on three 64-row
  slices (the first, one across the middle, the last; norm-relative),
  timed as the median of three single calls between CUDA events after a
  warm-up.

Variants: the shipped kernel (its softmax in base 2); the softmax in
base e (``base_e``); and a
diagnostic that is not float32 accurate (``diag_one_tf32``: one plain
TF32 product in place of each 3xTF32 one), whose time says what the
three products and the 3xTF32 splits cost.  Prints one JSON line per
variant (``ok``: every check within its tolerance; absent for a
diagnostic), then the card's name and power limit.
"""
import json
import re
import subprocess

import torch

from . import build
from . import flash_attention as fa
from .table_update_probe import device_ms

__all__ = ['VARIANTS', 'main']

_SOURCE = 'flash_attention_bwd_split'
# the softmax in base e: q scaled by the softmax scale alone, lse as
# given, p = exp(s - lse)
_EXP = (
    ('q_mul = scale * kLog2e;', 'q_mul = scale;'),
    ('lse[(int64_t)bh * tq + r] * kLog2e', 'lse[(int64_t)bh * tq + r]'),
    ('exp2f(s[j][i]', 'expf(s[j][i]'))
# a diagnostic, not float32 accurate: each product one plain TF32 mma of
# the operands' big parts (the compiler drops the small parts), so its
# time against the shipped kernel's says what the three products and the
# splits cost
_ONE_TF32 = (
    ('using namespace flash_tf32;\n',
     'using namespace flash_tf32;\n'
     '__device__ __forceinline__ void mma1(float (&c)[4],\n'
     '    const uint32_t (&ab)[4], const uint32_t (&)[4], float b0,\n'
     '    float b1) {\n'
     '  mma_tf32(c, ab, to_tf32(b0), to_tf32(b1));\n'
     '}\n'),
    ('mma3(s[j]', 'mma1(s[j]'), ('mma3(dp[j]', 'mma1(dp[j]'),
    ('mma3(part[j]', 'mma1(part[j]'))
# name -> (old text, new text) substitutions of the shipped source; a
# 'diag_' variant is not held to the plain version's tolerances
VARIANTS = {
    'shipped': (),
    'base_e': _EXP,
    'diag_one_tf32': _ONE_TF32,
}
SEED = 9
# kernel vs plain version over every row, float32 and bfloat16 (one bf16
# ulp of an O(1) gradient); at 128K norm-relative on 64-row slices, each
# summing up to 131072 terms in other orders (chip_smoke.py's bounds)
TOL_F32 = 1e-4
TOL_BF16 = 3.2e-2
TOL_LONG = 3e-5
EDGE_CASES = (
    # name, bh, tq, tk, d, dtype, causal, q_offset, k_offset
    ('d32_masked_tiles', 4, 192, 320, 32, torch.float32, True, 0, 128),
    ('d50_noncausal_T130', 4, 130, 130, 50, torch.float32, False, 0, 0),
    ('d128_ragged_T200', 4, 200, 200, 128, torch.float32, True, 0, 0),
    ('ragged_q100_over_k170', 4, 100, 170, 64, torch.float32, True, 70, 0),
    ('bf16_d64_T256', 4, 256, 256, 64, torch.bfloat16, True, 0, 0),
    ('bf16_d128_T256', 4, 256, 256, 128, torch.bfloat16, True, 0, 0))


def _dq_resources(log):
    """{instance: 'N registers, ... | spill line'} of the dq kernel from
    ptxas's -v output."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        if 'Compiling entry function' in line and 'fa_bwd_dq_kernel' in line:
            fn = re.search(r'fa_bwd_dq_kernelI(\w+?)Li(\d+)', line)
            key = '%s_%s' % (fn.group(1), fn.group(2)) if fn else line
            follow = lines[i + 1:i + 4]
            regs = next((x.split('info    : ')[-1] for x in follow
                         if 'registers' in x), '')
            spill = next((x.strip() for x in follow if 'spill' in x), '')
            out[key] = '%s | %s' % (regs, spill)
    return out


def _once_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _inputs(gen, bh, tq, tk, d, dtype, causal, qo, ko):
    """The dq kernel's arguments: seeded q, k, v, do; lse and o from the
    plain forward (the forward kernel at 128K, where the plain one cannot
    hold [T, T]); di = rowsum(do * o)."""
    q, k, v, do = (torch.randn((bh, t, d), generator=gen, device='cuda')
                   .to(dtype) for t in (tq, tk, tk, tq))
    scale = d ** -0.5
    forward = fa._fa_forward if tq > 4096 else fa._plain_forward
    o, lse = forward(q, k, v, causal, scale, qo, ko)
    di = (do.float() * o.float()).sum(-1).contiguous()
    return (q, k, v, lse, do, di, causal, scale, qo, ko)


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def main():
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    edge = [(c[0], _inputs(gen, *c[1:])) for c in EDGE_CASES]
    train = _inputs(gen, 256, 512, 512, 64, torch.float32, True, 0, 0)
    long_args = _inputs(gen, 8, 131072, 131072, 64, torch.float32, True, 0,
                        0)
    t = long_args[0].shape[1]
    slices = ((0, 64), (t // 2 - 32, t // 2 + 32), (t - 64, t))
    plain_edge = [fa._plain_backward_dq(*a) for _, a in edge]
    plain_train = fa._plain_backward_dq(*train)
    q, k, v, lse, do, di, causal, scale, _, _ = long_args
    plain_long = [fa._plain_backward_dq(
        q[:, a:b], k, v, lse[:, a:b], do[:, a:b], di[:, a:b], causal,
        scale, a, 0) for a, b in slices]
    libs, logs = build.build_variants(_SOURCE, VARIANTS)
    shipped = build._libs.get(_SOURCE)
    try:
        for name, lib in libs.items():
            build._libs[_SOURCE] = lib
            res = dict(variant=name, ptxas=_dq_resources(logs[name]))
            ok = True
            for (case, args), want in zip(edge, plain_edge):
                got = fa._fa_backward_dq(*args)
                tol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL_F32
                err = _max_err(got, want)
                res[case] = err
                ok &= bool(torch.isfinite(got).all()) and err <= tol
            got = fa._fa_backward_dq(*train)
            res['train_err'] = _max_err(got, plain_train)
            ok &= res['train_err'] <= TOL_F32
            res['train_ms'] = device_ms(lambda: fa._fa_backward_dq(*train))
            got = fa._fa_backward_dq(*long_args)
            gaps = [float((got[:, a:b] - w).norm() / w.norm())
                    for (a, b), w in zip(slices, plain_long)]
            res['long_norm_rel'] = gaps
            ok &= bool(torch.isfinite(got).all()) and max(gaps) <= TOL_LONG
            del got
            times = sorted(_once_ms(lambda: fa._fa_backward_dq(*long_args))
                           for _ in range(3))
            res['long_ms'] = times[1]
            if not name.startswith('diag_'):
                res['ok'] = ok
            print(json.dumps(res), flush=True)
    finally:
        if shipped is None:
            build._libs.pop(_SOURCE, None)
        else:
            build._libs[_SOURCE] = shipped
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == '__main__':
    main()

"""Design probe of the flash kernels' 16-bit engines (#1, #2) on the card.

    python3 -m paddle_tpu_torch.ops.kernels.flash16_probe [--ceiling]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds variants of ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` into ``build/kernels/probe/`` (one nvcc
each, all started together; ptxas's registers and spills of each 16-bit
instance printed) and runs each through ``_fa_forward`` /
``_fa_backward_fused`` at the AMP training shape (BH=256 T=512 D=64
causal) in bfloat16 and float16: checked against the plain version
(chip_smoke.py's bounds) and timed in device time (a CUDA graph of 20
calls replayed between CUDA events), each variant twice, in the order
shipped, variants, variants reversed, shipped, so that a drift of the
card shows as a gap between a variant's two readings.

Variants of #1: the shipped block (64 q rows, four warps, four blocks
an SM at D <= 64: at most 128 registers); three blocks an SM (``b3``:
at most 168); 128 q rows and eight warps (``q128``: K and V read once
for twice the rows), at most 255 registers (one block an SM) or 128
(``q128_b2``: two blocks an SM).  Of #2: the shipped engine (two blocks
an SM at D <= 64, at most 128 registers) and one block an SM (``b1``, up
to 255 registers).
With ``--ceiling`` it probes the ceiling probe's kernel (#11,
``csrc/flash_ceiling.cu``) instead, whose bf16 instances run #1's 16-bit
engine: the shipped launch bounds (four blocks an SM at D <= 64, maxexp
three: at most 168 registers for its second output-sized sum) against
maxexp at four (``maxexp_b4``: at most 128, as #1); ptxas's registers
and spills of every bf16 instance, maxexp and mm checked against
``_plain_ceiling`` at the AMP training shape (``fc.tolerance``) and
timed there (64 x 64 tiles) and at the probe's default shape (BH=128
T=8192 D=64, 1024 x 1024 tiles), in the same order of turns.
Prints one JSON line per variant and type, then the card's name and
power limit.
"""
import json
import re
import subprocess
import sys

import torch

from . import build
from . import flash_attention as fa
from . import flash_ceiling as fc
from .flash_ceiling_probe import probe_inputs
from .table_update_probe import device_ms

__all__ = ['FWD_VARIANTS', 'BWD_VARIANTS', 'CEIL_VARIANTS', 'main']

_Q128 = (('constexpr int kWarps16 = 4;', 'constexpr int kWarps16 = 8;'),)
_BLOCKS = '  return DPAD <= 64 ? 4 : 2;\n}'
_CEIL_BLOCKS = '  return DPAD <= 64 ? (V == kMaxExp ? 3 : 4) : 2;\n}'
_MIN2 = ((_BLOCKS, '  return DPAD <= 64 ? 2 : 1;\n}'),)
_MIN1 = ((_BLOCKS, '  return 1;\n}'),)
FWD_VARIANTS = {
    'shipped': (),
    'b3': ((_BLOCKS, '  return DPAD <= 64 ? 3 : 2;\n}'),),
    'q128': _Q128 + _MIN1,
    'q128_b2': _Q128 + _MIN2,
}
BWD_VARIANTS = {
    'shipped': (),
    'b1': (('(DPAD <= 64 ? 2 : 1)>', '1>'),),
}
CEIL_VARIANTS = {
    'shipped': (),
    'maxexp_b4': ((_CEIL_BLOCKS, '  return DPAD <= 64 ? 4 : 2;\n}'),),
}
# (B, H, T, D, bq, bk, calls a graph) of the ceiling kernel's timings:
# the AMP training shape, then the probe's default
CEIL_SHAPES = ((32, 8, 512, 64, 64, 64, 20), (16, 8, 8192, 64, 1024, 1024, 5))
SEED = 22
# kernel vs plain version: one 16-bit ulp of an O(1) value, as
# chip_smoke.py's TOL_BF16_O / TOL_F16_O and TOL_BWD_BF16 / TOL_BWD_F16
TOL = {torch.bfloat16: 3.2e-2, torch.float16: 3.91e-3}


def _resources(log, kernel):
    """{instance: 'N registers | spill line'} of ``kernel``'s 16-bit
    instances from ptxas's -v output, an instance named by its type and
    its integer template arguments (DPAD; #11's variant after it)."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        if 'Compiling entry function' not in line or kernel not in line:
            continue
        m = re.search(kernel + r'I(13__nv_bfloat16|6__half)((?:Li\d+E)+)',
                      line)
        if not m:
            continue
        follow = lines[i + 1:i + 4]
        regs = next((x.split('info    : ')[-1] for x in follow
                     if 'registers' in x), '')
        spill = next((x.strip() for x in follow if 'spill' in x), '')
        out['_'.join([m.group(1).lstrip('0123456789')] +
                     re.findall(r'\d+', m.group(2)))] = (
            '%s | %s' % (regs, spill))
    return out


def _max_err(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _card():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip()


def ceiling():
    """The ``--ceiling`` probe: #11's bf16 launch bounds (module
    docstring)."""
    libs, logs = build.build_variants('flash_ceiling', CEIL_VARIANTS)
    shapes = []
    for b, h, t, d, bq, bk, calls in CEIL_SHAPES:
        q, k, v = probe_inputs(b * h, t, d, torch.bfloat16)
        shapes.append(('T%d_%dx%d' % (t, bq, bk), q, k, v, bq, bk, calls))
    res = {name: dict(source='flash_ceiling', variant=name,
                      ptxas=_resources(logs[name], 'flash_ceiling_kernel'))
           for name in CEIL_VARIANTS}
    order = list(CEIL_VARIANTS) + list(reversed(list(CEIL_VARIANTS)))
    shipped = build._libs.get('flash_ceiling')
    checked = set()
    try:
        for name in order:
            build._libs['flash_ceiling'] = libs[name]
            r = res[name]
            for key, q, k, v, bq, bk, calls in shapes:
                for variant in ('mm', 'maxexp'):
                    def call():
                        return fc.flash_ceiling(q, k, v, variant, bq, bk)
                    # checked once a build, at the AMP training shape
                    if key == shapes[0][0] and name not in checked:
                        got = call().float()
                        ref = fc._plain_ceiling(q, k, v, variant, bq,
                                                bk).float()
                        rel = float((got - ref).norm() / ref.norm())
                        r[variant + '_norm_rel'] = rel
                        r[variant + '_ok'] = rel <= fc.tolerance(
                            torch.bfloat16, variant, bk)
                    r.setdefault('%s_%s_ms' % (key, variant), []).append(
                        device_ms(call, iters=calls))
            checked.add(name)
    finally:
        if shipped is None:
            build._libs.pop('flash_ceiling', None)
        else:
            build._libs['flash_ceiling'] = shipped
    for name in CEIL_VARIANTS:
        print(json.dumps(res[name]), flush=True)
    print(_card())


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv == ['--ceiling']:
        return ceiling()
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cases = {}
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, do = (torch.randn((256, 512, 64), generator=gen,
                                   device='cuda').to(dtype)
                       for _ in range(4))
        scale = 64 ** -0.5
        o, lse = fa._plain_forward(q, k, v, True, scale)
        di = (do.float() * o.float()).sum(-1).contiguous()
        args = (q, k, v, lse, do, di, True, scale)
        cases[dtype] = (args, (o, lse), fa._plain_backward(*args))
    runs = (('flash_attention_fwd', FWD_VARIANTS, 'fa_fwd_kernel'),
            ('flash_attention_bwd', BWD_VARIANTS, 'fa_bwd_kernel'))
    built = {src: build.build_variants(src, variants)
             for src, variants, _ in runs}
    for src, variants, kernel in runs:
        libs, logs = built[src]
        order = list(variants) + list(reversed(list(variants)))
        shipped = build._libs.get(src)
        res = {name: dict(source=src, variant=name,
                          ptxas=_resources(logs[name], kernel))
               for name in variants}
        try:
            for name in order:
                build._libs[src] = libs[name]
                for dtype, (args, fwd_ref, bwd_ref) in cases.items():
                    key = str(dtype).replace('torch.', '')
                    if src == 'flash_attention_fwd':
                        def call():
                            return fa._fa_forward(*args[:3], True, args[7])
                        got = call()
                        err = _max_err(got[:1], fwd_ref[:1])
                        # lse against chip_smoke.py's TOL_F32
                        ok = float((got[1] - fwd_ref[1]).abs().max()) <= 1e-4
                    else:
                        def call():
                            return fa._fa_backward_fused(*args)
                        got = call()
                        err = _max_err(got, bwd_ref)
                        ok = True
                    ok &= err <= TOL[dtype] and all(
                        bool(torch.isfinite(x).all()) for x in got)
                    r = res[name]
                    r[key + '_err'] = max(r.get(key + '_err', 0.0), err)
                    r[key + '_ok'] = r.get(key + '_ok', True) and ok
                    r.setdefault(key + '_ms', []).append(device_ms(call))
        finally:
            if shipped is None:
                build._libs.pop(src, None)
            else:
                build._libs[src] = shipped
        for name in variants:
            print(json.dumps(res[name]), flush=True)
    print(_card())


if __name__ == '__main__':
    main()

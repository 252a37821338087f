"""The flash inner-loop ceiling probe on the card.

    python3 -m paddle_tpu_torch.ops.kernels.flash_ceiling_probe \\
        [--B 16 --T 8192 --H 8 --D 64 --bq 1024 --bk 1024 --steps 10]
        [--dtype bfloat16|float32]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
The port of benchmarks/exp_flash_ceiling.py: the same flags, inputs
(seeded normals, q and k times 0.1, :87-93, in bfloat16, the TPU
probe's type, unless ``--dtype float32``) and JSON.  It builds
``csrc/flash_ceiling.cu`` and the flash forward (#1), times each variant
of the probe's kernel (mm, mmT, exp, maxexp: ops/kernels/
flash_ceiling.py) and ``full``, #1 itself at the same shape (causal, at
its own 64 x 64 tiles, scale 1 / sqrt(D)), in device time: a CUDA graph
of ``--steps`` calls replayed between CUDA events.  It prints one JSON
object, per variant ``ms`` and ``executed_tflops`` (the probe's
``executed``, 4 * D flops per pair of the live logical tiles, :95-97,
over ``ms``; for ``full`` also ``live_pair_tflops``, #1's own causal
pairs over its ``ms``), then the card's name and power limit.  The
variants run #1's engine for the type (float32: 3xTF32; bfloat16: its
16-bit engine) and differ from #1 only in their tails, so the gaps
between them split #1's time into its stages: the two products, exp,
the row max.
"""
import argparse
import json
import subprocess

import numpy as np
import torch

from . import flash_attention as fa
from . import flash_ceiling as fc
from .table_update_probe import device_ms

__all__ = ['probe_inputs', 'run', 'main']


def probe_inputs(bh, t, d, dtype):
    """The probe's q, k, v [BH, T, D] (exp_flash_ceiling.py:89-93):
    ``default_rng(0)`` normals, q and k times 0.1, in ``dtype`` on the
    card."""
    rng = np.random.default_rng(0)
    out = []
    for mul in (0.1, 0.1, 1.0):
        x = (rng.normal(size=(bh, t, d)) * mul).astype(np.float32)
        out.append(torch.from_numpy(x).to(device='cuda', dtype=dtype))
    return out


def run(B=16, T=8192, H=8, D=64, bq=1024, bk=1024, steps=10,
        dtype=torch.bfloat16, inputs=None):
    """{variant: {'ms', 'executed_tflops'}, 'full': {...}, 'config': ...}
    at the probe's shape, in device time on the card.  ``inputs`` (q, k,
    v) replaces the probe's own."""
    bh = B * H
    q, k, v = inputs if inputs is not None else probe_inputs(
        bh, T, D, dtype)
    k_t = k.transpose(1, 2).contiguous()   # [BH, D, T] for mmT
    executed = fc.executed_flops(bh, T, D, bq, bk)
    out = {}
    for variant in fc.VARIANTS:
        karg = k_t if variant == 'mmT' else k
        ms = device_ms(lambda: fc.flash_ceiling(q, karg, v, variant, bq, bk),
                       iters=steps)
        out[variant] = {'ms': ms,
                        'executed_tflops': executed / (ms * 1e-3) / 1e12}
    ms = device_ms(lambda: fa._fa_forward(q, k, v, True, D ** -0.5),
                   iters=steps)
    pairs = 4 * D * bh * T * (T + 1) / 2
    out['full'] = {'ms': ms,
                   'executed_tflops': executed / (ms * 1e-3) / 1e12,
                   'live_pair_tflops': pairs / (ms * 1e-3) / 1e12}
    out['config'] = dict(B=B, T=T, H=H, D=D, bq=bq, bk=bk, steps=steps,
                         dtype=str(q.dtype).replace('torch.', ''),
                         live_tiles=fc.live_tiles(T, bq, bk),
                         tiles=(T // bq) * (T // bk), executed=executed)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--B', type=int, default=16)
    ap.add_argument('--T', type=int, default=8192)
    ap.add_argument('--H', type=int, default=8)
    ap.add_argument('--D', type=int, default=64)
    ap.add_argument('--bq', type=int, default=1024)
    ap.add_argument('--bk', type=int, default=1024)
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    default='bfloat16')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ceiling_probe: torch sees no CUDA device; "
                         "the probe times the card")
    out = run(args.B, args.T, args.H, args.D, args.bq, args.bk, args.steps,
              getattr(torch, args.dtype))
    print(json.dumps(out))
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return out


if __name__ == '__main__':
    main()

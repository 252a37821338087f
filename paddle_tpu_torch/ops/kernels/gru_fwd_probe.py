"""Design probe of the GRU forward kernel (#9) on the card.

    python3 -m paddle_tpu_torch.ops.kernels.gru_fwd_probe [--parent DIR]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds variants of ``csrc/gru_fwd.cu`` into ``build/kernels/probe/``
(one nvcc each, all started together; ptxas's registers and spills of
every kernel function printed) and runs each:

- against ``_plain_gru_forward`` at chip_smoke.py phase 18's shapes (the
  seq2seq translator's T=64 B=512 H=512 with and without h0, H=256 (a
  cluster of 8), T=16 B=64 H=1024 (the wide path) and B=13 T=33 H=512):
  hs and the gates within 1e-4, two calls bitwise equal, the no-gates
  call's hs bitwise equal to the gated call's, and whether the outputs
  equal the shipped variant's bitwise (``bitwise_vs_shipped``: the
  parent's show whether a change left #9's arithmetic as it was);
- timed at the seq2seq shape with h0 and the gates, in device time (a
  CUDA graph of 10 calls replayed between CUDA events), in ROUNDS rounds
  that time every variant once, in turns whose order reverses every other
  round (``ms_rounds``; ``ms`` is their median).

Variants: the shipped kernel (the cluster chain's products in 3xTF32 on
the tensor cores, phase (a)'s update and reset products on a walk of the
h slices each, peers' slices read from L2, each step's x read after phase
(a)'s products); its products on the CUDA cores (``chain_cuda_cores``);
peers' slices read through DSMEM (``exchange_dsmem``); phase (a)'s two
products on one walk that loads and splits each A fragment once
(``shared_a``); each step's x loaded a step ahead, during phase (b)
(``x_prefetched``); and, with ``--parent
DIR``, ``DIR/paddle_tpu_torch/csrc/gru_fwd.cu`` as it stands
(``parent``: a checkout of an earlier tree, e.g. the row-tiled loop on
every width), called through the wrapper where its C interface is the
shipped one, else through the row-tiled kernel's, which takes no
workspace.  Prints the plain version's time, one JSON line per variant
(``ok``: every check within its bound), then the card's name and power
limit.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess

import torch

from . import build
from . import gru as gk
from .gru_bwd_probe import resources
from .table_update_probe import device_ms

__all__ = ['VARIANTS', 'CASES', 'main']

_SOURCE = 'gru_fwd'
# name -> (old text, new text) substitutions of the shipped source
VARIANTS = {
    'shipped': (),
    'chain_cuda_cores': (
        ('constexpr bool kChainOnTensorCores = true;',
         'constexpr bool kChainOnTensorCores = false;'),),
    # peers' slices read through DSMEM instead of from L2
    'exchange_dsmem': (('constexpr bool kSlicesThroughL2 = true;',
                        'constexpr bool kSlicesThroughL2 = false;'),),
    # the update's and the reset's products on one walk of the slices
    # that loads and splits each A fragment once
    'shared_a': (('constexpr bool kSharedA = false;',
                  'constexpr bool kSharedA = true;'),),
    # each step's x loaded a step ahead, during phase (b)
    'x_prefetched': (('constexpr bool kPrefetchX = false;',
                      'constexpr bool kPrefetchX = true;'),),
}
SEED = 11
TOL = 1e-4
ROUNDS = 4
CASES = (
    # name, T, B, H, h0
    ('seq2seq_T64_B512_H512_h0', 64, 512, 512, True),
    ('T64_B512_H512', 64, 512, 512, False),
    ('T64_B512_H256_h0', 64, 512, 256, True),
    ('wide_T16_B64_H1024_h0', 16, 64, 1024, True),
    ('B13_T33_H512_h0', 33, 13, 512, True),
)
MAIN = CASES[0][0]


def _parent_forward(lib, x, w, h0, with_gates, rows=gk.ROWS_PER_BLOCK):
    """(hs, gates or None) from an earlier tree's ``paddle_gru_fwd``,
    whose C interface takes no workspace: x, w, h0, hs, gates, T, B, H,
    rows, stream."""
    fn = lib.paddle_gru_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    t, b, three_h = x.shape
    h = three_h // 3
    hs = torch.empty((t, b, h), dtype=torch.float32, device=x.device)
    gates = torch.empty_like(x) if with_gates else None
    err = fn(x.data_ptr(), w.data_ptr(), gk._ptr(h0), hs.data_ptr(),
             gk._ptr(gates), t, b, h, rows,
             torch.cuda.current_stream().cuda_stream)
    gk._launch_check(lib, err, 'parent gru_fwd')
    return hs, gates


def _inputs(gen, t, b, h, with_h0):
    """Seeded x, w (and h0) on the card and the plain forward's (hs,
    gates) on them."""
    x = torch.randn((t, b, 3 * h), generator=gen, device='cuda')
    w = torch.randn((h, 3 * h), generator=gen, device='cuda') * h ** -0.5
    h0 = (torch.randn((b, h), generator=gen, device='cuda') * 0.5
          if with_h0 else None)
    args = (x, w, h0)
    return args, gk._plain_gru_forward(*args)


def _check(fwd, args, want, shipped_out=None):
    """One case's checks and the outputs; ``bitwise_vs_shipped`` holds
    them against the shipped variant's (``shipped_out``)."""
    got = fwd(*args, True)
    again = fwd(*args, True)
    bare = fwd(*args, False)
    torch.cuda.synchronize()
    errs = {k: float((a - r).abs().max())
            for k, a, r in zip(('hs', 'gates'), got, want)}
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    same = shipped_out is None or all(
        torch.equal(a, b) for a, b in zip(got, shipped_out))
    no_gates = bare[1] is None and torch.equal(bare[0], got[0])
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = (finite and bitwise and no_gates and
          all(e <= TOL for e in errs.values()))
    return dict(errs=errs, tol=TOL, bitwise_repeat=bitwise,
                no_gates_hs_bitwise=no_gates, ok=ok,
                bitwise_vs_shipped=same), got


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', help="a checkout whose "
                    "paddle_tpu_torch/csrc/gru_fwd.cu is built as it "
                    "stands, as the variant 'parent'")
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cases = [(c[0], _inputs(gen, *c[1:])) for c in CASES]
    main_args = cases[0][1][0]
    print(json.dumps(dict(plain_ms=device_ms(
        lambda: gk._plain_gru_forward(*main_args), iters=2, replays=2),
        shape=MAIN)), flush=True)
    sources = None
    if opts.parent:
        sources = {'parent': os.path.join(
            opts.parent, 'paddle_tpu_torch', 'csrc', _SOURCE + '.cu')}
    libs, logs = build.build_variants(_SOURCE, VARIANTS, sources)
    shipped = build._libs.get(_SOURCE)
    counts = (gk.launches, gk.fwd_cluster_launches)

    def use(name):
        """The forward of variant ``name``, its library put in place."""
        lib = libs[name]
        if name == 'parent' and not hasattr(
                lib, 'paddle_gru_fwd_workspace_bytes'):
            return lambda x, w, h0, with_gates: _parent_forward(
                lib, x, w, h0, with_gates)
        build._libs[_SOURCE] = lib
        return gk._gru_forward
    try:
        results = {}
        shipped_outs = {}   # case -> the shipped variant's outputs
        for name in libs:
            fwd = use(name)
            res = results[name] = dict(variant=name,
                                       ptxas=resources(logs[name]))
            for case, (args, want) in cases:
                res[case], out = _check(fwd, args, want,
                                        shipped_outs.get(case))
                shipped_outs.setdefault(case, out)
            res['ok'] = all(res[c[0]]['ok'] for c in CASES)
            if name == 'shipped':
                res['plan'] = {c[0]: gk.fwd_plan(*c[1:4]) for c in CASES}
            res['ms_rounds'] = []
        names = list(libs)
        for r in range(ROUNDS):
            for name in names if r % 2 == 0 else names[::-1]:
                fwd = use(name)
                results[name]['ms_rounds'].append(device_ms(
                    lambda: fwd(*main_args, True), iters=10, replays=3))
        for res in results.values():
            res['ms'] = statistics.median(res['ms_rounds'])
            print(json.dumps(res), flush=True)
    finally:
        gk.launches, gk.fwd_cluster_launches = counts
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

"""Design probe of the LSTM forward kernel (#7) on the card.

    python3 -m paddle_tpu_torch.ops.kernels.lstm_fwd_probe [--parent DIR]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds variants of ``csrc/lstm_fwd.cu`` into ``build/kernels/probe/``
(one nvcc each, all started together; ptxas's registers and spills of
every kernel function printed) and runs each through ``_lstm_forward``:

- against ``_plain_lstm_forward`` at chip_smoke.py phase 13's shapes
  (``LSTM_CASES``: the LM's T=128 B=256 H=256, the sentiment net's T=120
  B=32 H=128, no peepholes, B=13, H=32 (a cluster of one block), H=100
  (units past H within a block), the cluster's cap H=416 and the first
  width past it, H=420): hs, cs and the gates within 1e-4, two calls
  bitwise equal, the no-gates call's hs and cs bitwise equal to the gated
  call's, and whether the outputs equal the shipped variant's bitwise
  (``bitwise_vs_shipped``);
- timed at the LM's shape with the gates, in device time (a CUDA graph of
  10 calls replayed between CUDA events), in ROUNDS rounds that time every
  variant once, in turns whose order reverses every other round
  (``ms_rounds``; ``ms`` is their median).

Variants, each named by its settings of the cluster path's knobs
(csrc/lstm_fwd.cu): the shipped kernel (each warp one gate's 16 x 32
tile of an m-tile over half of the h slices, two 16-row m-tiles a
cluster at most); each warp a gate over all the slices (``shares1``);
one m-tile a cluster at most (``mt1``); peers' slices read through DSMEM
(``dsmem``); the products on the CUDA cores (``chain_cuda_cores``); the
row-tiled loop, the kernel's first design, on every width
(``row_tiled``: the cluster rule's cap set to 0); and, with ``--parent
DIR``,
``DIR/paddle_tpu_torch/csrc/lstm_fwd.cu`` as it stands (``parent``: a
checkout of an earlier tree), called through the wrapper where its C
interface is the shipped one, else through the row-tiled kernel's, which
takes no workspace.  Designs measured and removed from the source (all
four gates a warp over K shares; a warp walking both m-tiles) are in
PERF.md's record.  Prints the plain version's time, one JSON line per
variant (``ok``: every check within its bound), then the card's name and
power limit.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess

import torch

from . import build
from . import lstm as lk
from .gru_bwd_probe import resources
from .lstm_bwd_probe import constexpr_subs
from .table_update_probe import device_ms

__all__ = ['VARIANTS', 'CASES', 'knobs', 'row_tiled_library', 'main']

_SOURCE = 'lstm_fwd'
# the cluster path's knobs: name -> (its constexpr's type, name)
_KNOBS = dict(shares=('int', 'kShares'), max_mt=('int', 'kChainMaxMTiles'),
              l2=('bool', 'kSlicesThroughL2'),
              tc=('bool', 'kChainOnTensorCores'),
              max_blocks=('int', 'kChainMaxBlocks'))


def knobs(text, **values):
    """Substitutions of the shipped source ``text`` setting each knob to a
    value."""
    return constexpr_subs(text, _KNOBS, values)


# name -> the knobs it sets on the shipped source
VARIANTS = {
    'shipped': {},
    'shares1': dict(shares=1),
    'mt1': dict(max_mt=1),
    'dsmem': dict(l2=False),
    'chain_cuda_cores': dict(tc=False),
    'row_tiled': dict(max_blocks=0),
}
SEED = 13
TOL = 1e-4
ROUNDS = 4
CASES = (
    # name, T, B, H, peepholes (chip_smoke.py LSTM_CASES)
    ('lm_T128_B256_H256', 128, 256, 256, True),
    ('sentiment_T120_B32_H128', 120, 32, 128, True),
    ('no_peepholes_T64_B64_H256', 64, 64, 256, False),
    ('B13_T33_H256', 33, 13, 256, True),
    ('H32_T12_B5', 12, 5, 32, True),
    ('H100_T20_B40', 20, 40, 100, True),
    ('B13_T33_H128', 33, 13, 128, True),
    ('cap_T16_B64_H416', 16, 64, 416, True),
    ('wide_T16_B64_H420', 16, 64, 420, True),
)
MAIN = CASES[0][0]


def _source():
    with open(os.path.join(build.CSRC_DIR, _SOURCE + '.cu')) as f:
        return f.read()


def row_tiled_library():
    """The ctypes library of ``csrc/lstm_fwd.cu`` with its cluster path
    switched off (variant ``row_tiled``): the row-tiled loop, the
    kernel's first design and now its wide path, on every width, built
    into ``build/kernels/probe/``."""
    libs, _ = build.build_variants(
        _SOURCE, {'row_tiled': knobs(_source(), **VARIANTS['row_tiled'])})
    return libs['row_tiled']


def _parent_forward(lib, x, w, pw, with_gates):
    """(hs, cs, gates or None) from an earlier tree's ``paddle_lstm_fwd``,
    whose C interface takes no workspace: x, w, pw, hs, cs, gates, T, B,
    H, stream."""
    fn = lib.paddle_lstm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i, i, i, p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    t, b, four_h = x.shape
    h = four_h // 4
    hs = torch.empty((t, b, h), dtype=torch.float32, device=x.device)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(x) if with_gates else None
    err = fn(x.data_ptr(), w.data_ptr(), pw.data_ptr(), hs.data_ptr(),
             cs.data_ptr(), None if gates is None else gates.data_ptr(), t,
             b, h, torch.cuda.current_stream().cuda_stream)
    lk._launch_check(lib, err, 'parent lstm_fwd')
    return hs, cs, gates


def _inputs(gen, t, b, h, peepholes):
    """Seeded x, w and pw on the card and the plain forward's (hs, cs,
    gates) on them."""
    x = torch.randn((t, b, 4 * h), generator=gen, device='cuda')
    w = torch.randn((h, 4 * h), generator=gen, device='cuda') * h ** -0.5
    pw = (torch.randn((3, h), generator=gen, device='cuda') * 0.3
          if peepholes else torch.zeros((3, h), device='cuda'))
    args = (x, w, pw)
    return args, lk._plain_lstm_forward(*args)


def _check(fwd, args, want, shipped_out=None):
    """One case's checks and the outputs; ``bitwise_vs_shipped`` holds
    them against the shipped variant's (``shipped_out``)."""
    got = fwd(*args, True)
    again = fwd(*args, True)
    bare = fwd(*args, False)
    torch.cuda.synchronize()
    errs = {k: float((a - r).abs().max())
            for k, a, r in zip(('hs', 'cs', 'gates'), got, want)}
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    same = shipped_out is None or all(
        torch.equal(a, b) for a, b in zip(got, shipped_out))
    no_gates = bare[2] is None and all(
        torch.equal(a, b) for a, b in zip(bare[:2], got[:2]))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = (finite and bitwise and no_gates and
          all(e <= TOL for e in errs.values()))
    return dict(errs=errs, tol=TOL, bitwise_repeat=bitwise,
                no_gates_bitwise=no_gates, ok=ok,
                bitwise_vs_shipped=same), got


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', help="a checkout whose "
                    "paddle_tpu_torch/csrc/lstm_fwd.cu is built as it "
                    "stands, as the variant 'parent'")
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cases = [(c[0], _inputs(gen, *c[1:])) for c in CASES]
    main_args = cases[0][1][0]
    print(json.dumps(dict(plain_ms=device_ms(
        lambda: lk._plain_lstm_forward(*main_args), iters=2, replays=2),
        shape=MAIN)), flush=True)
    sources = None
    if opts.parent:
        sources = {'parent': os.path.join(
            opts.parent, 'paddle_tpu_torch', 'csrc', _SOURCE + '.cu')}
    text = _source()
    subs = {k: knobs(text, **v) for k, v in VARIANTS.items()}
    libs, logs = build.build_variants(_SOURCE, subs, sources)
    shipped = build._libs.get(_SOURCE)
    counts = (lk.launches, lk.fwd_cluster_launches)

    def use(name):
        """The forward of variant ``name``, its library put in place."""
        lib = libs[name]
        if name == 'parent' and not hasattr(
                lib, 'paddle_lstm_fwd_workspace_bytes'):
            return lambda x, w, pw, with_gates: _parent_forward(
                lib, x, w, pw, with_gates)
        build._libs[_SOURCE] = lib
        return lk._lstm_forward
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
            if name != 'parent':
                res['plan'] = {c[0]: lk.fwd_plan(*c[1:4]) for c in CASES}
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
        lk.launches, lk.fwd_cluster_launches = counts
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

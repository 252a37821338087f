"""Design probe of the LSTM BPTT kernel (#8) on the card.

    python3 -m paddle_tpu_torch.ops.kernels.lstm_bwd_probe [--parent DIR]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds variants of ``csrc/lstm_bwd.cu`` into ``build/kernels/probe/``
(one nvcc each, all started together; ptxas's registers and spills of
every kernel function printed) and runs each through ``_lstm_backward``:

- against ``_plain_lstm_backward`` at the LM's shape (T=128 B=256 H=256,
  no cell cotangent), the sentiment net's (T=120 B=32 H=128), H=100
  (units past H within a block) at B=13, H=32 (a cluster of one block),
  the cluster's cap (H=416) and the first width past it (H=420, the wide
  path): dx within 1e-4, dW and dpw within 1e-5 of their largest entry
  (chip_smoke.py phase 13's bounds), two calls bitwise equal, and
  whether the outputs equal the shipped variant's bitwise
  (``bitwise_vs_shipped``: the parent's show whether a change left #8's
  arithmetic as it was);
- timed at the LM's shape in device time (a CUDA graph of 10 calls
  replayed between CUDA events), in ROUNDS rounds that time every variant
  once, in turns whose order reverses every other round (``ms_rounds``;
  ``ms`` is their median), and one call's device time split by kernel
  function (torch.profiler over 5 calls): the chain, dW, the finish and
  the wide path's transpose.

Variants, each named by its settings of the cluster path's knobs
(csrc/lstm_bwd.cu): warps an m-tile takes (``shares8``: K in eight
shares; ``shares4``; ``halves``: the GRU kernels' K halves), the m-tiles
a cluster takes at most (``mt1``, ``mt2``: one or two 16-row m-tiles),
peers' slices read through DSMEM (``dsmem_*``, at most four shares:
share_reduce then needs the step's own slices), the chain's products on
the CUDA cores (``chain_cuda_cores``), the cheaper 3xTF32 split of
gru_cluster.cuh split_tf32 in the chain or in dW (``chain_split_1``,
``dw_split_1``); diagnostics that are not right, whose times split
the chain's step (``diag_*``, as gru_bwd_probe.py's: every slice read
from the block's own shared memory, the exchange without products,
neither, that without the cluster barriers); and, with ``--parent DIR``,
``DIR/paddle_tpu_torch/csrc/lstm_bwd.cu`` as it stands (``parent``: a
checkout of an earlier tree, e.g. the row-tiled chain and SIMT dW on
every width), built and called through the same wrapper, whose C
interface it shares.  Prints the plain version's time, one JSON line per
variant (``ok``: every check within its bound; absent for a diagnostic),
then the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess

import torch

from . import build
from . import lstm as lk
from .gru_bwd_probe import HEADER_VARIANTS, header_variant, resources, \
    split_ms
from .table_update_probe import device_ms

__all__ = ['VARIANTS', 'CASES', 'constexpr_subs', 'main']

_SOURCE = 'lstm_bwd'
# the cluster path's knobs: name -> (its constexpr's type, name)
_KNOBS = dict(shares=('int', 'kShares'), max_mt=('int', 'kChainMaxMTiles'),
              l2=('bool', 'kSlicesThroughL2'),
              tc=('bool', 'kChainOnTensorCores'),
              chain_split=('int', 'kChainSplit'), dw_split=('int', 'kDwSplit'))


def constexpr_subs(text, table, values):
    """Substitutions of the source ``text`` setting each knob of
    ``values`` (a key of ``table``: key -> (its constexpr's type, name))
    to its value."""
    subs = []
    for key, value in values.items():
        kind, name = table[key]
        old = re.search(r'constexpr %s %s =\s[^;]+;' % (kind, name), text)
        new = 'constexpr %s %s = %s;' % (
            kind, name, str(value).lower() if kind == 'bool' else value)
        subs.append((old.group(0), new))
    return tuple(subs)


def knobs(text, **values):
    """Substitutions of the shipped source ``text`` setting each knob to a
    value."""
    return constexpr_subs(text, _KNOBS, values)


# name -> the knobs it sets on the shipped source
VARIANTS = {
    'shipped': {},
    'shares8_mt2': dict(shares=8, max_mt=2),
    'shares8_mt1': dict(shares=8, max_mt=1),
    'shares4_mt2': dict(shares=4, max_mt=2),
    'shares4_mt1': dict(shares=4, max_mt=1),
    'halves_mt2': dict(shares=2, max_mt=2),
    'dsmem_shares4_mt2': dict(shares=4, max_mt=2, l2=False),
    'chain_cuda_cores': dict(tc=False),
    'chain_split_1': dict(chain_split=1),
    'dw_split_1': dict(dw_split=1),
}
# diagnostics of the chain, none of them right, whose times split a step:
# csrc/gru_cluster.cuh edited as for #10 (gru_bwd_probe.py): every slice
# read from the block's own shared memory (no exchange), the exchange
# without products, neither, and that without the cluster barriers
DIAGNOSTICS = ('diag_local_slices', 'diag_no_products',
               'diag_local_no_products', 'diag_local_no_products_no_barriers')
SEED = 12
TOL = 1e-4
TOL_PARAM_REL = 1e-5
ROUNDS = 4
CASES = (
    # name, T, B, H, cotangent of the cells
    ('lm_T128_B256_H256', 128, 256, 256, False),
    ('sentiment_T120_B32_H128', 120, 32, 128, True),
    ('B13_T33_H100', 33, 13, 100, True),
    ('B5_T12_H32', 12, 5, 32, False),
    ('cap_T16_B64_H416', 16, 64, 416, True),
    ('wide_T16_B64_H420', 16, 64, 420, True),
)
MAIN = CASES[0][0]
# kernel function -> part of the call it times
PARTS = (('lstm_chain_kernel', 'chain'), ('lstm_bptt_kernel', 'chain'),
         ('lstm_bwd_finish_kernel', 'finish'), ('lstm_dw_tc_kernel', 'dw'),
         ('lstm_dw_kernel', 'dw'), ('transpose_kernel', 'transpose'))


def _inputs(gen, t, b, h, with_ct_c):
    """The backward's arguments from the plain forward on seeded x, w and
    pw, and the plain backward's outputs on them."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device='cuda') * scale
    x, w, pw = rnd(t, b, 4 * h), rnd(h, 4 * h, scale=h ** -0.5), rnd(
        3, h, scale=0.3)
    args = (w, pw) + tuple(lk._plain_lstm_forward(x, w, pw)) + (
        rnd(t, b, h), rnd(t, b, h) if with_ct_c else None)
    return args, lk._plain_lstm_backward(*args)


def _check(args, want, shipped_out=None):
    """One case's checks and the outputs; ``bitwise_vs_shipped`` holds
    them against the shipped variant's (``shipped_out``)."""
    got = lk._lstm_backward(*args)
    again = lk._lstm_backward(*args)
    torch.cuda.synchronize()
    names = ('dx', 'dw', 'dpw')
    errs = {k: float((a - r).abs().max()) for k, a, r in zip(names, got,
                                                              want)}
    tols = dict(dx=TOL, **{k: TOL_PARAM_REL * max(1.0, float(r.abs().max()))
                           for k, r in zip(names[1:], want[1:])})
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    same = shipped_out is None or all(
        torch.equal(a, b) for a, b in zip(got, shipped_out))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = finite and bitwise and all(errs[k] <= tols[k] for k in errs)
    return dict(errs=errs, tols=tols, bitwise_repeat=bitwise, ok=ok,
                bitwise_vs_shipped=same), got


def _declare(lib):
    """The C interface's types, for a library that may lack the plan and
    rule functions (the parent)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paddle_lstm_bwd.argtypes = [p] * 11 + [i, i, i, p]
    lib.paddle_lstm_bwd.restype = i
    lib.paddle_lstm_bwd_workspace_bytes.argtypes = [i, i, i]
    lib.paddle_lstm_bwd_workspace_bytes.restype = ctypes.c_int64
    lib.paddle_cuda_error_string.argtypes = [i]
    lib.paddle_cuda_error_string.restype = ctypes.c_char_p


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', help="a checkout whose "
                    "paddle_tpu_torch/csrc/lstm_bwd.cu is built as it "
                    "stands, as the variant 'parent'")
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cases = [(c[0], _inputs(gen, *c[1:])) for c in CASES]
    main_args = cases[0][1][0]
    print(json.dumps(dict(plain_ms=device_ms(
        lambda: lk._plain_lstm_backward(*main_args), iters=2, replays=2),
        shape=MAIN)), flush=True)
    sources = None
    if opts.parent:
        sources = {'parent': os.path.join(
            opts.parent, 'paddle_tpu_torch', 'csrc', _SOURCE + '.cu')}
    with open(os.path.join(build.CSRC_DIR, _SOURCE + '.cu')) as f:
        text = f.read()
    subs = {k: knobs(text, **v) for k, v in VARIANTS.items()}
    subs.update({k: header_variant((), HEADER_VARIANTS[k][1])
                 for k in DIAGNOSTICS})
    libs, logs = build.build_variants(_SOURCE, subs, sources)
    shipped = build._libs.get(_SOURCE)
    counts = (lk.bwd_launches, lk.bwd_cluster_launches)

    def bwd():
        return lk._lstm_backward(*main_args)
    try:
        results = {}
        shipped_outs = {}   # case -> the shipped variant's outputs
        for name, lib in libs.items():
            if name == 'parent':
                _declare(lib)
            build._libs[_SOURCE] = lib
            res = results[name] = dict(variant=name,
                                       ptxas=resources(logs[name]))
            for case, (args, want) in cases:
                res[case], out = _check(args, want, shipped_outs.get(case))
                shipped_outs.setdefault(case, out)
            if not name.startswith('diag_'):
                res['ok'] = all(res[c[0]]['ok'] for c in CASES)
            if name != 'parent':
                res['plan'] = {c[0]: lk.bwd_plan(*c[1:4]) for c in CASES}
            res['ms_by_part'] = split_ms(bwd, parts=PARTS)
            res['ms_rounds'] = []
        names = list(libs)
        for r in range(ROUNDS):
            for name in names if r % 2 == 0 else names[::-1]:
                build._libs[_SOURCE] = libs[name]
                results[name]['ms_rounds'].append(device_ms(
                    bwd, iters=10, replays=3))
        for res in results.values():
            res['ms'] = statistics.median(res['ms_rounds'])
            print(json.dumps(res), flush=True)
    finally:
        lk.bwd_launches, lk.bwd_cluster_launches = counts
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

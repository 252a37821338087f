"""Design probe of the GRU BPTT kernel (#10) on the card.

    python3 -m paddle_tpu_torch.ops.kernels.gru_bwd_probe [--parent DIR]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds variants of ``csrc/gru_bwd.cu`` into ``build/kernels/probe/``
(one nvcc each, all started together; ptxas's registers and spills of
every kernel function printed) and runs each through ``_gru_backward``:

- against ``_plain_gru_backward`` at the seq2seq translator's shape
  (T=64 B=512 H=512 with h0), at H=256 (a cluster of 8), at a batch that
  is no multiple of 16 (B=13 T=33 H=512), at H=32 (a cluster of one
  block) without h0 or the cotangent, and at H=1024 (the wide path);
  dx and dh0 within 1e-4, dW within 1e-5 of its largest entry (phase
  18's bounds), two calls bitwise equal, and whether the outputs equal
  the shipped variant's bitwise (``bitwise_vs_shipped``: the parent's
  show whether a change left #10's arithmetic as it was);
- timed at the seq2seq shape in device time (a CUDA graph of 10 calls
  replayed between CUDA events), and one call's device time split by
  kernel function (torch.profiler over 5 calls): the chain, dW, dW's
  finish and the wide path's transpose.

Variants: the shipped kernel (the cluster chain's products in 3xTF32
on the tensor cores, peers' slices read from L2, dW on the tensor
cores); the cluster chain's products on the CUDA cores
(``chain_cuda_cores``); peers' slices read through DSMEM
(``exchange_dsmem``); a cheaper 3xTF32 split in the chain and in dW
(``chain_split_1``, ``dw_split_1``); diagnostics that are not right or
not float32 accurate, whose times split the chain's and dW's
(``diag_*``: every slice read from the block's own shared memory, the
exchange without products (from L2, through DSMEM), neither, that
without the cluster barriers;
dW with one plain TF32 product); and, with ``--parent DIR``,
``DIR/paddle_tpu_torch/csrc/gru_bwd.cu`` as it stands (``parent``: a
checkout of an earlier tree, e.g. the row-tiled chain and SIMT dW),
built and called through the same wrapper, whose C interface it shares.
The cluster's other exchange, a reduce-scatter of partial products to
each unit's owner, is not built: through DSMEM its inbox (16 peers x 80
rows x 32 units x 4 bytes = 160 KB a block) does not fit beside W's
192 KB slice, and through L2 it would write as many bytes as it saves
in reads, while the pull's exchange already hides behind the products.
Prints the plain version's time, one JSON line per variant (``ok``:
every check within its bound; absent for a diagnostic), then the card's
name and power limit.
"""
import argparse
import json
import os
import re
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import build
from . import gru as gk
from .table_update_probe import device_ms

__all__ = ['VARIANTS', 'CASES', 'main']

_SOURCE = 'gru_bwd'
_HEADER = 'gru_cluster.cuh'
# name -> (old text, new text) substitutions of the shipped source; a
# 'diag_' variant is not held to the plain version's bounds
VARIANTS = {
    'shipped': (),
    'chain_cuda_cores': (
        ('constexpr bool kChainOnTensorCores = true;',
         'constexpr bool kChainOnTensorCores = false;'),),
    # peers' slices read through DSMEM instead of from L2
    'exchange_dsmem': (('constexpr bool kSlicesThroughL2 = true;',
                        'constexpr bool kSlicesThroughL2 = false;'),),
    # a cheaper 3xTF32 split (gru_cluster.cuh split_tf32: the small part
    # truncated by the tensor core), in the chain and in dW
    'chain_split_1': (('constexpr int kChainSplit = 0;',
                       'constexpr int kChainSplit = 1;'),),
    'dw_split_1': (('constexpr int kDwSplit = 0;',
                    'constexpr int kDwSplit = 1;'),),
}
# name -> (substitutions of the source, of csrc/gru_cluster.cuh): the
# header's edited text takes the place of its #include.  Diagnostics of
# the chain, none of them right
_LOCAL = (('if (kL2 && peer != rank) {', 'if (false) {'),
          ('cluster.map_shared_rank(const_cast<float*>(buf) + part * sf,\n'
           '                                  peer)',
           '(const_cast<float*>(buf) + part * sf)'))
_NO_PRODUCTS = ('kstep<kTC, kSplit, kGroups>(p, cur[ks], w_s, ldw, '
                'col + ks * 8, gcols,\n' + ' ' * 34 + 'lane);',
                'p[0][0][0] += cur[ks].x + cur[ks].y + cur[ks].z + cur[ks].w;')
HEADER_VARIANTS = {
    # dW with one plain TF32 product of the big parts (not float32
    # accurate): its time says what the 3xTF32 splits and products cost
    'diag_dw_one_tf32': ((), (
        ('mma3_split(part[mi][ni], ab[mi], as[mi], bb0, bs0, bb1, bs1);',
         'flash_tf32::mma_tf32(part[mi][ni], ab[mi], bb0, bb1);'),)),
    # every slice read from the block's own shared memory: no exchange
    'diag_local_slices': ((), _LOCAL),
    # the exchange without products, from L2 and through DSMEM
    'diag_no_products': ((), (_NO_PRODUCTS,)),
    'diag_no_products_dsmem': (VARIANTS['exchange_dsmem'], (_NO_PRODUCTS,)),
    # neither: the barriers, the elementwise work and the global traffic
    'diag_local_no_products': ((), _LOCAL + (_NO_PRODUCTS,)),
    # that without the cluster barriers (a block barrier in their place)
    'diag_local_no_products_no_barriers': ((), _LOCAL + (
        _NO_PRODUCTS,
        ('asm volatile("barrier.cluster.arrive.release.aligned;\\n"\n'
         '               "barrier.cluster.wait.acquire.aligned;\\n" ::: '
         '"memory");', '__syncthreads();'))),
}


def header_variant(source_subs, subs):
    """``source_subs`` and the substitution of the source's #include of
    the cluster header by the header's text with ``subs`` applied."""
    with open(os.path.join(build.CSRC_DIR, _HEADER)) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError("%r is not in %s" % (old[:60], _HEADER))
        text = text.replace(old, new)
    return tuple(source_subs) + (('#include "%s"\n' % _HEADER,
                                  text + '\n'),)
SEED = 10
TOL = 1e-4
TOL_PARAM_REL = 1e-5
CASES = (
    # name, T, B, H, h0, cotangent
    ('seq2seq_T64_B512_H512_h0', 64, 512, 512, True, True),
    ('T64_B512_H256_h0', 64, 512, 256, True, True),
    ('B13_T33_H512_h0', 33, 13, 512, True, True),
    ('B5_T12_H32_no_h0_no_ct', 12, 5, 32, False, False),
    ('wide_T16_B64_H1024_h0', 16, 64, 1024, True, True),
)
MAIN = CASES[0][0]
# kernel function -> part of the call it times
PARTS = (('gru_chain_kernel', 'chain'), ('gru_bptt_kernel', 'chain'),
         ('gru_dw_finish_kernel', 'finish'), ('gru_dw_kernel', 'dw'),
         ('transpose_kernel', 'transpose'))


def resources(log):
    """{kernel function: 'N registers, ... | spill line'} from ptxas's -v
    output."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        if 'Compiling entry function' not in line:
            continue
        fn = re.search(r"\d+([a-z_0-9]+_kernel)(I[^E]*E)?", line)
        key = fn.group(1) + (fn.group(2) or '') if fn else line
        follow = lines[i + 1:i + 4]
        regs = next((x.split('info    : ')[-1] for x in follow
                     if 'registers' in x), '')
        spill = next((x.strip() for x in follow if 'spill' in x), '')
        out[key] = '%s | %s' % (regs, spill)
    return out


def split_ms(fn, calls=5, parts=PARTS):
    """{part: device ms per call} of ``fn`` by kernel function (``parts``:
    (function, part) pairs), from torch.profiler over ``calls`` calls after
    a warm-up: each function's device time over the launches the trace
    holds."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        part = next((p for k, p in parts if k in e.key), None)
        if part is not None:
            out[part] = out.get(part, 0.0) + \
                e.self_device_time_total / 1e3 / max(1, e.count)
    return out


def _inputs(gen, t, b, h, with_h0, with_ct):
    """The backward's arguments from the plain forward on seeded x, w
    (and h0), and the plain backward's outputs on them."""
    x = torch.randn((t, b, 3 * h), generator=gen, device='cuda')
    w = torch.randn((h, 3 * h), generator=gen, device='cuda') * h ** -0.5
    h0 = (torch.randn((b, h), generator=gen, device='cuda') * 0.5
          if with_h0 else None)
    ct = (torch.randn((t, b, h), generator=gen, device='cuda')
          if with_ct else None)
    hs, gates = gk._plain_gru_forward(x, w, h0)
    args = (w, h0, hs, gates, ct)
    return args, gk._plain_gru_backward(*args)


def _check(args, want, shipped_out=None):
    """One case's checks and the outputs; ``bitwise_vs_shipped`` holds
    them against the shipped variant's (``shipped_out``)."""
    got = gk._gru_backward(*args)
    again = gk._gru_backward(*args)
    torch.cuda.synchronize()
    errs = {k: float((a - r).abs().max())
            for k, a, r in zip(('dx', 'dw', 'dh0'), got, want)}
    tols = dict(dx=TOL, dh0=TOL, dw=TOL_PARAM_REL * max(
        1.0, float(want[1].abs().max())))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    same = shipped_out is None or all(
        torch.equal(a, b) for a, b in zip(got, shipped_out))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = finite and bitwise and all(errs[k] <= tols[k] for k in errs)
    return dict(errs=errs, tols=tols, bitwise_repeat=bitwise, ok=ok,
                bitwise_vs_shipped=same), got


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', help="a checkout whose "
                    "paddle_tpu_torch/csrc/gru_bwd.cu is built as it "
                    "stands, as the variant 'parent'")
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cases = [(c[0], _inputs(gen, *c[1:])) for c in CASES]
    main_args = cases[0][1][0]
    print(json.dumps(dict(plain_ms=device_ms(
        lambda: gk._plain_gru_backward(*main_args), iters=2, replays=2),
        shape=MAIN)), flush=True)
    sources = None
    if opts.parent:
        sources = {'parent': os.path.join(
            opts.parent, 'paddle_tpu_torch', 'csrc', _SOURCE + '.cu')}
    variants = dict(VARIANTS)
    variants.update({k: header_variant(*v)
                     for k, v in HEADER_VARIANTS.items()})
    libs, logs = build.build_variants(_SOURCE, variants, sources)
    shipped = build._libs.get(_SOURCE)
    counts = (gk.bwd_launches, gk.bwd_cluster_launches)
    shipped_outs = {}   # case -> the shipped variant's outputs
    try:
        for name, lib in libs.items():
            build._libs[_SOURCE] = lib
            res = dict(variant=name, ptxas=resources(logs[name]))
            ok = True
            for case, (args, want) in cases:
                res[case], out = _check(args, want, shipped_outs.get(case))
                shipped_outs.setdefault(case, out)
                ok &= res[case]['ok']
            res['ms'] = device_ms(lambda: gk._gru_backward(*main_args),
                                  iters=10, replays=3)
            res['ms_by_part'] = split_ms(
                lambda: gk._gru_backward(*main_args))
            if not name.startswith('diag_'):
                res['ok'] = ok
            if name == 'shipped':
                res['plan'] = {c[0]: gk.bwd_plan(*c[1:4]) for c in CASES}
            print(json.dumps(res), flush=True)
    finally:
        gk.bwd_launches, gk.bwd_cluster_launches = counts
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

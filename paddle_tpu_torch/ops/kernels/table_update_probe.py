"""Design probe of the row-sparse kernel's long-run walk on the card.

    python3 -m paddle_tpu_torch.ops.kernels.table_update_probe

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds variants of ``csrc/table_update.cu`` into
``build/kernels/probe/`` (one nvcc each, all started together): the
shipped source, the walk with other numbers of copy-issuing warps
(``kIssueWarps``) and ring stages (``kStages``), and the shipped walk with
``clock64`` counters around its steps.  Each variant runs lazy Adam on a
30000 x 256 table with K = 32768 ids (the synthetic text's Zipf ids, and
all K slots on one id, whose run the walk takes alone) and must agree
with the shipped build bitwise; its device time per call comes from a
CUDA graph of 20 calls replayed between CUDA events.  The counters give,
per batch of 32 slots of the one-id run, the cycles the chain warp spends
waiting at the step's barrier and adding, and the cycles an issuing warp
spends issuing its copies.  Prints one JSON line per variant, then the
card's name and power limit.
"""
import ctypes
import json
import subprocess

import numpy as np
import torch

from . import build
from . import table_update as tu
from .dense_update import _f32
from ...datasets import wmt14

__all__ = ['VARIANTS', 'device_ms', 'main']

_LOOP = '''  for (int64_t j = 0; j < nb; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (warp == 0) {'''
_LOOP_CLOCKED = '''  long long t_wait = 0, t_chain = 0, t_issue = 0;
  for (int64_t j = 0; j < nb; ++j) {
    const long long t0 = clock64();
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const long long t1 = clock64();
    t_wait += t1 - t0;
    if (warp == 0) {'''
_ISSUE = '''    issue_rows(j + kStages - 1);
    issue_order(j + 2 * kStages - 1);
    cp_async_commit();
  }'''
_ISSUE_CLOCKED = '''    asm volatile("" ::"f"(acc));
    const long long t2 = clock64();
    if (warp == 0) t_chain += t2 - t1;
    issue_rows(j + kStages - 1);
    issue_order(j + 2 * kStages - 1);
    cp_async_commit();
    if (warp == 1) t_issue += clock64() - t2;
  }
  if (blockIdx.y == 0 && lane == 0 && warp < 2) {
    atomicAdd(&g_probe[warp], (unsigned long long)t_wait);
    atomicAdd(&g_probe[2 + warp], (unsigned long long)(warp ? t_issue
                                                            : t_chain));
    if (warp == 0) atomicAdd(&g_probe[4], (unsigned long long)nb);
  }'''
_COUNTERS = ('namespace {\n',
             'namespace {\n__device__ unsigned long long g_probe[5];\n')
_READ = ('}  // extern "C"', '''int probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe,
                                               sizeof(g_probe)));
}
int probe_zero() {
  unsigned long long z[5] = {0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, z, sizeof(z)));
}
}  // extern "C"''')

_WARPS = 'constexpr int kIssueWarps = 4;'
_STAGES = 'constexpr int kStages = 8;'
# name -> (old text, new text) substitutions of the shipped source
VARIANTS = {
    'shipped': (),
    'issue_warps_1': ((_WARPS, 'constexpr int kIssueWarps = 1;'),),
    'issue_warps_2': ((_WARPS, 'constexpr int kIssueWarps = 2;'),),
    'issue_warps_8': ((_WARPS, 'constexpr int kIssueWarps = 8;'),),
    'stages_4': ((_STAGES, 'constexpr int kStages = 4;'),),
    'stages_16': ((_STAGES, 'constexpr int kStages = 16;'),),
    'clocked': (_COUNTERS, (_LOOP, _LOOP_CLOCKED),
                (_ISSUE, _ISSUE_CLOCKED), _READ),
}


def device_ms(fn, iters=20, replays=5):
    """Device ms per call of ``fn``: a CUDA graph of ``iters`` calls
    replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def main():
    height, d, k = 30000, 256, 32768
    rng = np.random.default_rng(7)
    gen = torch.Generator(device='cuda').manual_seed(7)
    lr = torch.tensor([1e-2], device='cuda')
    scalars = dict(a=_f32(0.9), b=_f32(0.999), c=_f32(1e-8),
                   d=_f32(1 - 0.9), e=_f32(1 - 0.999))
    ids = {'zipf': 3 + wmt14.zipf_seq(rng, k, height - 3),
           'one_id': np.full(k, 5)}
    cases = {}
    for name, rows in ids.items():
        srows, order = tu.sort_rows(torch.as_tensor(rows, device='cuda'),
                                    height)
        cases[name] = (srows, order,
                       torch.randn((k, d), generator=gen, device='cuda'),
                       [torch.randn((height, d), generator=gen,
                                    device='cuda'),
                        torch.randn((height, d), generator=gen,
                                    device='cuda') * 0.1,
                        torch.rand((height, d), generator=gen,
                                   device='cuda') * 0.1])
    libs, _ = build.build_variants('table_update', VARIANTS)
    shipped = build.load('table_update')
    reference = {}
    try:
        for name, lib in libs.items():
            build._libs['table_update'] = lib
            res = dict(variant=name)
            for case, (srows, order, vals, tables) in cases.items():
                got = [t.clone() for t in tables]
                tu.launch_sorted(tu.RULES['adam'], got, srows, order, vals,
                                 lr, **scalars)
                torch.cuda.synchronize()
                reference.setdefault(case, got)
                res[case + '_bitwise'] = all(
                    torch.equal(a, b) for a, b in zip(got, reference[case]))
                timed = [t.clone() for t in tables]
                res[case + '_ms'] = device_ms(lambda: tu.launch_sorted(
                    tu.RULES['adam'], timed, srows, order, vals, lr,
                    **scalars))
            if name == 'clocked':
                srows, order, vals, tables = cases['one_id']
                counts = (ctypes.c_ulonglong * 5)()
                lib.probe_zero()
                tu.launch_sorted(tu.RULES['adam'],
                                 [t.clone() for t in tables], srows, order,
                                 vals, lr, **scalars)
                torch.cuda.synchronize()
                lib.probe_read(counts)
                wait0, wait1, chain, issue, batches = list(counts)
                res['one_id_cycles_per_batch'] = dict(
                    chain_warp_wait=wait0 / batches, chain=chain / batches,
                    issue_warp_wait=wait1 / batches, issue=issue / batches,
                    batches=batches)
            print(json.dumps(res), flush=True)
    finally:
        build._libs['table_update'] = shipped
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == '__main__':
    main()

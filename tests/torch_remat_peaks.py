"""Where rematerialization's memory goes, on the card.

    python3 tests/torch_remat_peaks.py [batch ...]

Runs ``chip_smoke.py``'s remat model (``REMAT``: ResNet-50, bf16 NHWC,
224x224, Momentum) one step at a time under ``memory_optimize`` levels
None, 'dots' and 'full' (then None and 'dots' again, for the spread),
from one state, and prints for each step: the memory allocated when the
gradient pass's forward ends, the peak during its backward and what is
left when it returns (``torch.cuda`` counters around
``torch.autograd.grad``), the step's wall ms, and the census of the
saved tensors the regions took: kept strongly (their storage an input
of the region, or a kept op's own), as a handle to the region's own
recompute, or as a handle to another region's output; the regions
recomputed and the largest recompute's allocation.  Batches default to
64; about a minute a batch after the kernels' build; needs the card.
"""
import collections
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as tfl  # noqa: E402
from paddle_tpu_torch.core import executor as ex  # noqa: E402


def _instrument(marks, census):
    """Counters around the gradient pass and the regions' saved tensors
    (in place on the executor module, for this process)."""
    grad = torch.autograd.grad

    def counted_grad(*args, **kwargs):
        torch.cuda.synchronize()
        marks['forward_end'] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = grad(*args, **kwargs)
        torch.cuda.synchronize()
        marks['backward_peak'] = torch.cuda.max_memory_allocated()
        marks['backward_end'] = torch.cuda.memory_allocated()
        return out

    ex.torch.autograd.grad = counted_grad
    recompute, pack = ex._Region.recompute, ex._Region._pack
    kept_pack = ex._kept_pack

    def counted_recompute(region):
        before = torch.cuda.memory_allocated()
        recompute(region)
        census['recomputes'] += 1
        census['largest_recompute_bytes'] = max(
            census['largest_recompute_bytes'],
            torch.cuda.memory_allocated() - before)

    def tally(kind, t):
        census[kind] += 1
        census[kind + '_bytes'] += t.numel() * t.element_size()

    def counted_pack(region, t):
        h = pack(region, t)
        tally('strong' if not isinstance(h, tuple) else
              'own_handle' if h[0] == 'own' else 'output_handle', t)
        return h

    def counted_kept_pack(outputs):
        inner = kept_pack(outputs)

        def p(t):
            h = inner(t)
            tally('kept_strong' if not isinstance(h, tuple) else
                  'kept_output_handle', t)
            return h
        return p

    ex._Region.recompute = counted_recompute
    ex._Region._pack = counted_pack
    ex._kept_pack = counted_kept_pack


def main():
    batches = [int(b) for b in sys.argv[1:]] or [64]
    if not torch.cuda.is_available():
        print("torch_remat_peaks: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_environment()
    cs.phase_build()
    c = cs.REMAT
    main_prog, startup, cost = cs._resnet_programs(c)
    exe, scope = tfl.Executor(), tfl.Scope()
    exe.run(startup, scope=scope)
    marks, census = {}, collections.Counter()
    _instrument(marks, census)
    for batch in batches:
        feed = {k: torch.from_numpy(v).cuda()
                for k, v in cs._image_feed(batch, 0, c).items()}
        _levels(exe, main_prog, cost, scope, feed, batch, marks, census)
        del feed
    print(card)
    return 0


def _levels(exe, main_prog, cost, scope, feed, batch, marks, census):
    for level in (None, 'dots', 'full', None, 'dots'):
        tfl.memory_optimize(main_prog, level=level)
        exe.run(main_prog, feed=feed, fetch_list=[cost], scope=scope)
        marks.clear()
        census.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        exe.run(main_prog, feed=feed, fetch_list=[cost], scope=scope)
        ms = (time.perf_counter() - t0) * 1e3
        print("B=%d %-4s: before %.3f GB, %s, step %.1f ms, %s"
              % (batch, level, base / 1e9,
                 ', '.join('%s %.3f GB' % (k, v / 1e9)
                           for k, v in marks.items()), ms,
                 dict(census)))


if __name__ == '__main__':
    sys.exit(main())

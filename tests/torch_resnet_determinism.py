"""Whether cuDNN's non-deterministic algorithms explain why chip_smoke.py's
40-step ResNet-50 loss (phase 28) ends elsewhere from run to run, on one
CUDA card.

    python3 tests/torch_resnet_determinism.py

Run from the root of a checkout on a machine with a CUDA card and nvcc
(about three minutes on an H100).  Phase 28's program (ResNet-50, B=64,
224x224, float32 NCHW, Momentum 0.1 / 0.9) trains 40 steps on its one
staged batch from the same seeded state, twice in each of three modes,
each run in a fresh process:

- ``default``: as phase 28 runs it;
- ``cudnn``: ``torch.backends.cudnn.deterministic = True``;
- ``all``: ``torch.use_deterministic_algorithms(True, warn_only=True)``
  with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``; the ops torch still runs
  non-deterministically are listed from its warnings.

It prints each run's losses on a line of its own, then a summary: per
mode whether the two runs agree bitwise, the first step at which they
differ, the largest loss gap, and their last losses.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

MODES = ('default', 'cudnn', 'all')


def _run(mode):
    cs.phase_environment()
    if mode == 'cudnn':
        torch.backends.cudnn.deterministic = True
    elif mode == 'all':
        torch.use_deterministic_algorithms(True, warn_only=True)
    c = cs.RESNET
    main, startup, cost = cs._resnet_programs(c)
    exe, scope = cs.tfl.Executor(), cs.tfl.Scope()
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in cs._image_feed(c['B'], 0, c).items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        out, = exe.run_steps(main, feed=feed, fetch_list=[cost],
                             scope=scope, repeat=c['total_steps'])
    flagged = sorted({str(w.message).split(' does not have')[0]
                      for w in caught
                      if 'deterministic' in str(w.message)})
    print("determinism run: %s" % json.dumps(dict(
        mode=mode, losses=out.ravel().tolist(), nondeterministic_ops=flagged,
        cudnn_deterministic=torch.backends.cudnn.deterministic)),
        flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == '--run':
        _run(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    runs = {m: [] for m in MODES}
    for mode in MODES:
        env = dict(os.environ)
        if mode == 'all':
            env['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
        for _ in range(2):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--run', mode],
                cwd=ROOT, stdout=subprocess.PIPE, text=True, env=env)
            sys.stdout.write(out.stdout)
            if out.returncode:
                raise SystemExit("%s run failed (%d)" % (mode,
                                                         out.returncode))
            runs[mode] += [json.loads(line.split(': ', 1)[1])
                           for line in out.stdout.splitlines()
                           if line.startswith("determinism run: ")]
    summary = {}
    for mode, (a, b) in runs.items():
        la, lb = np.array(a['losses']), np.array(b['losses'])
        differ = np.nonzero(la != lb)[0]
        summary[mode] = dict(
            bitwise_equal=bool(differ.size == 0),
            first_differing_step=int(differ[0]) + 1 if differ.size else None,
            largest_gap=float(np.abs(la - lb).max()),
            last_losses=[float(la[-1]), float(lb[-1])],
            nondeterministic_ops=a['nondeterministic_ops'])
    print("summary: %s" % json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())

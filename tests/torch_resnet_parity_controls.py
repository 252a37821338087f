"""Whether chip_smoke.py's ResNet-50 parity phase (29) tells a sound card
step from a wrong one, on one CUDA card.

    python3 tests/torch_resnet_parity_controls.py

Run from the root of a checkout on a machine with a CUDA card and nvcc
(about two minutes on an H100).  Sound runs: the phase's own step (B=2,
224x224, card against CPU) on the images of three seeds, in two
processes, since cuDNN may choose other algorithms in each.  Controls, in
a third process, each through the same step and the phase's own check,
which each must fail:

- ``tf32``: TF32 on for cuDNN's convolutions and cuBLAS's matmuls;
- ``drop_s2``: the batch norms' backward loses its xhat * s2 / N term;
- ``bwd_unbiased``: the batch norms' backward divides s1 and s2 by N - 1;
- ``fwd_unbiased``: the batch norms' forward normalises by the unbiased
  variance (``torch.var``'s default), and its running variance takes it.

A planted fault acts on card tensors only, so the CPU step stays the
yardstick.  It prints each run's readings on a line of its own, then a
summary: per quantity the sound runs' largest reading, each control's,
and each control's failed quantities; it exits non-zero if a sound run
failed or a control passed.
"""
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import norm  # noqa: E402

SEEDS = (cs.SEED + 30, cs.SEED + 31, cs.SEED + 32)
CONTROLS = ('tf32', 'drop_s2', 'bwd_unbiased', 'fwd_unbiased')
QUANTITIES = ('loss', 'grad', 'velocity', 'update', 'running_stats')
_FWD = norm.BatchNormTrain.forward
_BWD = norm.BatchNormTrain.backward


def _forward(fault):
    def forward(ctx, x, scale, bias, axes, eps):
        if not x.is_cuda or fault != 'fwd_unbiased':
            return _FWD(ctx, x, scale, bias, axes, eps)
        bshape = norm._bshape(x, axes)
        xf = norm._wide(x)
        m = xf.mean(dim=axes)
        v = xf.var(dim=axes)
        inv = torch.rsqrt(v + eps)
        y = ((xf - m.reshape(bshape)) * inv.reshape(bshape) *
             scale.reshape(bshape) + bias.reshape(bshape))
        ctx.save_for_backward(x, scale, m, inv)
        ctx.axes = axes
        ctx.set_materialize_grads(False)
        return y.to(x.dtype), m, v
    return forward


def _backward(fault):
    def backward(ctx, dy, dm, dv):
        if dy is None or not dy.is_cuda or \
                fault not in ('drop_s2', 'bwd_unbiased'):
            return _BWD(ctx, dy, dm, dv)
        x, scale, m, inv = ctx.saved_tensors
        bshape = norm._bshape(x, ctx.axes)
        n = float(x.numel() // m.numel())
        xf, dyf = norm._wide(x), norm._wide(dy)
        xhat = (xf - m.reshape(bshape)) * inv.reshape(bshape)
        s1 = dyf.sum(dim=ctx.axes)
        s2 = (dyf * xhat).sum(dim=ctx.axes)
        if fault == 'bwd_unbiased':
            n -= 1.0
        drop = 0.0 if fault == 'drop_s2' else 1.0
        dx = (scale.reshape(bshape) * inv.reshape(bshape)) * (
            dyf - (s1 / n).reshape(bshape)
            - drop * xhat * (s2 / n).reshape(bshape))
        return dx.to(x.dtype), s2, s1, None, None
    return backward


def _run(mode):
    cs.phase_environment()
    cs.build.load_all(('dense_update',))
    main, startup, cost = cs._resnet_programs()
    rn = dict(main=main, startup=startup, cost=cost,
              exe=cs.tfl.Executor())
    runs = [(s, None) for s in SEEDS] if mode == 'sound' else \
        [(SEEDS[0], f) for f in CONTROLS]
    for seed, fault in runs:
        if fault == 'tf32':
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        elif fault:
            norm.BatchNormTrain.forward = staticmethod(_forward(fault))
            norm.BatchNormTrain.backward = staticmethod(_backward(fault))
        try:
            res = cs.resnet_parity(rn, seed=seed)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            norm.BatchNormTrain.forward = staticmethod(_FWD)
            norm.BatchNormTrain.backward = staticmethod(_BWD)
        try:
            cs.check_resnet_parity(res)
            failed = None
        except SystemExit as e:
            failed = str(e)
        print("parity run: %s" % json.dumps(dict(
            mode=mode, fault=fault, seed=seed,
            readings=dict(res['norm_rel_err'], loss=res['loss_err']),
            bad=res['bad'], nonfinite=res['nonfinite'][:5],
            failed_check=failed)), flush=True)


def main():
    if sys.argv[1:] in (['sound'], ['controls']):
        _run(sys.argv[1])
        return 0
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for proc, mode in enumerate(('sound', 'sound', 'controls')):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              mode], cwd=ROOT, stdout=subprocess.PIPE,
                             text=True)
        sys.stdout.write(out.stdout)
        if out.returncode:
            raise SystemExit("%s process failed (%d)" % (mode,
                                                         out.returncode))
        runs += [dict(json.loads(line.split(': ', 1)[1]), process=proc)
                 for line in out.stdout.splitlines()
                 if line.startswith("parity run: ")]
    sound = [r for r in runs if r['mode'] == 'sound']
    controls = [r for r in runs if r['mode'] == 'controls']
    summary = dict(
        sound_runs=len(sound),
        sound_max={q: max(r['readings'][q] for r in sound)
                   for q in QUANTITIES},
        sound_failed=[(r['process'], r['seed']) for r in sound
                      if r['failed_check']],
        controls={r['fault']: dict(readings={q: r['readings'][q]
                                             for q in QUANTITIES},
                                   bad=r['bad'], nonfinite=r['nonfinite'])
                  for r in controls},
        controls_passed=[r['fault'] for r in controls
                         if not r['failed_check']],
        tol=dict(loss=cs.TOL_RESNET_LOSS, grad=cs.TOL_RESNET_GRAD,
                 running_stats=cs.TOL_RESNET_STATS))
    print("summary: %s" % json.dumps(summary))
    return 1 if summary['sound_failed'] or summary['controls_passed'] else 0


if __name__ == '__main__':
    sys.exit(main())

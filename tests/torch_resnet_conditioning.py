"""How far two float32 implementations of one ResNet-50 training step
drift apart on the CPU: the reference (paddle_tpu on XLA) against the
port (paddle_tpu_torch on torch, at 8 threads and at 1), from the same
state, on one seeded batch of 224x224 images.  It prints the loss gaps
and, per parameter in program order, the norm-relative gap of its
gradient (the lr-0 conv biases, whose gradient is rounding noise, left
out), with the median and the worst.  This is the yardstick for the
gradient bound of chip_smoke.py's ResNet-50 parity phase.

    JAX_PLATFORMS=cpu python tests/torch_resnet_conditioning.py [batch]

A minute on a few CPU cores at batch 2 (the JAX compile most of it).
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu.core import program as jprog  # noqa: E402
from paddle_tpu.models import resnet as jres  # noqa: E402

import paddle_tpu_torch as tfl  # noqa: E402
from paddle_tpu_torch.core.scope import scope_from_numpy  # noqa: E402


def _norm_rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main(batch=2):
    with jprog.reset_unique_name_guard():
        main_p, startup = fluid.Program(), fluid.Program()
        main_p.random_seed = startup.random_seed = 20
        with fluid.program_guard(main_p, startup):
            _, _, _, cost, _ = jres.build_imagenet(depth=50)
            fluid.optimizer.MomentumOptimizer(
                learning_rate=0.1, momentum=0.9).minimize(cost)
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    persist = {v.name: np.asarray(jscope.get(v.name))
               for v in main_p.list_vars()
               if v.persistable and jscope.has(v.name)}
    rng = np.random.default_rng(50)
    feed = {'img': rng.normal(size=(batch, 3, 224, 224)).astype(np.float32),
            'label': rng.integers(0, 1000, (batch, 1)).astype(np.int32)}
    zero = {p.name for p in main_p.all_parameters()
            if p.optimize_attr['learning_rate'] == 0.0}
    params = [p.name for p in main_p.all_parameters()]
    fetch = [cost.name] + [p + '@GRAD' for p in params]
    runs = {'xla': [np.asarray(a) for a in jexe.run(
        main_p, feed=feed, fetch_list=fetch, scope=jscope)]}
    tmain = tfl.Program.from_dict(main_p.to_dict())
    threads = torch.get_num_threads()
    for n in (8, 1):
        torch.set_num_threads(n)
        runs['torch_%d' % n] = tfl.Executor('cpu').run(
            tmain, feed=feed, fetch_list=fetch,
            scope=scope_from_numpy(persist, 'cpu'))
    torch.set_num_threads(threads)
    for a, b in (('torch_8', 'xla'), ('torch_1', 'torch_8')):
        gaps = [(n, _norm_rel(x, y)) for n, x, y in
                zip(params, runs[a][1:], runs[b][1:]) if n not in zero]
        vals = [g for _, g in gaps]
        print("%s vs %s, batch %d: loss gap %.3g; gradient gaps "
              "norm-relative: median %.4g, worst %.4g (%s)"
              % (a, b, batch, abs(float(runs[a][0][0] - runs[b][0][0])),
                 float(np.median(vals)), max(vals),
                 max(gaps, key=lambda g: g[1])[0]))
        for n, g in gaps[:3] + gaps[-5:]:
            print("    %-20s %.4g" % (n, g))


if __name__ == '__main__':
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)

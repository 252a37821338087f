"""Programs the serving tests (tests/test_torch_compile.py,
test_torch_serving.py, test_torch_batching.py) build with the reference
and hand to the port: built by ``paddle_tpu``, initialised by its startup
program, then passed over by ``to_dict`` with every persistable copied,
so both packages serve the same program on the same state.
"""
import numpy as np

import paddle_tpu as fluid
from paddle_tpu.core import program as jprog

import paddle_tpu_torch as tfl
from paddle_tpu_torch.core.scope import scope_from_numpy


def fc_net(d_in=6, hidden=16, classes=3, seed=9, dtype='float32'):
    x = fluid.layers.data(name='x', shape=[d_in], dtype=dtype)
    h = fluid.layers.fc(input=x, size=hidden, act='relu')
    return fluid.layers.fc(input=h, size=classes, act='softmax')


def conv_bn_net(hw=8, classes=4):
    """Two conv + batch norm + relu stages, a max pool and an fc head."""
    img = fluid.layers.data(name='img', shape=[3, hw, hw], dtype='float32')
    h = img
    for ch in (4, 8):
        h = fluid.layers.conv2d(input=h, num_filters=ch, filter_size=3,
                                padding=1)
        h = fluid.layers.batch_norm(input=h, act='relu')
    h = fluid.layers.pool2d(input=h, pool_size=2, pool_stride=2,
                            pool_type='max')
    return fluid.layers.fc(input=h, size=classes, act='softmax')


def resnet8(hw=32):
    from paddle_tpu.models import resnet
    img = fluid.layers.data(name='img', shape=[3, hw, hw], dtype='float32')
    return resnet.resnet_cifar10(img, depth=8, num_classes=10)


def ctr_tower(n_sparse=4, rows=1000, dim=16):
    """benchmarks/bench_serving.py ``_build_ctr_tower``'s layers at
    ``n_sparse`` slots of a ``rows`` x ``dim`` table each."""
    embs = []
    for i in range(n_sparse):
        c = fluid.layers.data(name='C%d' % i, shape=[1], dtype='int64')
        embs.append(fluid.layers.embedding(input=c, size=[rows, dim]))
    dense = fluid.layers.data(name='I', shape=[13], dtype='float32')
    feat = fluid.layers.concat(embs + [dense], axis=1)
    h = fluid.layers.fc(input=feat, size=256, act='relu')
    h = fluid.layers.fc(input=h, size=128, act='relu')
    return fluid.layers.fc(input=h, size=1, act='sigmoid')


def transformer_logits(vocab=100, seq_len=32, n_layers=2, d_model=64,
                       n_heads=2):
    from paddle_tpu.models import transformer
    _, logits = transformer.build_logits(vocab, seq_len=seq_len,
                                         n_layers=n_layers,
                                         d_model=d_model, n_heads=n_heads)
    return logits


def build(net, seed=9, **kw):
    """(main, startup, fetch var) of ``net`` built by the reference."""
    with jprog.reset_unique_name_guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.program_guard(main, startup):
            out = net(**kw)
    return main, startup, out


def reference(net, seed=9, **kw):
    """The reference's (main, executor, scope, fetch var), its startup
    program run on the CPU."""
    main, startup, out = build(net, seed, **kw)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return main, exe, scope, out


def handover(main, scope):
    """The port's (main, executor, scope) of a reference program and
    scope: the program through ``to_dict``, every persistable copied."""
    tmain = tfl.Program.from_dict(main.to_dict())
    vals = {}
    for v in main.list_vars():
        if v.persistable and scope.find_var(v.name) is not None:
            vals[v.name] = np.asarray(scope.get(v.name))
    return tmain, tfl.Executor(tfl.CPUPlace()), scope_from_numpy(vals, 'cpu')


def ctr_feed(rng, rows, n_sparse=4, table=1000):
    """One CTR request of ``rows`` rows (None: one example, no batch
    axis), ids as the reference's int32 staging takes them."""
    lead = () if rows is None else (rows,)
    f = {'C%d' % i: rng.integers(0, table, size=lead + (1,)).astype(
        np.int32) for i in range(n_sparse)}
    f['I'] = rng.standard_normal(lead + (13,)).astype(np.float32)
    return f

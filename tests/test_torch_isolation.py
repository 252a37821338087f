"""The port stands alone: paddle_tpu_torch and chip_smoke.py import
neither JAX nor the reference package, and the port's entry points run
on the card unless the caller asks for the CPU.

The import checks run in a subprocess, because tests/conftest.py has
already imported JAX and paddle_tpu into this one.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'paddle_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'paddle_tpu')


def _sources():
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PKG):
        paths.extend(os.path.join(root, f) for f in files
                     if f.endswith('.py'))
    return sorted(paths)


def _forbidden(module):
    top = module.split('.')[0]
    return top in FORBIDDEN


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.inference.decode\n"
        "import paddle_tpu_torch.models.transformer\n"
        "import paddle_tpu_torch.models.rnn_lm\n"
        "import paddle_tpu_torch.models.sentiment\n"
        "import paddle_tpu_torch.models.seq2seq\n"
        "import paddle_tpu_torch.datasets.wmt14\n"
        "import paddle_tpu_torch.datasets.mnist\n"
        "import paddle_tpu_torch.datasets.cifar\n"
        "import paddle_tpu_torch.models.resnet\n"
        "import paddle_tpu_torch.models.mnist\n"
        "import paddle_tpu_torch.data_feeder\n"
        "import paddle_tpu_torch.reader.decorator\n"
        "import paddle_tpu_torch.ops.conv\n"
        "import paddle_tpu_torch.ops.pool\n"
        "import paddle_tpu_torch.core.lod\n"
        "import paddle_tpu_torch.core.selected_rows\n"
        "import paddle_tpu_torch.ops.kernels.build\n"
        "import paddle_tpu_torch.ops.kernels.dense_update\n"
        "import paddle_tpu_torch.ops.kernels.flash_attention\n"
        "import paddle_tpu_torch.ops.kernels.lstm\n"
        "import paddle_tpu_torch.ops.kernels.gru\n"
        "import paddle_tpu_torch.ops.kernels.table_update\n"
        "import paddle_tpu_torch.core.executor\n"
        "import paddle_tpu_torch.core.infer\n"
        "import paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.nets\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'clean'


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, "%s:%d imports %s" % (path, node.lineno, bad)


def test_entry_points_default_to_the_card():
    """device=None means CUDA: without a card it raises instead of
    running on the CPU; device='cpu' is the only way to the CPU."""
    from paddle_tpu_torch import Executor
    from paddle_tpu_torch.core.place import default_place
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_params)
    cfg = TransformerConfig(16, 16, 1, 8, 2)
    params = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    if torch.cuda.is_available():
        assert default_place() == torch.device('cuda', 0)
        eng = DecodeEngine(params, 1, 2, page_size=8, max_streams=2)
        assert eng.device.type == 'cuda'
        assert Executor().place == torch.device('cuda', 0)
        return
    for make in (default_place,
                 lambda: DecodeEngine(params, 1, 2, page_size=8,
                                      max_streams=2),
                 lambda: init_params(cfg, torch.Generator()),
                 Executor,
                 lambda: Executor(None)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make()
    eng = DecodeEngine(params, 1, 2, page_size=8, max_streams=2,
                       device='cpu')
    assert eng.cache.k.device.type == 'cpu'
    assert Executor('cpu').place == torch.device('cpu')


def test_slice_13_modules_leave_jax_and_reference_unloaded():
    """The flash ceiling probe's kernel and entry point, the GAN and
    fit_a_line with their dataset, the new optimizers, initializers and
    glu import neither JAX nor the reference; the probe raises without a
    card instead of running on the CPU."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.ops.kernels.flash_ceiling\n"
        "import paddle_tpu_torch.ops.kernels.flash_ceiling_probe as p\n"
        "import paddle_tpu_torch.models.gan\n"
        "import paddle_tpu_torch.models.fit_a_line\n"
        "import paddle_tpu_torch.datasets.uci_housing\n"
        "from paddle_tpu_torch.optimizer import (AdamaxOptimizer, "
        "DecayedAdagradOptimizer, AdadeltaOptimizer, RMSPropOptimizer, "
        "FtrlOptimizer)\n"
        "from paddle_tpu_torch.initializer import (TruncatedNormal, "
        "MSRAInitializer)\n"
        "from paddle_tpu_torch.nets import glu\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        p.main([])\n"
        "    except SystemExit as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('the probe ran without a card')\n"
        "print('clean')\n")
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'clean'

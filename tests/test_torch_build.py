"""The kernel build's cache key (paddle_tpu_torch/ops/kernels/build.py): a
library is named by a digest of its source, every ``csrc/`` header the
source includes directly or through another header, and the flags, so an
edit to any of them builds anew; and the row-sparse kernel's design probe
finds the texts it substitutes in the shipped source.  Nothing is
compiled here."""
import os

import pytest

from paddle_tpu_torch.ops.kernels import build, table_update_probe


def _tree(root, files):
    for name, text in files.items():
        with open(os.path.join(root, name), 'w') as f:
            f.write(text)


FILES = {
    'k.cu': '#include <stdint.h>\n#include "outer.cuh"\nint k;\n',
    'outer.cuh': '#pragma once\n#include "inner.cuh"\nint outer;\n',
    'inner.cuh': '#pragma once\n#include "outer.cuh"\nint inner;\n',
    'unrelated.cuh': 'int unrelated;\n',
}


def test_digest_follows_headers_through_other_headers(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    _tree(str(tmp_path), FILES)
    first = build.library_path('k')
    assert os.path.dirname(first) == build.BUILD_DIR
    assert os.path.basename(first).startswith('libk-')
    assert build.library_path('k') == first
    for name, edit in (('inner.cuh', 'int inner2;\n'),
                       ('outer.cuh', 'int outer2;\n'),
                       ('k.cu', 'int k2;\n')):
        before = build.library_path('k')
        _tree(str(tmp_path), {name: FILES[name] + edit})
        assert build.library_path('k') != before, name


def test_digest_ignores_headers_the_source_does_not_include(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    _tree(str(tmp_path), FILES)
    before = build.library_path('k')
    _tree(str(tmp_path), {'unrelated.cuh': 'int changed;\n'})
    assert build.library_path('k') == before


def test_digest_covers_the_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    _tree(str(tmp_path), FILES)
    before = build.library_path('k')
    monkeypatch.setattr(build, 'NVCC_FLAGS', build.NVCC_FLAGS + ['-G'])
    assert build.library_path('k') != before


def test_every_shipped_source_names_a_library():
    """Each csrc/*.cu (its headers found on disk) gets a library path, and
    the flash backward sources take the dk/dv engine's header."""
    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith('.cu'))
    assert len(names) == 9
    paths = {n: build.library_path(n) for n in names}
    assert len(set(paths.values())) == len(names)
    for n in ('flash_attention_bwd', 'flash_attention_bwd_split'):
        with open(os.path.join(build.CSRC_DIR, n + '.cu')) as f:
            assert '#include "flash_bwd_dkv.cuh"' in f.read()


@pytest.mark.parametrize('name', sorted(table_update_probe.VARIANTS))
def test_probe_variants_apply_to_the_shipped_source(name):
    """Every text the design probe (ops/kernels/table_update_probe.py)
    substitutes is in csrc/table_update.cu once, so the probe builds the
    variant it names."""
    with open(os.path.join(build.CSRC_DIR, 'table_update.cu')) as f:
        src = f.read()
    for old, new in table_update_probe.VARIANTS[name]:
        assert src.count(old) == 1, old[:60]
        src = src.replace(old, new)
    assert name == 'shipped' or 'kIssueWarps' in src

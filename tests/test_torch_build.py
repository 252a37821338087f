"""The kernel build's cache key (paddle_tpu_torch/ops/kernels/build.py): a
library is named by a digest of its source, every ``csrc/`` header the
source includes directly or through another header, and the flags, so an
edit to any of them builds anew; and the design probes (the row-sparse
kernel's, the dq kernel's, the GRU kernels' and the LSTM kernels') find
the texts they substitute in the shipped sources.  Nothing is compiled here."""
import os
import shutil

import pytest

from paddle_tpu_torch.ops.kernels import build, flash_dq_probe
from paddle_tpu_torch.ops.kernels import flash16_probe
from paddle_tpu_torch.ops.kernels import gru_bwd_probe, gru_fwd_probe
from paddle_tpu_torch.ops.kernels import lstm_bwd_probe, lstm_fwd_probe
from paddle_tpu_torch.ops.kernels import table_update_probe


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
    """Each csrc/*.cu (its headers found on disk) gets a library path, the
    flash backward sources take the dk/dv engine's header, and the
    ceiling probe's kernel (#11) both of the forward's engines' helpers:
    3xTF32 for float32, 16-bit for bfloat16."""
    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith('.cu'))
    assert len(names) == 10
    paths = {n: build.library_path(n) for n in names}
    assert len(set(paths.values())) == len(names)
    for n in ('flash_attention_bwd', 'flash_attention_bwd_split'):
        with open(os.path.join(build.CSRC_DIR, n + '.cu')) as f:
            assert '#include "flash_bwd_dkv.cuh"' in f.read()
    with open(os.path.join(build.CSRC_DIR, 'flash_ceiling.cu')) as f:
        src = f.read()
    assert '#include "flash_tf32.cuh"' in src
    assert '#include "flash_f16.cuh"' in src


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


@pytest.mark.parametrize('name', sorted(flash_dq_probe.VARIANTS))
def test_dq_probe_variants_apply_to_the_shipped_source(name):
    """Every text the dq kernel's probe (ops/kernels/flash_dq_probe.py)
    substitutes is in csrc/flash_attention_bwd_split.cu once."""
    with open(os.path.join(build.CSRC_DIR,
                           'flash_attention_bwd_split.cu')) as f:
        src = f.read()
    for old, new in flash_dq_probe.VARIANTS[name]:
        assert src.count(old) == 1, old[:60]
        src = src.replace(old, new)
    assert name != 'base_e' or 'exp2f' not in src
    assert name != 'diag_one_tf32' or 'mma3(' not in src.split(
        'fa_bwd_dq_kernel(')[1].split('launch_dkv')[0]


_FLASH16_VARIANTS = {'flash_attention_fwd': flash16_probe.FWD_VARIANTS,
                     'flash_attention_bwd': flash16_probe.BWD_VARIANTS,
                     'flash_ceiling': flash16_probe.CEIL_VARIANTS}


@pytest.mark.parametrize('source,name', [
    (source, n) for source, variants in _FLASH16_VARIANTS.items()
    for n in sorted(variants)])
def test_flash16_probe_variants_apply_to_the_shipped_sources(source, name):
    """Every text the 16-bit engines' probe (ops/kernels/flash16_probe.py)
    substitutes is in its source once, so the probe builds the variant it
    names."""
    with open(os.path.join(build.CSRC_DIR, source + '.cu')) as f:
        src = f.read()
    for old, new in _FLASH16_VARIANTS[source][name]:
        assert src.count(old) == 1, old[:60]
        src = src.replace(old, new)
    changed = src.count('kWarps16 = 8') + src.count(
        'DPAD <= 64 ? 3 : 2;') + src.count('DPAD, 1>') + (
        source == 'flash_ceiling' and 'V == kMaxExp ? 3 : 4' not in src)
    assert name == 'shipped' or changed == 1


def test_flash16_probe_names_each_instance_by_its_template_arguments():
    """#11's bf16 instances differ by variant as well as head dim: each
    gets its own entry of ptxas's resources."""
    def entry(fn, regs, spill):
        return ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N"
                "_1%s' for 'sm_90a'\nptxas info    : Function properties "
                "for x\n    %d bytes stack frame, %d bytes spill stores, %d "
                "bytes spill loads\nptxas info    : Used %d registers\n"
                % (fn, spill, spill, spill, regs))
    log = ''.join([
        entry('20flash_ceiling_kernelI13__nv_bfloat16Li64ELi0EEEvPKT_', 96,
              0),
        entry('20flash_ceiling_kernelI13__nv_bfloat16Li64ELi3EEEvPKT_', 128,
              40),
        entry('20flash_ceiling_kernelIfLi64ELi3EEEvPKT_', 168, 0)])
    got = flash16_probe._resources(log, 'flash_ceiling_kernel')
    assert sorted(got) == ['__nv_bfloat16_64_0', '__nv_bfloat16_64_3']
    assert got['__nv_bfloat16_64_3'].startswith('Used 128 registers | 40')
    fwd = flash16_probe._resources(
        entry('13fa_fwd_kernelI6__halfLi64EEEvPKT_', 128, 32),
        'fa_fwd_kernel')
    assert list(fwd) == ['__half_64']


def test_dq_probe_reads_ptxas_resources_of_each_instance():
    log = '\n'.join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116fa_"
        "bwd_dq_kernelIfLi64EEEvPKT_S3_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    80 bytes stack frame, 92 bytes spill stores, 84 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117fa_"
        "bwd_dkv_kernelIfLi64EEEvPKT_S3_' for 'sm_90a'",
        "ptxas info    : Used 128 registers, used 1 barriers"])
    assert flash_dq_probe._dq_resources(log) == {
        'f_64': 'Used 128 registers, used 1 barriers | 80 bytes stack '
                'frame, 92 bytes spill stores, 84 bytes spill loads'}


def _gru_bwd_source():
    with open(os.path.join(build.CSRC_DIR, 'gru_bwd.cu')) as f:
        return f.read()


@pytest.mark.parametrize('name', sorted(gru_bwd_probe.VARIANTS))
def test_gru_bwd_probe_variants_apply_to_the_shipped_source(name):
    """Every text the GRU BPTT kernel's probe
    (ops/kernels/gru_bwd_probe.py) substitutes is in csrc/gru_bwd.cu once,
    and each variant changes it."""
    src = _gru_bwd_source()
    for old, new in gru_bwd_probe.VARIANTS[name]:
        assert src.count(old) == 1, old[:60]
        src = src.replace(old, new)
    assert (src == _gru_bwd_source()) == (name == 'shipped')


@pytest.mark.parametrize('name', sorted(gru_bwd_probe.HEADER_VARIANTS))
def test_gru_bwd_probe_header_variants_apply(name):
    """A header variant's texts are in csrc/gru_cluster.cuh, and the
    source it builds carries the edited header in place of its
    #include."""
    src = _gru_bwd_source()
    assert src.count('#include "gru_cluster.cuh"\n') == 1
    subs = gru_bwd_probe.header_variant(
        *gru_bwd_probe.HEADER_VARIANTS[name])
    for old, new in subs:
        assert src.count(old) == 1, old[:60]
        src = src.replace(old, new)
    assert '#include "gru_cluster.cuh"' not in src
    assert 'namespace gru_cluster {' in src


def test_gru_bwd_source_takes_the_cluster_header():
    """The digest of gru_bwd follows its cluster engine and, through it,
    the 3xTF32 helpers."""
    with open(os.path.join(build.CSRC_DIR, 'gru_cluster.cuh')) as f:
        assert '#include "flash_tf32.cuh"' in f.read()
    assert '#include "gru_cluster.cuh"' in _gru_bwd_source()


def _gru_fwd_source():
    with open(os.path.join(build.CSRC_DIR, 'gru_fwd.cu')) as f:
        return f.read()


@pytest.mark.parametrize('name', sorted(gru_fwd_probe.VARIANTS))
def test_gru_fwd_probe_variants_apply_to_the_shipped_source(name):
    """Every text the GRU forward kernel's probe
    (ops/kernels/gru_fwd_probe.py) substitutes is in csrc/gru_fwd.cu once,
    and each variant changes it."""
    src = _gru_fwd_source()
    for old, new in gru_fwd_probe.VARIANTS[name]:
        assert src.count(old) == 1, old[:60]
        src = src.replace(old, new)
    assert (src == _gru_fwd_source()) == (name == 'shipped')


def test_gru_fwd_digest_covers_the_cluster_header(tmp_path, monkeypatch):
    """gru_fwd's library is named by a digest that follows its cluster
    engine (csrc/gru_cluster.cuh) and, through it, the 3xTF32 helpers:
    an edit to either builds the forward anew."""
    assert '#include "gru_cluster.cuh"' in _gru_fwd_source()
    for f in ('gru_fwd.cu', 'gru_cluster.cuh', 'flash_tf32.cuh'):
        shutil.copy(os.path.join(build.CSRC_DIR, f), str(tmp_path))
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    for header in ('gru_cluster.cuh', 'flash_tf32.cuh'):
        before = build.library_path('gru_fwd')
        with open(os.path.join(str(tmp_path), header), 'a') as f:
            f.write('// edited\n')
        assert build.library_path('gru_fwd') != before, header


def test_gru_bwd_probe_reads_ptxas_resources_of_each_kernel():
    log = '\n'.join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116gru_"
        "chain_kernelILb1EEEvPKfS2_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    56 bytes stack frame, 56 bytes spill stores, 56 bytes spill "
        "loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113gru_"
        "dw_kernelEPKfS1_' for 'sm_90a'",
        "ptxas info    : Used 121 registers, used 1 barriers"])
    assert gru_bwd_probe.resources(log) == {
        'gru_chain_kernelILb1E': 'Used 168 registers, used 16 barriers | '
                                 '56 bytes stack frame, 56 bytes spill '
                                 'stores, 56 bytes spill loads',
        'gru_dw_kernel': 'Used 121 registers, used 1 barriers | '}


def _lstm_bwd_source():
    with open(os.path.join(build.CSRC_DIR, 'lstm_bwd.cu')) as f:
        return f.read()


@pytest.mark.parametrize('name', sorted(lstm_bwd_probe.VARIANTS))
def test_lstm_bwd_probe_variants_apply_to_the_shipped_source(name):
    """Every knob the LSTM BPTT kernel's probe
    (ops/kernels/lstm_bwd_probe.py) sets is one constexpr of
    csrc/lstm_bwd.cu, and a variant leaves the source as it is only where
    it asks for the shipped settings."""
    src = _lstm_bwd_source()
    subs = lstm_bwd_probe.knobs(src, **lstm_bwd_probe.VARIANTS[name])
    for old, new in subs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert (src == _lstm_bwd_source()) == all(old == new
                                              for old, new in subs)
    assert name != 'shipped' or not subs


@pytest.mark.parametrize('name', lstm_bwd_probe.DIAGNOSTICS)
def test_lstm_bwd_probe_diagnostics_edit_the_cluster_header(name):
    """The LSTM probe's diagnostics are the GRU probe's header variants of
    csrc/gru_cluster.cuh, which lstm_bwd.cu includes once."""
    src = _lstm_bwd_source()
    assert src.count('#include "gru_cluster.cuh"\n') == 1
    source_subs, header_subs = gru_bwd_probe.HEADER_VARIANTS[name]
    assert source_subs == ()
    for old, new in gru_bwd_probe.header_variant((), header_subs):
        assert src.count(old) == 1, old[:60]
        src = src.replace(old, new)
    assert 'namespace gru_cluster {' in src


def _lstm_fwd_source():
    with open(os.path.join(build.CSRC_DIR, 'lstm_fwd.cu')) as f:
        return f.read()


@pytest.mark.parametrize('name', sorted(lstm_fwd_probe.VARIANTS))
def test_lstm_fwd_probe_variants_apply_to_the_shipped_source(name):
    """Every knob the LSTM forward kernel's probe
    (ops/kernels/lstm_fwd_probe.py) sets is one constexpr of
    csrc/lstm_fwd.cu, and a variant leaves the source as it is only where
    it asks for the shipped settings; ``row_tiled`` sets the cluster
    rule's cap to 0, which sends every width to the row-tiled loop."""
    src = _lstm_fwd_source()
    subs = lstm_fwd_probe.knobs(src, **lstm_fwd_probe.VARIANTS[name])
    for old, new in subs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert (src == _lstm_fwd_source()) == all(old == new
                                              for old, new in subs)
    assert name != 'shipped' or not subs
    assert name != 'row_tiled' or \
        'constexpr int kChainMaxBlocks = 0;' in src


def test_lstm_fwd_digest_covers_the_cluster_header(tmp_path, monkeypatch):
    """lstm_fwd's library is named by a digest that follows its cluster
    engine (csrc/gru_cluster.cuh) and, through it, the 3xTF32 helpers:
    an edit to either builds the forward anew."""
    assert _lstm_fwd_source().count('#include "gru_cluster.cuh"\n') == 1
    for f in ('lstm_fwd.cu', 'gru_cluster.cuh', 'flash_tf32.cuh'):
        shutil.copy(os.path.join(build.CSRC_DIR, f), str(tmp_path))
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    for header in ('gru_cluster.cuh', 'flash_tf32.cuh'):
        before = build.library_path('lstm_fwd')
        with open(os.path.join(str(tmp_path), header), 'a') as f:
            f.write('// edited\n')
        assert build.library_path('lstm_fwd') != before, header

"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``paddle_tpu_torch/csrc/<name>.cu`` exposes a plain C
interface.  At first use it is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout (the
digest covers the source, the ``csrc/`` headers it includes, directly or
through another header, and the flags, so an edited source or header
builds anew) and loaded with ``ctypes``.  Nothing here runs at import: the CPU tests
import every module of the package, and a CPU host has no ``nvcc``.

A build that fails raises with the compiler's output; there is no other
path to the kernel.  Every ctypes launch loads its library here first, so
a launch reached while ``torch.export`` traces (fake tensors, which have
no data to point at) raises ``NotTraceable`` here, before any
``data_ptr()``; the executor names the op that reached it.  Only #1's
forward is an operator that tracing records (ops/kernels/flash_attention.py).
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

__all__ = ['NotTraceable', 'load', 'load_all', 'library_path', 'nvcc_path', 'build_variants',
           'BUILD_DIR', 'NVCC_FLAGS', 'builds', 'build_log']

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')

# -Xptxas -v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

# a source's own headers: #include "<file>" in csrc/
_LOCAL_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)

_FAKE = torch._C._TorchDispatchModeKey.FAKE

_lock = threading.Lock()
_libs = {}
builds = 0          # libraries this process compiled or loaded
build_log = {}      # name -> nvcc's output (empty when loaded from disk)


def nvcc_path():
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        nvcc = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from source at first use")
    return nvcc


def _so_path(name):
    src = os.path.join(CSRC_DIR, name + '.cu')
    digest = hashlib.sha256()
    # the source, then each csrc/ header it includes, directly or through
    # another header, once
    todo, seen = [name + '.cu'], set()
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(os.path.join(CSRC_DIR, path), 'rb') as f:
            text = f.read()
        digest.update(text)
        todo.extend(h.decode() for h in _LOCAL_INCLUDE.findall(text))
    digest.update(' '.join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, 'lib%s-%s.so' % (
        name, digest.hexdigest()[:16]))


class NotTraceable(NotImplementedError):
    """A kernel launched through ctypes was reached under tracing."""


def load_all(names):
    """{name: ctypes library} of ``csrc/<name>.cu`` for each name; the
    sources not built yet compile in parallel, one nvcc each.  Raises
    ``NotTraceable`` under a fake-tensor mode (``torch.export``)."""
    global builds
    if torch._C._get_dispatch_mode(_FAKE) is not None:
        raise NotTraceable(
            "kernel %s is launched through ctypes, which torch.export "
            "cannot trace; only the forwards #1, #7 and #9, which inference "
            "programs reach, are operators so far, the training kernels "
            "follow with ROADMAP.md Queue 1 item 8c" % ', '.join(names))
    with _lock:
        todo = [n for n in names if n not in _libs]
        paths = {n: _so_path(n) for n in todo}
        procs = {}
        for n in todo:
            src, so = paths[n]
            if os.path.exists(so):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '%s.%d.tmp' % (so, os.getpid())
            procs[n] = (tmp, subprocess.Popen(
                [nvcc_path()] + NVCC_FLAGS + ['-o', tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for n, (tmp, proc) in procs.items():
            logs[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(n)
            else:
                os.replace(tmp, paths[n][1])   # atomic for a concurrent loader
        if failed:
            raise RuntimeError("nvcc failed on %s:\n%s" % (
                ', '.join(paths[n][0] for n in failed),
                '\n'.join(logs[n] for n in failed)))
        for n in todo:
            _libs[n] = ctypes.CDLL(paths[n][1])
            build_log[n] = logs.get(n, '')
            builds += 1
        return {n: _libs[n] for n in names}


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` is built."""
    return _so_path(name)[1]


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, compiled on first use."""
    return load_all([name])[name]


def build_variants(name, variants, sources=None):
    """A design probe's builds of ``csrc/<name>.cu``: for each
    ``{variant: ((old text, new text), ...)}`` the source with those
    substitutions, and for each ``{variant: path}`` of ``sources`` that
    file as it stands (another checkout's source, its own directory
    searched for headers), compiled in parallel (one nvcc each) into
    ``build/kernels/probe/``.  Returns ({variant: ctypes library},
    {variant: nvcc's output}); raises if a text is not in the source or a
    build fails."""
    with open(os.path.join(CSRC_DIR, name + '.cu')) as f:
        shipped = f.read()
    out_dir = os.path.join(BUILD_DIR, 'probe')
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for variant, subs in variants.items():
        src = shipped
        for old, new in subs:
            if old not in src:
                raise RuntimeError("variant %s: %r is not in the source"
                                   % (variant, old[:60]))
            src = src.replace(old, new)
        path = os.path.join(out_dir, '%s_%s.cu' % (name, variant))
        with open(path, 'w') as f:
            f.write(src)
        jobs[variant] = (path, CSRC_DIR)
    for variant, path in (sources or {}).items():
        jobs[variant] = (path, os.path.dirname(os.path.abspath(path)))
    procs = {}
    for variant, (path, include) in jobs.items():
        so = os.path.join(out_dir, '%s_%s.so' % (name, variant))
        procs[variant] = (so, subprocess.Popen(
            [nvcc_path()] + NVCC_FLAGS + ['-I', include, '-o', so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for variant, (so, proc) in procs.items():
        logs[variant] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on variant %s:\n%s"
                               % (variant, logs[variant]))
        libs[variant] = ctypes.CDLL(so)
    return libs, logs

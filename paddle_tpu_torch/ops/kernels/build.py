"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``paddle_tpu_torch/csrc/<name>.cu`` exposes a plain C
interface.  At first use it is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout (the
digest covers the source and the flags, so an edited source builds anew)
and loaded with ``ctypes``.  Nothing here runs at import: the CPU tests
import every module of the package, and a CPU host has no ``nvcc``.

A build that fails raises with the compiler's output; there is no other
path to the kernel.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ['load', 'BUILD_DIR', 'NVCC_FLAGS', 'builds', 'build_log']

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')

# -Xptxas -v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lock = threading.Lock()
_libs = {}
builds = 0          # libraries this process compiled or loaded
build_log = {}      # name -> nvcc's output (empty when loaded from disk)


def _nvcc():
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        nvcc = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from source at first use")
    return nvcc


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, compiled on first use."""
    global builds
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, name + '.cu')
        with open(src, 'rb') as f:
            digest = hashlib.sha256(
                f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name, digest))
        log = ''
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '%s.%d.tmp' % (so, os.getpid())
            res = subprocess.run([_nvcc()] + NVCC_FLAGS + ['-o', tmp, src],
                                 capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError("nvcc failed on %s:\n%s" % (src, log))
            os.replace(tmp, so)   # atomic: a concurrent loader sees all
        lib = ctypes.CDLL(so)
        build_log[name] = log
        builds += 1
        _libs[name] = lib
        return lib

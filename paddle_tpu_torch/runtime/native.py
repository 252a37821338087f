"""ctypes binding of the port's native runtime, built with g++ at first use.

Reference parity: paddle_tpu/runtime/native.py (N1-N3: the threaded
prefetch queue, record files and the staging arena in C++).  The port
keeps its own copy of the source, ``paddle_tpu_native.cc`` beside this
file, and builds it into ``build/native/`` of the checkout the first time
a class needs it.

With ``PADDLE_TPU_TORCH_USE_NATIVE_RUNTIME`` on (the default) the classes
below run on the C++ library, and a failed build or load raises
``NativeBuildError``.  The reference quietly degrades to its pure-Python
classes then (its native.py:92-98); the port runs them only when the flag
is off.  ctypes calls release the GIL, so a blocking ``pop()`` lets
producer threads run C++ memcpy and CRC work beside Python.
"""
import ctypes
import os
import subprocess
import threading

__all__ = ['available', 'NativeBuildError', 'NativeQueue',
           'NativeRecordReader', 'NativeRecordWriter', 'StagingArena']

_here = os.path.dirname(os.path.abspath(__file__))
_src = os.path.join(_here, 'paddle_tpu_native.cc')
_build_dir = os.path.join(_here, '..', '..', 'build', 'native')
_so_path = os.path.join(_build_dir, 'libpaddle_tpu_torch_native.so')

_lib = None
_lib_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native runtime did not build or load."""


def _build():
    os.makedirs(_build_dir, exist_ok=True)
    tmp = '%s.tmp.%d' % (_so_path, os.getpid())
    cmd = ['g++', '-O2', '-shared', '-fPIC', '-pthread', '-o', tmp, _src]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except FileNotFoundError as e:
        raise NativeBuildError("g++ not found: %s" % e) from None
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            "g++ failed on %s:\n%s" % (_src, e.stderr.decode(
                errors='replace'))) from None
    os.replace(tmp, _so_path)   # concurrent builders each land a whole file


def _declare(lib):
    c = ctypes
    lib.ptq_create.restype = c.c_void_p
    lib.ptq_create.argtypes = [c.c_int]
    lib.ptq_push.restype = c.c_int
    lib.ptq_push.argtypes = [c.c_void_p, c.c_char_p, c.c_long]
    lib.ptq_pop.restype = c.c_long
    lib.ptq_pop.argtypes = [c.c_void_p, c.POINTER(c.POINTER(c.c_char))]
    lib.ptq_free.argtypes = [c.POINTER(c.c_char)]
    lib.ptq_close.argtypes = [c.c_void_p]
    lib.ptq_size.restype = c.c_int
    lib.ptq_size.argtypes = [c.c_void_p]
    lib.ptq_destroy.argtypes = [c.c_void_p]
    lib.rio_writer_open.restype = c.c_void_p
    lib.rio_writer_open.argtypes = [c.c_char_p]
    lib.rio_writer_write.restype = c.c_int
    lib.rio_writer_write.argtypes = [c.c_void_p, c.c_char_p, c.c_long]
    lib.rio_writer_close.restype = c.c_int
    lib.rio_writer_close.argtypes = [c.c_void_p]
    lib.rio_reader_open.restype = c.c_void_p
    lib.rio_reader_open.argtypes = [c.c_char_p]
    lib.rio_reader_next.restype = c.c_long
    lib.rio_reader_next.argtypes = [c.c_void_p,
                                    c.POINTER(c.POINTER(c.c_char))]
    lib.rio_reader_close.argtypes = [c.c_void_p]
    lib.arena_create.restype = c.c_void_p
    lib.arena_create.argtypes = [c.c_long, c.c_int]
    lib.arena_acquire.restype = c.POINTER(c.c_char)
    lib.arena_acquire.argtypes = [c.c_void_p]
    lib.arena_release.argtypes = [c.c_void_p, c.POINTER(c.c_char)]
    lib.arena_block_size.restype = c.c_long
    lib.arena_block_size.argtypes = [c.c_void_p]
    lib.arena_free_blocks.restype = c.c_int
    lib.arena_free_blocks.argtypes = [c.c_void_p]
    lib.arena_destroy.argtypes = [c.c_void_p]


def _load():
    """The native library (built if missing or older than its source), or
    None when ``use_native_runtime`` is off.  A failed build raises."""
    global _lib
    from ..flags import FLAGS
    if not FLAGS.use_native_runtime:
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_so_path) or (
                os.path.getmtime(_so_path) < os.path.getmtime(_src)):
            _build()
        try:
            lib = ctypes.CDLL(_so_path)
        except OSError:
            # a stale or foreign-architecture binary on disk: build once
            _build()
            try:
                lib = ctypes.CDLL(_so_path)
            except OSError as e:
                raise NativeBuildError("cannot load %s: %s"
                                       % (_so_path, e)) from None
        _declare(lib)
        _lib = lib
        return _lib


def available():
    """True when the C++ runtime is on and loaded (building it if need
    be); False when ``use_native_runtime`` is off."""
    return _load() is not None


class NativeQueue(object):
    """Bounded blocking byte-blob queue: the C++ ring buffer, or
    ``queue.Queue`` with the native runtime off.  Multi-producer,
    multi-consumer."""

    def __init__(self, capacity=64):
        self._lib = _load()
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.ptq_create(capacity))
            self._q = None
        else:
            import queue
            self._q = queue.Queue(maxsize=capacity)
            self._closed = threading.Event()

    @property
    def native(self):
        return self._q is None

    def push(self, payload):
        """Blocking; False if the queue is closed."""
        if self._q is None:
            return self._lib.ptq_push(self._h, bytes(payload),
                                      len(payload)) == 0
        while not self._closed.is_set():
            try:
                self._q.put(bytes(payload), timeout=0.1)
                return True
            except Exception:
                continue
        return False

    def pop(self):
        """Blocking; None when closed and drained."""
        if self._q is None:
            out = ctypes.POINTER(ctypes.c_char)()
            n = self._lib.ptq_pop(self._h, ctypes.byref(out))
            if n < 0:
                return None
            data = ctypes.string_at(out, n)
            self._lib.ptq_free(out)
            return data
        while True:
            try:
                return self._q.get(timeout=0.1)
            except Exception:
                if self._closed.is_set() and self._q.empty():
                    return None

    def close(self):
        if self._q is None:
            self._lib.ptq_close(self._h)
        else:
            self._closed.set()

    def qsize(self):
        if self._q is None:
            return self._lib.ptq_size(self._h)
        return self._q.qsize()

    def __del__(self):
        try:
            if getattr(self, '_q', 1) is None and self._h:
                self._lib.ptq_destroy(self._h)
                self._h = None
        except Exception:
            pass


class NativeRecordWriter(object):
    """Record-file writer: C++, or io_recordio's with the native runtime
    off.  The same wire format either way (io_recordio.py is the format
    authority)."""

    def __init__(self, path):
        self._lib = _load()
        if self._lib is not None:
            self._h = ctypes.c_void_p(
                self._lib.rio_writer_open(path.encode()))
            if not self._h:
                raise IOError("cannot open %s for writing" % path)
            self._w = None
        else:
            from ..io_recordio import RecordWriter
            self._w = RecordWriter(path)

    def write(self, payload):
        if self._w is not None:
            return self._w.write(payload)
        if not self._h:
            raise ValueError("write to a closed record writer")
        if self._lib.rio_writer_write(self._h, bytes(payload),
                                      len(payload)) != 0:
            raise IOError("record write failed")

    def close(self):
        if self._w is not None:
            self._w.close()
        elif self._h:
            self._lib.rio_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeRecordReader(object):
    """Record-file reader (the CRC checked in C++ with the native runtime
    on)."""

    def __init__(self, path):
        self._lib = _load()
        if self._lib is not None:
            self._h = ctypes.c_void_p(
                self._lib.rio_reader_open(path.encode()))
            if not self._h:
                raise IOError("%s is not a record file" % path)
            self._r = None
        else:
            from ..io_recordio import RecordReader
            self._r = iter(RecordReader(path))

    def __iter__(self):
        return self

    def __next__(self):
        if self._r is not None:
            return next(self._r)
        if not self._h:  # exhausted/closed: keep raising, never segfault
            raise StopIteration
        out = ctypes.POINTER(ctypes.c_char)()
        n = self._lib.rio_reader_next(self._h, ctypes.byref(out))
        if n == -1:
            self.close()
            raise StopIteration
        if n == -2:
            raise IOError("crc mismatch")
        if n == -3:
            raise IOError("truncated record")
        data = ctypes.string_at(out, n)
        self._lib.ptq_free(out)
        return data

    def close(self):
        if self._r is not None:
            try:
                self._r.close()  # the Python reader holds an open file
            finally:
                self._r = iter(())  # post-close: StopIteration, not a
                # read-of-closed-file ValueError (native-path contract)
        elif self._h:
            self._lib.rio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StagingArena(object):
    """Fixed-block host arena (N2): acquire()/release() recycle
    64-byte-aligned buffers for assembled batches, so steady-state feeding
    allocates nothing a step."""

    def __init__(self, block_size, blocks=8):
        self._lib = _load()
        self.block_size = int(block_size)
        if self._lib is not None:
            self._h = ctypes.c_void_p(
                self._lib.arena_create(self.block_size, blocks))
            # lock: unguarded-ok(the None-vs-deque mode selector is set once in __init__ and never reassigned; the lock-free `is None` checks read an immutable reference, and every deque MUTATION happens under _cv)
            self._free = None
        else:
            import collections
            self._free = collections.deque(
                bytearray(self.block_size) for _ in range(blocks))
            self._cv = threading.Condition()

    def acquire(self):
        """Returns a writable memoryview of block_size bytes."""
        if self._free is None:
            p = self._lib.arena_acquire(self._h)
            buf = (ctypes.c_char * self.block_size).from_address(
                ctypes.addressof(p.contents))
            return memoryview(buf).cast('B'), p
        with self._cv:
            while not self._free:
                self._cv.wait()
            b = self._free.popleft()
        return memoryview(b), b

    def release(self, token):
        if self._free is None:
            self._lib.arena_release(self._h, token)
        else:
            with self._cv:
                self._free.append(token)
                self._cv.notify()

    def free_blocks(self):
        if self._free is None:
            return self._lib.arena_free_blocks(self._h)
        with self._cv:
            return len(self._free)

    def __del__(self):
        try:
            if self._free is None and self._h:
                self._lib.arena_destroy(self._h)
                self._h = None
        except Exception:
            pass

"""Record files: length-prefixed, CRC32-checked records.

Reference parity: paddle_tpu/io_recordio.py, the format authority.  A
file is the magic ``PTRC``, then for each record a little-endian uint32
length, a uint32 crc32 of the payload, and the payload.  The reference's
native C++ writer and reader (its ``runtime/native.py``) keep the same
format; the port reads and writes it here, in Python, and its own
native writer and reader (runtime/native.py) keep it too.  Files written
by either package read in the other.
"""
import struct
import zlib

__all__ = ['RecordWriter', 'RecordReader', 'read_records', 'write_records']

_MAGIC = b'PTRC'
_HDR = struct.Struct('<II')


class RecordWriter(object):
    def __init__(self, path):
        self.path = path
        self._f = open(path, 'wb')
        self._f.write(_MAGIC)

    def write(self, payload):
        if not isinstance(payload, (bytes, bytearray)):
            raise TypeError("record payload must be bytes")
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader(object):
    def __init__(self, path):
        self.path = path
        self._f = open(path, 'rb')
        if self._f.read(4) != _MAGIC:
            self._f.close()
            raise ValueError("%s is not a paddle_tpu record file" % path)

    def __iter__(self):
        return self

    def __next__(self):
        hdr = self._f.read(_HDR.size)
        if not hdr:
            self._f.close()
            raise StopIteration
        if len(hdr) < _HDR.size:
            raise IOError("truncated record header in %s" % self.path)
        length, crc = _HDR.unpack(hdr)
        payload = self._f.read(length)
        if len(payload) < length:
            raise IOError("truncated record payload in %s" % self.path)
        if zlib.crc32(payload) != crc:
            raise IOError("crc mismatch in %s" % self.path)
        return payload

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path, payloads):
    with RecordWriter(path) as w:
        for p in payloads:
            w.write(p)


def read_records(path):
    with RecordReader(path) as r:
        for p in r:
            yield p

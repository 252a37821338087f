"""Record files in the port (paddle_tpu_torch/io_recordio.py,
datasets/common.py ``convert`` / ``split`` / ``cluster_files_reader``,
reader/creator.py ``recordio``) against the reference's.

Files written by either package read in the other, record for record
and byte for byte; ``convert``'s chunk files read back through
``creator.recordio`` in both packages give the reference's samples
bitwise; a flipped payload byte fails the CRC, a cut file its length
check, another file its magic; ``split`` writes the reference's chunk
files and ``cluster_files_reader`` gives each trainer the reference's
share.
"""
import os
import pickle

import numpy as np
import pytest

from paddle_tpu import io_recordio as jrec
from paddle_tpu.datasets import common as jcommon
from paddle_tpu.reader import creator as jcreator

from paddle_tpu_torch import io_recordio as trec
from paddle_tpu_torch.datasets import common as tcommon
from paddle_tpu_torch.reader import creator as tcreator

PAYLOADS = [b'', b'a', bytes(range(256)) * 3, b'\x00' * 17]


@pytest.mark.parametrize('writer,reader', [(jrec, trec), (trec, jrec)],
                         ids=['ref_to_port', 'port_to_ref'])
def test_record_files_cross(tmp_path, writer, reader):
    path = str(tmp_path / 'r.rec')
    writer.write_records(path, PAYLOADS)
    assert list(reader.read_records(path)) == PAYLOADS
    with open(path, 'rb') as f:
        data = f.read()
    other = str(tmp_path / 'other.rec')
    reader.write_records(other, PAYLOADS)
    with open(other, 'rb') as f:
        assert f.read() == data   # the same bytes


def test_flipped_byte_fails_the_crc(tmp_path):
    path = str(tmp_path / 'r.rec')
    trec.write_records(path, [b'hello world', b'second'])
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    data[4 + 8 + 3] ^= 0x01   # a byte of the first payload
    with open(path, 'wb') as f:
        f.write(data)
    for mod in (trec, jrec):
        with pytest.raises(IOError, match='crc mismatch'):
            list(mod.read_records(path))


def test_truncated_and_foreign_files_raise(tmp_path):
    path = str(tmp_path / 'r.rec')
    trec.write_records(path, [b'0123456789'])
    with open(path, 'rb') as f:
        data = f.read()
    with open(path, 'wb') as f:
        f.write(data[:-3])
    with pytest.raises(IOError, match='truncated record payload'):
        list(trec.read_records(path))
    with open(path, 'wb') as f:
        f.write(b'NOPE' + data[4:])
    with pytest.raises(ValueError, match='not a paddle_tpu record file'):
        trec.RecordReader(path)


def _samples(n=23):
    rng = np.random.default_rng(5)
    return [(rng.standard_normal(6).astype(np.float32), int(i % 10))
            for i in range(n)]


def _reader(samples):
    def reader():
        for s in samples:
            yield s
    return reader


def _same(got, want):
    assert len(got) == len(want)
    for (a, la), (b, lb) in zip(got, want):
        assert la == lb and a.dtype == b.dtype
        assert np.array_equal(a, b)


@pytest.mark.parametrize('conv,creator', [(jcommon, tcreator),
                                          (tcommon, jcreator),
                                          (tcommon, tcreator)],
                         ids=['ref_to_port', 'port_to_ref', 'port'])
@pytest.mark.parametrize('buf_size', [0, 4])
def test_convert_reads_back_through_recordio(tmp_path, conv, creator,
                                             buf_size):
    samples = _samples()
    conv.convert(str(tmp_path), _reader(samples), 5, 'mnist')
    files = sorted(os.listdir(tmp_path))
    assert files == ['mnist-%05d' % i for i in range(5)]
    paths = [str(tmp_path / f) for f in files]
    _same(list(creator.recordio(paths, buf_size=buf_size)()), samples)
    _same(list(creator.recordio(','.join(paths), buf_size=buf_size)()),
          samples)
    _same(list(creator.recordio(paths[0], buf_size=buf_size)()),
          samples[:5])


def test_split_and_cluster_files_reader(tmp_path):
    samples = [('s%d' % i, i) for i in range(23)]
    got = {}
    for side, mod in (('ref', jcommon), ('port', tcommon)):
        d = tmp_path / side
        d.mkdir()
        mod.split(_reader(samples), 5, suffix=str(d / '%05d.pickle'))
        files = sorted(os.listdir(d))
        chunks = [pickle.load(open(str(d / f), 'rb')) for f in files]
        shares = [list(mod.cluster_files_reader(
            str(d / '*.pickle'), 3, t)()) for t in range(3)]
        got[side] = (files, chunks, shares)
    assert got['port'] == got['ref']
    files, chunks, shares = got['port']
    assert sum(len(c) for c in chunks) == 23
    assert sorted(sum(shares, [])) == sorted(samples)

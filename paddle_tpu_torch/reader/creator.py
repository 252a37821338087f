"""Reader creators (paddle_tpu/reader/creator.py, python/paddle/v2/
reader/creator.py): ``np_array``, ``text_file`` and ``recordio``, which
reads the record files ``datasets.common.convert`` writes (io_recordio.py,
the reference's format)."""
import pickle

__all__ = ['np_array', 'text_file', 'recordio']


def np_array(x):
    """A creator yielding the rows of a numpy array."""

    def reader():
        import numpy as np
        for row in np.asarray(x):
            yield row

    return reader


def text_file(path):
    """A creator yielding the lines of a text file, newline stripped."""

    def reader():
        with open(path, 'r') as f:
            for line in f:
                yield line.rstrip('\n')

    return reader


def recordio(paths, buf_size=100):
    """A creator yielding the unpickled samples of record files written
    by ``datasets.common.convert``, in file order.  ``paths`` is a path, a
    list of paths, or a comma-joined string of them; ``buf_size`` samples
    are read ahead on a background thread (``decorator.buffered``), none
    when it is 0."""
    if isinstance(paths, str):
        paths = paths.split(',')
    elif not isinstance(paths, (list, tuple)):
        paths = [paths]

    def reader():
        from ..io_recordio import RecordReader
        for path in paths:
            with RecordReader(path) as r:
                for blob in r:
                    yield pickle.loads(blob)

    from .decorator import buffered
    return buffered(reader, buf_size) if buf_size else reader

"""Reader creators (paddle_tpu/reader/creator.py, python/paddle/v2/
reader/creator.py): ``np_array`` and ``text_file``.  ``recordio`` reads
the record files that the persistence slice brings and raises."""

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
    raise NotImplementedError(
        "reader.creator.recordio reads the native record files, not ported "
        "yet: ROADMAP.md Queue 1 item 7")

"""Minibatching (paddle_tpu/reader/minibatch.py, python/paddle/v2/
minibatch.py)."""

__all__ = ['batch']


def batch(reader, batch_size, drop_last=False):
    """A minibatch reader (lists of ``batch_size`` samples) over a sample
    reader; the short last batch is kept unless ``drop_last``."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader

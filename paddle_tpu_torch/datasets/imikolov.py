"""Synthetic imikolov (PTB) language-model data (paddle_tpu/datasets/
imikolov.py, python/paddle/v2/dataset/imikolov.py).

``build_dict()`` maps word -> id ('<s>', '<e>' and '<unk>' last);
``train(word_idx, n)`` / ``test(word_idx, n)`` yield n-gram tuples of ids,
or with ``DataType.SEQ`` whole sentences as ([<s>] + ids, ids + [<e>]).
The task: order-2 Markov chains over a Zipf vocabulary, each token's
successors a small fixed set, so an n-gram model has something to fit.
The samples are the reference's, bit for bit.
"""
import numpy as np

from . import common

__all__ = ['train', 'test', 'build_dict', 'DataType']


class DataType(object):
    NGRAM = 1
    SEQ = 2


VOCAB_SIZE = 2074   # about the real dict's size at min_word_freq=50
TRAIN_SIZE = 4096
TEST_SIZE = 512


def build_dict(min_word_freq=50):
    d = {('w%04d' % i): i for i in range(VOCAB_SIZE - 3)}
    d['<s>'] = VOCAB_SIZE - 3
    d['<e>'] = VOCAB_SIZE - 2
    d['<unk>'] = VOCAB_SIZE - 1
    return d


def _markov_step(rng, prev, vocab):
    """One of ``prev``'s four successors, or a Zipf draw a quarter of the
    time."""
    base = (prev * 1103515245 + 12345) % vocab
    k = int(rng.integers(0, 4))
    if k == 3:
        return int(common.zipf_seq(rng, 1, vocab)[0])
    return int((base + k) % vocab)


def reader_creator(split, size, word_idx, n, data_type):
    vocab = max(word_idx.values()) + 1 if word_idx else VOCAB_SIZE

    def reader():
        rng = common.rng_for('imikolov', split)
        for length in common.seq_lengths(rng, size, 4, 30):
            sent = [int(common.zipf_seq(rng, 1, vocab)[0])]
            for _ in range(int(length) - 1):
                sent.append(_markov_step(rng, sent[-1], vocab))
            if data_type == DataType.NGRAM:
                for i in range(n, len(sent) + 1):
                    yield tuple(sent[i - n:i])
            elif data_type == DataType.SEQ:
                yield ([word_idx.get('<s>', vocab - 3)] + sent,
                       sent + [word_idx.get('<e>', vocab - 2)])
            else:
                raise ValueError("unsupported data_type %r" % data_type)

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return reader_creator('train', TRAIN_SIZE, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return reader_creator('test', TEST_SIZE, word_idx, n, data_type)

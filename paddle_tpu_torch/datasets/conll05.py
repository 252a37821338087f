"""Synthetic CoNLL-2005 semantic role labelling (paddle_tpu/datasets/
conll05.py, python/paddle/v2/dataset/conll05.py).

``test()`` yields 9 slots a sentence: the word ids, the five
predicate-context word ids (each repeated over the sentence), the
predicate id (repeated), the mark (1 within two words of the predicate)
and the BIO label ids.  ``get_dict()`` returns (word_dict, verb_dict,
label_dict): 4427 words, 300 verbs, 19 labels ('O' and B-/I- of nine
argument types).  The task: argument spans placed around a random
predicate position, their lengths derived from the predicate id, so a
BiLSTM-CRF has structure to learn.  The samples are the reference's, bit
for bit, from the same generator stream.
"""
import numpy as np

from . import common

__all__ = ['test', 'get_dict', 'get_embedding', 'convert',
           'word_dict_size']

WORD_VOCAB = 4427
PRED_VOCAB = 300
_ARGS = ['A0', 'A1', 'A2', 'A3', 'A4', 'AM-TMP', 'AM-LOC', 'AM-MNR', 'V']
UNK_IDX = 0
TEST_SIZE = 1024


def word_dict_size():
    return WORD_VOCAB


def _label_list():
    labels = ['O']
    for a in _ARGS:
        labels.append('B-' + a)
        labels.append('I-' + a)
    return labels


def get_dict():
    word_dict = {('w%04d' % i): i for i in range(WORD_VOCAB)}
    verb_dict = {('v%03d' % i): i for i in range(PRED_VOCAB)}
    label_dict = {l: i for i, l in enumerate(_label_list())}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """A synthetic pretrained 32-wide embedding table of the word dict,
    float32 [4427, 32]."""
    rng = common.rng_for('conll05', 'emb')
    return rng.normal(scale=0.1, size=(WORD_VOCAB, 32)).astype(np.float32)


def reader_creator(split='test', size=TEST_SIZE):
    _, _, label_dict = get_dict()

    def reader():
        rng = common.rng_for('conll05', split)
        for length in common.seq_lengths(rng, size, 5, 30):
            length = int(length)
            words = common.zipf_seq(rng, length, WORD_VOCAB)
            verb_index = int(rng.integers(0, length))
            pred = int(words[verb_index] % PRED_VOCAB)
            # A0 before the verb, A1 after it, their lengths from pred
            tags = ['O'] * length
            tags[verb_index] = 'B-V'
            a0_len = min(verb_index, 1 + pred % 3)
            for k in range(a0_len):
                tags[verb_index - 1 - k] = 'I-A0' if k < a0_len - 1 \
                    else 'B-A0'
            a1_len = min(length - verb_index - 1, 1 + (pred // 3) % 3)
            for k in range(a1_len):
                tags[verb_index + 1 + k] = 'B-A1' if k == 0 else 'I-A1'
            mark = [0] * length
            for d in (-2, -1, 0, 1, 2):
                if 0 <= verb_index + d < length:
                    mark[verb_index + d] = 1

            def ctx(d):
                i = verb_index + d
                return int(words[i]) if 0 <= i < length else UNK_IDX

            yield ([int(w) for w in words],
                   [ctx(-2)] * length, [ctx(-1)] * length,
                   [ctx(0)] * length, [ctx(1)] * length,
                   [ctx(2)] * length, [pred] * length, mark,
                   [label_dict[t] for t in tags])

    return reader


def test():
    return reader_creator('test')


def convert(path):
    """The test split into record files under ``path``."""
    common.convert(path, test(), 1000, "conl105_test")

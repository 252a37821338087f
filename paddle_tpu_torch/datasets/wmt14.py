"""Synthetic WMT14 translation batches.

The port's copy of the synthetic task of paddle_tpu/datasets/wmt14.py
(``_translate``), over ``common.zipf_seq``: source ids are
Zipf(1.3)-distributed like natural text, and the "translation" is a
deterministic token map plus a swap of adjacent pairs, which a seq2seq
model with attention can learn.  Ids 0, 1, 2 are <s>, <e>, <unk>.
``train`` is the reference's reader (bitwise its samples):
(src_ids, trg_ids, trg_ids_next), trg starting with <s> and trg_next
ending with <e>.
"""
import numpy as np

from . import common
from .common import zipf_seq

__all__ = ['START_ID', 'END_ID', 'UNK_ID', 'zipf_seq', 'translate',
           'batch', 'train']

START_ID, END_ID, UNK_ID = 0, 1, 2
TRAIN_SIZE = 2048


def translate(src, dict_size):
    """The target sentence of ``src``: a token map into the target
    vocabulary, then adjacent pairs swapped."""
    out = [3 + ((3571 * int(t) + 17) % (dict_size - 3)) for t in src]
    for i in range(0, len(out) - 1, 2):
        out[i], out[i + 1] = out[i + 1], out[i]
    return out


def batch(rng, dict_size, src_lens, max_trg_len=None):
    """One padded feed for seq2seq.build, as the reference's reader yields
    it: {'src_word_id', 'target_language_word', 'target_language_next_word'},
    each an (ids [B, T, 1] int64, lengths [B]) tuple.  Row b's source is
    src_lens[b] Zipf ids; its label is y = translate(source) + [<e>] (cut
    to ``max_trg_len`` tokens) and its decoder input [<s>] + y[:-1].
    Padding ids are 0."""
    rows = []
    for n in src_lens:
        s = 3 + zipf_seq(rng, int(n), dict_size - 3)
        y = (translate(s, dict_size) + [END_ID])[:max_trg_len]
        rows.append((s, [START_ID] + y[:-1], y))

    def pad(seqs):
        lens = np.asarray([len(q) for q in seqs], np.int64)
        ids = np.zeros((len(seqs), int(lens.max()), 1), np.int64)
        for b, q in enumerate(seqs):
            ids[b, :len(q), 0] = q
        return ids, lens
    return {'src_word_id': pad([r[0] for r in rows]),
            'target_language_word': pad([r[1] for r in rows]),
            'target_language_next_word': pad([r[2] for r in rows])}


def reader_creator(split, size, dict_size):
    def reader():
        rng = common.rng_for('wmt14', split)
        for n in common.seq_lengths(rng, size, 3, 25):
            src = (3 + zipf_seq(rng, int(n), dict_size - 3)).tolist()
            trg = translate(src, dict_size)
            yield src, [START_ID] + trg, trg + [END_ID]

    return reader


def train(dict_size):
    return reader_creator('train', TRAIN_SIZE, dict_size)

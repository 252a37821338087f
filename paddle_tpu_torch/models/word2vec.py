"""The word2vec N-gram language model on imikolov: four context words
predict the fifth through one shared embedding table.

Reference parity: paddle_tpu/models/word2vec.py (fluid/tests/book/
test_word2vec.py).  The four ``is_sparse`` lookups of ``shared_w`` give
one SelectedRows gradient, their rows and values concatenated in lookup
order (core/backward.py).
"""
from .. import layers
from ..param_attr import ParamAttr

__all__ = ['build', 'EMBED_SIZE', 'HIDDEN_SIZE', 'N']

EMBED_SIZE = 32
HIDDEN_SIZE = 256
N = 5


def build(dict_size):
    """Returns (word_vars, next_word, predict, avg_cost)."""
    names = ['firstw', 'secondw', 'thirdw', 'forthw']
    words = [layers.data(name=n, shape=[1], dtype='int64') for n in names]
    next_word = layers.data(name='nextw', shape=[1], dtype='int64')
    embeds = [layers.embedding(input=w, size=[dict_size, EMBED_SIZE],
                               dtype='float32', is_sparse=True,
                               param_attr=ParamAttr(name='shared_w'))
              for w in words]
    concat_embed = layers.concat(input=embeds, axis=1)
    hidden1 = layers.fc(input=concat_embed, size=HIDDEN_SIZE, act='sigmoid')
    predict_word = layers.fc(input=hidden1, size=dict_size, act='softmax')
    cost = layers.cross_entropy(input=predict_word, label=next_word)
    avg_cost = layers.mean(x=cost)
    return words, next_word, predict_word, avg_cost

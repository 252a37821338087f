"""CTR prediction: wide&deep and DeepFM over high-dimensional sparse
embedding tables.

Reference parity: paddle_tpu/models/ctr.py.  Every table is an
``is_sparse`` embedding, so its gradient is a SelectedRows that the
optimizer applies row by row on the row-sparse update kernel
(ops/kernels/table_update.py): the table never has a dense gradient.
"""
import numpy as np

from .. import layers
from ..datasets import common

__all__ = ['wide_and_deep', 'deepfm', 'build', 'synthetic_reader',
           'SPARSE_FEATURE_DIM', 'NUM_SLOTS', 'DENSE_DIM',
           'CRITEO_SPARSE_DIM', 'CRITEO_NUM_SLOTS']

SPARSE_FEATURE_DIM = 100003   # ~1e5 hashed ids a slot
NUM_SLOTS = 8
DENSE_DIM = 13

# the Criteo-class layout (BASELINE.json config 5): 26 sparse slots of
# ~1e6-row hashed tables and 13 dense features
CRITEO_SPARSE_DIM = 1000003
CRITEO_NUM_SLOTS = 26


def _sparse_slots(num_slots=None):
    return [layers.data(name='sparse_%d' % i, shape=[1], dtype='int64',
                        lod_level=1)
            for i in range(num_slots or NUM_SLOTS)]


def _pooled_embeddings(sparse_slots, sparse_dim, width, prefix):
    """One ``width``-column table a slot, named prefix_<slot>, each slot's
    ids looked up and sum-pooled."""
    return [layers.sequence_pool(
        input=layers.embedding(input=s, size=[sparse_dim, width],
                               is_sparse=True, param_attr='%s_%d'
                               % (prefix, i)),
        pool_type='sum') for i, s in enumerate(sparse_slots)]


def _head(features, label):
    predict = layers.fc(input=features, size=2, act='softmax')
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(x=cost)
    auc = layers.auc(input=predict, label=label)
    return predict, avg_cost, auc


def wide_and_deep(dense, sparse_slots, label, embed_dim=16,
                  hidden=(256, 128, 64), sparse_dim=None):
    """A deep MLP over the slots' pooled embeddings and the dense
    features, beside a wide linear term (a 1-column table a slot)."""
    sparse_dim = sparse_dim or SPARSE_FEATURE_DIM
    embeds = _pooled_embeddings(sparse_slots, sparse_dim, embed_dim,
                                'embed')
    deep = layers.concat(input=embeds + [dense], axis=1)
    for h in hidden:
        deep = layers.fc(input=deep, size=h, act='relu')
    wides = _pooled_embeddings(sparse_slots, sparse_dim, 1, 'wide')
    wide = layers.concat(input=wides + [dense], axis=1)
    both = layers.concat(input=[deep, wide], axis=1)
    return _head(both, label)


def deepfm(dense, sparse_slots, label, embed_dim=16, hidden=(128, 128),
           sparse_dim=None):
    """DeepFM: the linear term, the pairwise FM interaction and a deep
    MLP, the last two over shared per-slot factor embeddings."""
    sparse_dim = sparse_dim or SPARSE_FEATURE_DIM
    factors = _pooled_embeddings(sparse_slots, sparse_dim, embed_dim,
                                 'fm_embed')
    linear = _pooled_embeddings(sparse_slots, sparse_dim, 1, 'fm_w')
    # FM second order: 0.5 * ((sum v)^2 - sum v^2), summed over factors
    stacked = layers.sums(input=factors)   # [B, K]
    sum_sq = layers.elementwise_mul(x=stacked, y=stacked)
    sq_sum = layers.sums(
        input=[layers.elementwise_mul(x=f, y=f) for f in factors])
    fm2 = layers.scale(
        x=layers.reduce_sum(layers.elementwise_sub(x=sum_sq, y=sq_sum),
                            dim=1, keep_dim=True),
        scale=0.5)
    deep = layers.concat(input=factors + [dense], axis=1)
    for h in hidden:
        deep = layers.fc(input=deep, size=h, act='relu')
    head = layers.concat(input=linear + [fm2, deep, dense], axis=1)
    return _head(head, label)


def build(arch='wide_and_deep', sparse_dim=None, num_slots=None,
          embed_dim=16):
    """Returns (feed vars, predict, avg_cost, auc).  The defaults are the
    8-slot, 1e5-row layout; sparse_dim=CRITEO_SPARSE_DIM and
    num_slots=CRITEO_NUM_SLOTS give the Criteo-class one."""
    dense = layers.data(name='dense', shape=[DENSE_DIM], dtype='float32')
    sparse_slots = _sparse_slots(num_slots)
    label = layers.data(name='label', shape=[1], dtype='int64')
    fn = {'wide_and_deep': wide_and_deep, 'deepfm': deepfm}[arch]
    predict, avg_cost, auc = fn(dense, sparse_slots, label,
                                embed_dim=embed_dim, sparse_dim=sparse_dim)
    return [dense] + sparse_slots + [label], predict, avg_cost, auc


def synthetic_reader(split='train', size=4096):
    """CTR samples (dense[13], 8 sparse id lists of 1-3 ids, label): the
    label is a noisy function of planted id and dense interactions.  The
    samples are the reference's, bit for bit."""

    def reader():
        rng = common.rng_for('ctr', split)
        w = common.rng_for('ctr', 'coef').normal(size=DENSE_DIM)
        for _ in range(size):
            dense = rng.normal(size=DENSE_DIM).astype(np.float32)
            slots = []
            score = float(dense @ w)
            for _ in range(NUM_SLOTS):
                n_ids = int(rng.integers(1, 4))
                ids = rng.integers(0, SPARSE_FEATURE_DIM,
                                   size=n_ids).astype(np.int64)
                slots.append(ids.tolist())
                score += 0.3 * np.sum((ids % 17) - 8) / 8.0
            label = int(score + rng.normal() > 0)
            yield tuple([dense] + slots + [label])

    return reader

"""The recommender system on MovieLens: a user tower and a movie tower,
their cosine scaled to the rating, trained by squared error.

Reference parity: paddle_tpu/models/recommender.py (fluid/tests/book/
test_recommender_system.py).  Its seven id tables are ``is_sparse``
(gender_table has 2 rows, so every batch is one or two long id runs);
the movie title goes through ``nets.sequence_conv_pool``.
"""
from .. import layers, nets
from ..datasets import movielens

__all__ = ['build', 'get_usr_combined_features',
           'get_mov_combined_features']


def _id_fc(name, table, height, width, fc_size, dtype=None):
    """An int64 id feed, its ``is_sparse`` lookup and an fc over it."""
    ids = layers.data(name=name, shape=[1], dtype='int64')
    kwargs = {'dtype': dtype} if dtype else {}
    emb = layers.embedding(input=ids, size=[height, width],
                           param_attr=table, is_sparse=True, **kwargs)
    return layers.fc(input=emb, size=fc_size)


def get_usr_combined_features():
    usr_fc = _id_fc('user_id', 'user_table', movielens.max_user_id() + 1,
                    32, 32, dtype='float32')
    usr_gender_fc = _id_fc('gender_id', 'gender_table', 2, 16, 16)
    usr_age_fc = _id_fc('age_id', 'age_table', len(movielens.age_table),
                        16, 16)
    usr_job_fc = _id_fc('job_id', 'job_table', movielens.max_job_id() + 1,
                        16, 16)
    concat_embed = layers.concat(
        input=[usr_fc, usr_gender_fc, usr_age_fc, usr_job_fc], axis=1)
    return layers.fc(input=concat_embed, size=200, act='tanh')


def get_mov_combined_features():
    mov_fc = _id_fc('movie_id', 'movie_table', movielens.max_movie_id() + 1,
                    32, 32, dtype='float32')
    category_id = layers.data(name='category_id', shape=[1], dtype='int64',
                              lod_level=1)
    mov_categories_emb = layers.embedding(
        input=category_id, size=[len(movielens.movie_categories()), 32],
        is_sparse=True)
    mov_categories_hidden = layers.sequence_pool(input=mov_categories_emb,
                                                 pool_type='sum')
    mov_title_id = layers.data(name='movie_title', shape=[1], dtype='int64',
                               lod_level=1)
    mov_title_emb = layers.embedding(
        input=mov_title_id, size=[len(movielens.get_movie_title_dict()), 32],
        is_sparse=True)
    mov_title_conv = nets.sequence_conv_pool(
        input=mov_title_emb, num_filters=32, filter_size=3, act='tanh',
        pool_type='sum')
    concat_embed = layers.concat(
        input=[mov_fc, mov_categories_hidden, mov_title_conv], axis=1)
    return layers.fc(input=concat_embed, size=200, act='tanh')


def build():
    """Returns (feed_order, scale_infer, avg_cost); the feed order is the
    movielens reader's 8 slots."""
    usr_combined_features = get_usr_combined_features()
    mov_combined_features = get_mov_combined_features()
    inference = layers.cos_sim(X=usr_combined_features,
                               Y=mov_combined_features)
    scale_infer = layers.scale(x=inference, scale=5.0)
    label = layers.data(name='score', shape=[1], dtype='float32')
    square_cost = layers.square_error_cost(input=scale_infer, label=label)
    avg_cost = layers.mean(x=square_cost)
    feed_order = ['user_id', 'gender_id', 'age_id', 'job_id', 'movie_id',
                  'category_id', 'movie_title', 'score']
    return feed_order, scale_infer, avg_cost

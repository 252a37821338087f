"""Synthetic MovieLens-1M (paddle_tpu/datasets/movielens.py, python/
paddle/v2/dataset/movielens.py).

``train()`` / ``test()`` yield 8 slots: [user_id, gender (0 male, 1
female), age index (0..6), job_id, movie_id, [category ids], [title word
ids], [rating]], the rating rescaled to ``r * 2 - 5``.  The task: a
latent-factor model, each user and movie a hidden 8-vector and the
rating their scaled dot product plus noise, rounded to 1..5, so the
recommender's cos_sim head has structure to learn.  The samples and the
metadata are the reference's, bit for bit.
"""
import functools

import numpy as np

from . import common

__all__ = ['train', 'test', 'get_movie_title_dict', 'max_movie_id',
           'max_user_id', 'max_job_id', 'movie_categories', 'max_rating',
           'age_table', 'movie_info', 'user_info', 'MovieInfo', 'UserInfo']

age_table = [1, 18, 25, 35, 45, 50, 56]

NUM_USERS = 600
NUM_MOVIES = 400
NUM_JOBS = 21
NUM_CATEGORIES = 18
TITLE_VOCAB = 1024
TRAIN_SIZE = 4096
TEST_SIZE = 512
_LATENT = 8


class MovieInfo(object):
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, list(self.categories), list(self.title)]


class UserInfo(object):
    def __init__(self, index, gender, age_idx, job_id):
        self.index = int(index)
        self.is_male = gender == 'M'
        self.age = age_idx
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


@functools.lru_cache(maxsize=1)
def _meta():
    """(users, movies, user factors, movie factors), drawn once."""
    rng = common.rng_for('movielens', 'meta')
    users = {}
    for uid in range(1, NUM_USERS + 1):
        users[uid] = UserInfo(uid, 'M' if rng.random() < 0.5 else 'F',
                              int(rng.integers(0, len(age_table))),
                              int(rng.integers(0, NUM_JOBS)))
    movies = {}
    for mid in range(1, NUM_MOVIES + 1):
        ncat = int(rng.integers(1, 4))
        cats = rng.permutation(NUM_CATEGORIES)[:ncat].tolist()
        tlen = int(rng.integers(1, 6))
        title = common.zipf_seq(rng, tlen, TITLE_VOCAB).tolist()
        movies[mid] = MovieInfo(mid, cats, title)
    u_emb = rng.normal(size=(NUM_USERS + 1, _LATENT)).astype(np.float32)
    m_emb = rng.normal(size=(NUM_MOVIES + 1, _LATENT)).astype(np.float32)
    return users, movies, u_emb, m_emb


def _reader(is_test):
    users, movies, u_emb, m_emb = _meta()
    rng = common.rng_for('movielens', 'test' if is_test else 'train')
    for _ in range(TEST_SIZE if is_test else TRAIN_SIZE):
        uid = int(rng.integers(1, NUM_USERS + 1))
        mid = int(rng.integers(1, NUM_MOVIES + 1))
        score = float(u_emb[uid] @ m_emb[mid]) / np.sqrt(_LATENT)
        rating = np.clip(3.0 + score + 0.3 * rng.normal(), 1, 5)
        rating = float(np.round(rating)) * 2 - 5.0
        yield users[uid].value() + movies[mid].value() + [[rating]]


def train():
    return lambda: _reader(False)


def test():
    return lambda: _reader(True)


def get_movie_title_dict():
    return {('t%04d' % i): i for i in range(TITLE_VOCAB)}


def max_movie_id():
    return NUM_MOVIES


def max_user_id():
    return NUM_USERS


def max_job_id():
    return NUM_JOBS - 1


def movie_categories():
    return {('c%02d' % i): i for i in range(NUM_CATEGORIES)}


def max_rating():
    return 5.0


def movie_info():
    return _meta()[1]


def user_info():
    return _meta()[0]

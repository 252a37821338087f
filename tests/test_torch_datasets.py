"""The port's synthetic text and recommendation sets (paddle_tpu_torch/
datasets/{common,imikolov,movielens}.py and models/ctr.py's
``synthetic_reader``) against the reference's generators: every sample
equal, bit for bit, with the same Python and numpy types."""
import numpy as np
import pytest

from paddle_tpu.datasets import common as jcommon
from paddle_tpu.datasets import imikolov as jimikolov
from paddle_tpu.datasets import movielens as jmovielens
from paddle_tpu.models import ctr as jctr

from paddle_tpu_torch.datasets import common, imikolov, movielens
from paddle_tpu_torch.models import ctr


def _same(a, b):
    """Equal values of equal types, recursively (arrays bitwise)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
        return
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _samples(reader, n=None):
    out = []
    for i, s in enumerate(reader()):
        if n is not None and i >= n:
            break
        out.append(s)
    return out


@pytest.mark.parametrize('seed', [0, 3])
def test_text_helpers_match_the_reference(seed):
    _same(common.zipf_seq(np.random.default_rng(seed), 300, 2074, low=4),
          jcommon.zipf_seq(np.random.default_rng(seed), 300, 2074, low=4))
    _same(common.seq_lengths(np.random.default_rng(seed), 200, 4, 30),
          jcommon.seq_lengths(np.random.default_rng(seed), 200, 4, 30))


def test_imikolov_dict_matches_the_reference():
    assert imikolov.build_dict() == jimikolov.build_dict()


@pytest.mark.parametrize('split,n,data_type', [
    ('train', 5, 'NGRAM'), ('test', 5, 'NGRAM'), ('train', 2, 'NGRAM'),
    ('train', 0, 'SEQ'), ('test', 0, 'SEQ')])
def test_imikolov_samples_match_the_reference(split, n, data_type):
    d = imikolov.build_dict()
    mine = getattr(imikolov, split)(d, n, getattr(imikolov.DataType,
                                                  data_type))
    ref = getattr(jimikolov, split)(d, n, getattr(jimikolov.DataType,
                                                  data_type))
    a, b = _samples(mine), _samples(ref)
    assert len(a) == len(b) > 100
    _same(a, b)


def test_movielens_metadata_matches_the_reference():
    for fn in ('max_movie_id', 'max_user_id', 'max_job_id', 'max_rating',
               'movie_categories', 'get_movie_title_dict'):
        assert getattr(movielens, fn)() == getattr(jmovielens, fn)(), fn
    assert movielens.age_table == jmovielens.age_table
    users, ju = movielens.user_info(), jmovielens.user_info()
    movies, jm = movielens.movie_info(), jmovielens.movie_info()
    assert sorted(users) == sorted(ju) and sorted(movies) == sorted(jm)
    for k in users:
        _same(users[k].value(), ju[k].value())
    for k in movies:
        _same(movies[k].value(), jm[k].value())


@pytest.mark.parametrize('split', ['train', 'test'])
def test_movielens_samples_match_the_reference(split):
    a = _samples(getattr(movielens, split)())
    b = _samples(getattr(jmovielens, split)())
    assert len(a) == len(b) == {'train': 4096, 'test': 512}[split]
    _same(a, b)


@pytest.mark.parametrize('split', ['train', 'test'])
def test_ctr_reader_matches_the_reference(split):
    a = _samples(ctr.synthetic_reader(split, 300))
    b = _samples(jctr.synthetic_reader(split, 300))
    assert len(a) == len(b) == 300
    _same(a, b)

"""Datasets with the python/paddle/v2/dataset API surface, the port's own
copies of the reference's synthetic generators (paddle_tpu/datasets):
each yields the real data's field structure, dtypes and value ranges
from a deterministic, learnable synthetic task, with no download."""
from . import (cifar, common, conll05, imikolov, mnist,  # noqa: F401
               movielens, uci_housing, wmt14)

__all__ = ['cifar', 'common', 'conll05', 'imikolov', 'mnist', 'movielens',
           'uci_housing', 'wmt14']

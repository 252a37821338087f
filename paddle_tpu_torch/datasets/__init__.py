"""Datasets with the python/paddle/v2/dataset API surface, the port's own
copies of the reference's synthetic generators (paddle_tpu/datasets):
each yields the real data's field structure, dtypes and value ranges
from a deterministic, learnable synthetic task, with no download."""
from . import cifar, common, mnist, wmt14  # noqa: F401

__all__ = ['cifar', 'common', 'mnist', 'wmt14']

"""Synthetic datasets, the port's own copies of the reference's
generators."""

"""Ops of the port; importing the package registers every op type."""
from . import (activations, attention, chunked_ce, embedding,  # noqa: F401
               math, norm, optim_ops, random, tensor_ops)

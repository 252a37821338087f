"""Ops of the port; importing the package registers every op type."""
from . import (activations, attention, chunked_ce, conv,  # noqa: F401
               embedding, loss, math, metrics, norm, optim_ops, pool, random,
               rnn, sequence, tensor_ops)

"""Ops of the port; importing the package registers every op type."""
from . import (activations, attention, chunked_ce, embedding,  # noqa: F401
               loss, math, metrics, norm, optim_ops, random, rnn, sequence,
               tensor_ops)

"""Ops of the port; importing the package registers every op type."""
from . import (activations, amp_ops, attention, chunked_ce,  # noqa: F401
               conv, embedding, loss, math, metrics, norm, optim_ops, pool, random,
               rnn, sequence, tensor_ops)

"""Ops of the port; importing the package registers every op type."""
from . import (activations, amp_ops, attention, beam_search,  # noqa: F401
               chunked_ce, control_flow, conv, crf, ctc, detection,
               embedding, loss,
               math, metrics, misc, norm, optim_ops, pool, random, rnn,
               sequence, tensor_array, tensor_ops)

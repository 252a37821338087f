"""Layer library (paddle_tpu/layers), cut to the transformer's, the LSTM
models', the seq2seq translator's and the image models' layers."""
from .. import ops as _ops  # registers every op type  # noqa: F401

from . import io, nn, ops, sequence, tensor
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = (io.__all__ + nn.__all__ + ops.__all__ + sequence.__all__ +
           tensor.__all__)

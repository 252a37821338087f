"""Layer library (paddle_tpu/layers), cut to the transformer's, the LSTM
models', the seq2seq translator's (training and beam-search decode) and
the image models' layers, the control-flow layers, and what gradient
clip, the regularizers and the learning-rate schedules build."""
from .. import ops as _ops  # registers every op type  # noqa: F401

from . import beam_search as _beam_search
from . import control_flow, io, nn, ops, sequence, tensor
from .beam_search import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = (_beam_search.__all__ + control_flow.__all__ + io.__all__ +
           nn.__all__ + ops.__all__ + sequence.__all__ + tensor.__all__)

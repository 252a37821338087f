"""Control-flow layers (paddle_tpu/layers/control_flow.py), cut to
``increment``, the step counter's op."""
from .layer_helper import LayerHelper

__all__ = ['increment']


def increment(x, value=1.0, in_place=True, **kwargs):
    """x + value; ``in_place`` writes it back to ``x`` (a persistable
    counter keeps its buffer)."""
    helper = LayerHelper('increment', **kwargs)
    out = x if in_place else helper.create_tmp_variable(x.dtype)
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'step': float(value)},
                     infer_shape=False)
    return out

"""IO layers: ``data`` (paddle_tpu/layers/io.py)."""
from ..core.program import LEN_SUFFIX
from .layer_helper import LayerHelper

__all__ = ['data']


def data(name,
         shape,
         append_batch_size=True,
         dtype='float32',
         lod_level=0,
         type=None,
         stop_gradient=True,
         **kwargs):
    """Declare a feed variable; a batch dim (-1) leads unless
    ``append_batch_size`` is False.  A ragged (lod_level > 0) variable is
    padded [batch, time, ...] (a per-step shape of [1], token ids, gives
    [batch, time]) with a companion ``<name>@LEN`` int32 lengths vector
    (core/lod.py)."""
    helper = LayerHelper('data', **locals())
    shape = list(shape)
    if lod_level > 0:
        inner = [] if shape == [1] else shape
        shape = [-1, -1] + inner
    elif append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.current_block()
    if block.has_var(name):
        return block.var(name)
    var = block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        persistable=False, is_data=True)
    var.stop_gradient = stop_gradient
    if lod_level > 0:
        lv = block.create_var(
            name=name + LEN_SUFFIX, shape=[-1], dtype='int32', lod_level=0,
            persistable=False, is_data=True)
        lv.stop_gradient = True
    return var

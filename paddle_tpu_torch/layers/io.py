"""IO layers: ``data`` (paddle_tpu/layers/io.py)."""
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
    ``append_batch_size`` is False.  Ragged (lod_level > 0) feeds come
    with the sequence slice."""
    if lod_level > 0:
        raise NotImplementedError(
            "ragged (lod_level > 0) data is not ported yet: ROADMAP.md "
            "Queue 1, the sequence slice")
    helper = LayerHelper('data', **locals())
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.current_block()
    if block.has_var(name):
        return block.var(name)
    var = block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        persistable=False, is_data=True)
    var.stop_gradient = stop_gradient
    return var

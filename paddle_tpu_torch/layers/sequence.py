"""Sequence layers over the padded + lengths representation.

Reference parity: paddle_tpu/layers/sequence.py (the sequence_* /
dynamic_lstm / dynamic_gru / lstm_unit / gru_unit entries of fluid
layers/nn.py), cut to what the recurrent models use: ``dynamic_lstm``,
``dynamic_gru``, ``lstm_unit``, ``gru_unit``, ``sequence_conv``,
``sequence_pool``, ``sequence_first_step``, ``sequence_last_step``,
``sequence_softmax`` and ``sequence_lengths``.  The other layers of the
reference file raise, naming the ROADMAP item that brings them.
"""
from ..core.program import LEN_SUFFIX
from ..param_attr import ParamAttr
from .layer_helper import LayerHelper

__all__ = [
    'sequence_conv', 'sequence_pool', 'sequence_softmax',
    'sequence_first_step', 'sequence_last_step', 'sequence_expand',
    'sequence_concat', 'sequence_slice', 'sequence_erase', 'lod_reset',
    'dynamic_lstm', 'dynamic_gru', 'gru_unit', 'lstm_unit', 'chunk_eval',
    'edit_distance', 'sequence_lengths', 'linear_chain_crf', 'crf_decoding',
]


def _len_input(helper, var, slot='XLen'):
    """{slot: [len var]} if ``var`` carries a ``@LEN`` companion."""
    block = helper.main_program.current_block()
    name = var.name + LEN_SUFFIX
    if block.has_var_recursive(name):
        return {slot: [block.var_recursive(name)]}
    return {}


def sequence_lengths(x, **kwargs):
    """A ragged variable's lengths vector as a Variable."""
    helper = LayerHelper('sequence_lengths', **kwargs)
    block = helper.main_program.current_block()
    return block.var_recursive(x.name + LEN_SUFFIX)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  **kwargs):
    """Context-window convolution over each sequence's steps (ops/
    sequence.py ``sequence_conv``): a Filter [filter_size * D,
    num_filters] over the centred window, then the bias and ``act``."""
    helper = LayerHelper('sequence_conv', **kwargs)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    w = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=filter_shape, dtype=dtype,
        is_bias=False)
    pre_bias = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    inputs = {'X': [input], 'Filter': [w]}
    inputs.update(_len_input(helper, input))
    helper.append_op(
        type='sequence_conv', inputs=inputs,
        outputs={'Out': [pre_bias]},
        attrs={'contextStride': filter_stride,
               'contextStart': -int(filter_size // 2),
               'contextLength': filter_size})
    helper.copy_len(input, pre_bias)
    helper.kwargs['bias_attr'] = bias_attr
    helper.kwargs['act'] = act
    pre_act = helper.append_bias_op(pre_bias, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type, **kwargs):
    """Pool each sequence's valid steps: sum, average, sqrt, max, last or
    first (operators/sequence_pool_op)."""
    helper = LayerHelper('sequence_pool', **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    inputs = {'X': [input]}
    inputs.update(_len_input(helper, input))
    helper.append_op(
        type='sequence_pool', inputs=inputs, outputs={'Out': [out]},
        attrs={'pooltype': pool_type.upper()})
    return out


def sequence_first_step(input, **kwargs):
    return sequence_pool(input, 'first')


def sequence_last_step(input, **kwargs):
    return sequence_pool(input, 'last')


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation='sigmoid', cell_activation='tanh',
                 candidate_activation='tanh', dtype='float32',
                 use_pallas=True, **kwargs):
    """fluid.layers.dynamic_lstm: ``input`` is the pre-projected gate
    sequence [B, T, 4H] (an fc of size 4 * hidden); returns (hidden,
    cell), [B, T, H] each.  ``use_pallas`` (the reference's name) asks
    for the fused time-loop kernel, taken when the configuration allows
    (ops/rnn.py)."""
    helper = LayerHelper('lstm', **kwargs)
    hidden = size // 4
    w = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=[hidden, 4 * hidden],
        dtype=dtype, is_bias=False)
    bias_size = [1, 7 * hidden] if use_peepholes else [1, 4 * hidden]
    b = helper.create_parameter(
        attr=ParamAttr.to_attr(bias_attr), shape=bias_size, dtype=dtype,
        is_bias=True)
    hidden_out = helper.create_tmp_variable(dtype, lod_level=1)
    cell_out = helper.create_tmp_variable(dtype, lod_level=1)
    inputs = {'Input': [input], 'Weight': [w], 'Bias': [b]}
    inputs.update(_len_input(helper, input))
    helper.append_op(
        type='lstm', inputs=inputs,
        outputs={'Hidden': [hidden_out], 'Cell': [cell_out]},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation,
               'use_pallas': use_pallas})
    helper.copy_len(input, hidden_out)
    helper.copy_len(input, cell_out)
    return hidden_out, cell_out


def sequence_softmax(x=None, input=None, length_input=None, axis=1,
                     **kwargs):
    """Masked softmax over the valid steps.  ``length_input`` (default: x)
    names the variable whose ``@LEN`` vector defines validity; ``axis`` is
    the time axis of ``x`` being normalised (axis=2 on [B, Td, Ts] scores
    is attention over the encoder's steps)."""
    x = x if x is not None else input
    helper = LayerHelper('sequence_softmax', **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    inputs = {'X': [x]}
    inputs.update(_len_input(helper, length_input
                             if length_input is not None else x))
    helper.append_op(type='sequence_softmax', inputs=inputs,
                     outputs={'Out': [out]}, attrs={'axis': axis})
    helper.copy_len(x, out)
    return out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation='sigmoid',
                candidate_activation='tanh', h_0=None, dtype='float32',
                use_pallas=True, **kwargs):
    """fluid.layers.dynamic_gru: ``input`` is the pre-projected gate
    sequence [B, T, 3H] (an fc of size 3 * hidden); returns the hidden
    sequence [B, T, H].  ``h_0`` [B, H] is the optional initial state.
    ``use_pallas`` (the reference's name) asks for the fused time-loop
    kernel, taken when the configuration allows (ops/rnn.py)."""
    helper = LayerHelper('gru', **kwargs)
    hidden = size
    w = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=[hidden, 3 * hidden],
        dtype=dtype, is_bias=False)
    b = helper.create_parameter(
        attr=ParamAttr.to_attr(bias_attr), shape=[1, 3 * hidden],
        dtype=dtype, is_bias=True)
    hidden_out = helper.create_tmp_variable(dtype, lod_level=1)
    inputs = {'Input': [input], 'Weight': [w], 'Bias': [b]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    inputs.update(_len_input(helper, input))
    helper.append_op(
        type='gru', inputs=inputs, outputs={'Hidden': [hidden_out]},
        attrs={'is_reverse': is_reverse,
               'use_pallas': use_pallas,
               'gate_activation': gate_activation,
               'activation': candidate_activation})
    helper.copy_len(input, hidden_out)
    return hidden_out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation='tanh', gate_activation='sigmoid', **kwargs):
    """fluid.layers.gru_unit: one GRU step over input [B, 3H] (``size`` is
    3H) from ``hidden`` [B, H]; returns (hidden, reset hidden prev,
    gate)."""
    helper = LayerHelper('gru_unit', **kwargs)
    dtype = input.dtype
    size = size // 3
    w = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=[size, 3 * size],
        dtype=dtype, is_bias=False)
    inputs = {'Input': [input], 'HiddenPrev': [hidden], 'Weight': [w]}
    if bias_attr is not False:
        inputs['Bias'] = [helper.create_parameter(
            attr=ParamAttr.to_attr(bias_attr), shape=[1, 3 * size],
            dtype=dtype, is_bias=True)]
    gate = helper.create_tmp_variable(dtype)
    reset_hidden_pre = helper.create_tmp_variable(dtype)
    updated_hidden = helper.create_tmp_variable(dtype)
    helper.append_op(
        type='gru_unit', inputs=inputs,
        outputs={'Gate': [gate], 'ResetHiddenPrev': [reset_hidden_pre],
                 'Hidden': [updated_hidden]},
        attrs={'activation': activation,
               'gate_activation': gate_activation})
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, **kwargs):
    """fluid.layers.lstm_unit: fc([x_t, h_prev]) -> 4H gates -> one
    ``lstm_unit`` step; returns (h, c)."""
    from . import nn as nn_layers
    from .tensor import concat
    helper = LayerHelper('lstm_unit', **kwargs)
    size = cell_t_prev.shape[1]
    concat_in = concat(input=[x_t, hidden_t_prev], axis=1)
    fc_out = nn_layers.fc(input=concat_in, size=4 * size,
                          param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_tmp_variable(x_t.dtype)
    h = helper.create_tmp_variable(x_t.dtype)
    helper.append_op(
        type='lstm_unit',
        inputs={'X': [fc_out], 'C_prev': [cell_t_prev]},
        outputs={'C': [c], 'H': [h]},
        attrs={'forget_bias': float(forget_bias)})
    return h, c


def _later(name, item):
    def _layer(*args, **kwargs):
        raise NotImplementedError(
            "layers.%s is not ported yet: ROADMAP.md Queue 1, %s"
            % (name, item))

    _layer.__name__ = name
    return _layer


_OP_LIBRARY = 'item 6 (the rest of the op library)'

sequence_expand = _later('sequence_expand', _OP_LIBRARY)
sequence_concat = _later('sequence_concat', _OP_LIBRARY)
sequence_slice = _later('sequence_slice', _OP_LIBRARY)
sequence_erase = _later('sequence_erase', _OP_LIBRARY)
lod_reset = _later('lod_reset', _OP_LIBRARY)
chunk_eval = _later('chunk_eval', _OP_LIBRARY)
edit_distance = _later('edit_distance', _OP_LIBRARY)
linear_chain_crf = _later('linear_chain_crf', _OP_LIBRARY)
crf_decoding = _later('crf_decoding', _OP_LIBRARY)

"""Sequence layers over the padded + lengths representation.

Reference parity: paddle_tpu/layers/sequence.py (the sequence_* /
dynamic_lstm / dynamic_gru / lstm_unit / gru_unit / chunk_eval /
edit_distance / linear_chain_crf / crf_decoding entries of fluid
layers/nn.py), the whole file.  A layer whose op changes the lengths
declares ``<out>@LEN`` and names it as the op's ``OutLen``; one that
keeps them copies its input's ``@LEN`` to its output.
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


def sequence_expand(x, y, **kwargs):
    """Each row of ``x`` repeated over the steps of ``y``'s sequence; the
    output takes ``y``'s lengths."""
    helper = LayerHelper('sequence_expand', **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=max(y.lod_level, 1))
    inputs = {'X': [x], 'Y': [y]}
    inputs.update(_len_input(helper, y, 'YLen'))
    helper.append_op(type='sequence_expand', inputs=inputs,
                     outputs={'Out': [out]})
    helper.copy_len(y, out)
    return out


def _out_len(helper, out):
    """Declare ``out``'s ``@LEN`` companion, which the op writes."""
    block = helper.main_program.current_block()
    out_len = block.create_var(name=out.name + LEN_SUFFIX, shape=[-1],
                               dtype='int32')
    out_len.stop_gradient = True
    return out_len


def sequence_concat(input, **kwargs):
    """The sequences of ``input`` (a list) joined along time, row by
    row."""
    helper = LayerHelper('sequence_concat', **kwargs)
    out = helper.create_tmp_variable(input[0].dtype, lod_level=1)
    block = helper.main_program.current_block()
    len_vars = [block.var_recursive(v.name + LEN_SUFFIX) for v in input
                if block.has_var_recursive(v.name + LEN_SUFFIX)]
    out_len = _out_len(helper, out)
    inputs = {'X': list(input)}
    if len(len_vars) == len(input):
        inputs['XLen'] = len_vars
    helper.append_op(type='sequence_concat', inputs=inputs,
                     outputs={'Out': [out], 'OutLen': [out_len]})
    return out


def sequence_slice(input, offset, length, **kwargs):
    """Row b's steps [offset[b], offset[b] + length[b])."""
    helper = LayerHelper('sequence_slice', **kwargs)
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    out_len = _out_len(helper, out)
    helper.append_op(
        type='sequence_slice',
        inputs={'X': [input], 'Offset': [offset], 'Length': [length]},
        outputs={'Out': [out], 'OutLen': [out_len]})
    return out


def sequence_erase(input, tokens, **kwargs):
    """The sequences of ``input`` without the ids in ``tokens``."""
    helper = LayerHelper('sequence_erase', **kwargs)
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    out_len = _out_len(helper, out)
    inputs = {'X': [input]}
    inputs.update(_len_input(helper, input))
    helper.append_op(type='sequence_erase', inputs=inputs,
                     outputs={'Out': [out], 'OutLen': [out_len]},
                     attrs={'tokens': list(tokens)})
    return out


def lod_reset(x, y=None, target_lod=None, **kwargs):
    """``x`` with new lengths: ``y``'s values, or ``target_lod``."""
    helper = LayerHelper('lod_reset', **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    out_len = _out_len(helper, out)
    inputs = {'X': [x]}
    attrs = {}
    if y is not None:
        inputs['Y'] = [y]
    else:
        attrs['target_lod'] = list(target_lod)
    helper.append_op(type='lod_reset', inputs=inputs,
                     outputs={'Out': [out], 'OutLen': [out_len]},
                     attrs=attrs)
    return out


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


def linear_chain_crf(input, label, param_attr=None, **kwargs):
    """The CRF's negative log-likelihood of ``label`` per sequence, [B, 1]
    (fluid.layers.linear_chain_crf).  ``input`` is the [B, T, N] emission
    sequence; the transition parameter is [N + 2, N] (rows 0 and 1: start
    and end scores), shared with ``crf_decoding`` through a named
    ParamAttr."""
    helper = LayerHelper('linear_chain_crf', **kwargs)
    num_tags = int(input.shape[-1])
    transition = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=[num_tags + 2, num_tags],
        dtype=input.dtype, is_bias=False)
    log_likelihood = helper.create_tmp_variable(input.dtype)
    inputs = {'Emission': [input], 'Transition': [transition],
              'Label': [label]}
    inputs.update(_len_input(helper, input, 'EmissionLen'))
    helper.append_op(
        type='linear_chain_crf', inputs=inputs,
        outputs={'LogLikelihood': [log_likelihood]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None, **kwargs):
    """The Viterbi path [B, T, 1], or with ``label`` 1 where it agrees
    with the label (fluid.layers.crf_decoding)."""
    helper = LayerHelper('crf_decoding', **kwargs)
    num_tags = int(input.shape[-1])
    transition = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=[num_tags + 2, num_tags],
        dtype=input.dtype, is_bias=False)
    viterbi_path = helper.create_tmp_variable('int64',
                                              lod_level=input.lod_level)
    inputs = {'Emission': [input], 'Transition': [transition]}
    if label is not None:
        inputs['Label'] = [label]
    inputs.update(_len_input(helper, input, 'EmissionLen'))
    helper.append_op(
        type='crf_decoding', inputs=inputs,
        outputs={'ViterbiPath': [viterbi_path]})
    helper.copy_len(input, viterbi_path)
    return viterbi_path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, **kwargs):
    """Chunk precision, recall, F1 and the three chunk counts of ``input``
    against ``label`` (fluid.layers.chunk_eval)."""
    helper = LayerHelper('chunk_eval', **kwargs)
    precision = helper.create_tmp_variable('float32', stop_gradient=True)
    recall = helper.create_tmp_variable('float32', stop_gradient=True)
    f1_score = helper.create_tmp_variable('float32', stop_gradient=True)
    num_infer = helper.create_tmp_variable('int32', stop_gradient=True)
    num_label = helper.create_tmp_variable('int32', stop_gradient=True)
    num_correct = helper.create_tmp_variable('int32', stop_gradient=True)
    inputs = {'Inference': [input], 'Label': [label]}
    inputs.update(_len_input(helper, label))
    helper.append_op(
        type='chunk_eval', inputs=inputs,
        outputs={'Precision': [precision], 'Recall': [recall],
                 'F1-Score': [f1_score], 'NumInferChunks': [num_infer],
                 'NumLabelChunks': [num_label],
                 'NumCorrectChunks': [num_correct]},
        attrs={'num_chunk_types': num_chunk_types,
               'chunk_scheme': chunk_scheme,
               'excluded_chunk_types': excluded_chunk_types or []})
    return precision, recall, f1_score, num_infer, num_label, num_correct


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  **kwargs):
    """The edit distance of each hypothesis to its reference, and the
    number of sequences (fluid.layers.edit_distance); ``ignored_tokens``
    are erased from both first."""
    helper = LayerHelper('edit_distance', **kwargs)
    if ignored_tokens:
        input = sequence_erase(input, ignored_tokens)
        label = sequence_erase(label, ignored_tokens)
    out = helper.create_tmp_variable('float32', stop_gradient=True)
    seq_num = helper.create_tmp_variable('int32', stop_gradient=True)
    inputs = {'Hyps': [input], 'Refs': [label]}
    inputs.update(_len_input(helper, input, 'HypsLen'))
    inputs.update(_len_input(helper, label, 'RefsLen'))
    helper.append_op(
        type='edit_distance', inputs=inputs,
        outputs={'Out': [out], 'SequenceNum': [seq_num]},
        attrs={'normalized': normalized})
    return out, seq_num

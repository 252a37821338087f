"""Decoder-only transformer LM: its programs, fixed parameter names,
shapes and random init.

Reference parity: paddle_tpu/models/transformer.py.  ``build`` (the
training program) and ``build_logits`` (the inference program) compose
the same layers as the reference: pre-norm blocks with causal flash
attention (nets.scaled_dot_product_attention), the FFN through fc, and
the fused vocab head + cross-entropy.  Every parameter has a fixed
``tr_*`` name, so the decode engine serves the weights a training run
left in its scope (inference/decode.py ``extract_params``).

``param_names`` is the same manifest; ``init_params`` builds the ``tr_*``
tensors without a program, with the shapes and initializer families the
startup program uses: Xavier-uniform for the embedding, the position
table and every matmul weight, zeros for biases, ones and zeros for the
layer norms.  The numbers come from a ``torch.Generator``, so they
differ from the JAX startup program's; tests carry the reference's
weights over instead.
"""
import math
from collections import namedtuple

import torch

from .. import layers, nets
from ..core.place import resolve_device
from ..param_attr import ParamAttr

__all__ = ['TransformerConfig', 'init_params', 'param_names',
           'param_shapes', 'build', 'build_logits']

_PER_LAYER = ('ln_attn_w', 'ln_attn_b', 'qkv_w', 'qkv_b', 'proj_w',
              'proj_b', 'ln_ffn_w', 'ln_ffn_b', 'ffn_up_w', 'ffn_up_b',
              'ffn_down_w', 'ffn_down_b')


class TransformerConfig(namedtuple(
        'TransformerConfig',
        'vocab_size seq_len n_layers d_model n_heads d_ff')):
    """Model widths; ``d_ff`` None means 4 * d_model, as in the
    reference's ``build``."""
    __slots__ = ()

    def __new__(cls, vocab_size, seq_len=128, n_layers=2, d_model=128,
                n_heads=4, d_ff=None):
        if d_model % n_heads:
            raise ValueError("d_model %d not divisible by n_heads %d"
                             % (d_model, n_heads))
        return super(TransformerConfig, cls).__new__(
            cls, int(vocab_size), int(seq_len), int(n_layers),
            int(d_model), int(n_heads),
            int(4 * d_model if d_ff is None else d_ff))


def _block(x, i, d_model, n_heads, d_ff):
    """One pre-norm decoder block: x + attn(ln(x)), then x + ffn(ln(x))."""
    ln1 = layers.layer_norm(
        input=x, begin_norm_axis=2,
        param_attr=ParamAttr(name='tr_l%d_ln_attn_w' % i),
        bias_attr=ParamAttr(name='tr_l%d_ln_attn_b' % i))
    qkv = layers.fc(input=ln1, size=3 * d_model, num_flatten_dims=2,
                    param_attr=ParamAttr(name='tr_l%d_qkv_w' % i),
                    bias_attr=ParamAttr(name='tr_l%d_qkv_b' % i))
    q, k, v = layers.split(qkv, num_or_sections=3, dim=-1)
    ctx = nets.scaled_dot_product_attention(q, k, v, num_heads=n_heads,
                                            causal=True)
    proj = layers.fc(input=ctx, size=d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name='tr_l%d_proj_w' % i),
                     bias_attr=ParamAttr(name='tr_l%d_proj_b' % i))
    x = layers.elementwise_add(x=x, y=proj)
    ln2 = layers.layer_norm(
        input=x, begin_norm_axis=2,
        param_attr=ParamAttr(name='tr_l%d_ln_ffn_w' % i),
        bias_attr=ParamAttr(name='tr_l%d_ln_ffn_b' % i))
    h = layers.fc(input=ln2, size=d_ff, num_flatten_dims=2, act='relu',
                  param_attr=ParamAttr(name='tr_l%d_ffn_up_w' % i),
                  bias_attr=ParamAttr(name='tr_l%d_ffn_up_b' % i))
    h = layers.fc(input=h, size=d_model, num_flatten_dims=2,
                  param_attr=ParamAttr(name='tr_l%d_ffn_down_w' % i),
                  bias_attr=ParamAttr(name='tr_l%d_ffn_down_b' % i))
    return layers.elementwise_add(x=x, y=h)


def _trunk(src, vocab_size, seq_len, n_layers, d_model, n_heads, d_ff,
           dtype):
    emb = layers.embedding(input=src, size=[vocab_size, d_model],
                           param_attr=ParamAttr(name='tr_embed'))
    # learned positional table [T, D]; broadcasts over the batch dim
    pos = layers.create_parameter(shape=[seq_len, d_model], dtype='float32',
                                  attr=ParamAttr(name='tr_pos'))
    x = layers.elementwise_add(x=emb, y=pos)
    if dtype in ('bfloat16', 'float16'):
        x = layers.cast(x=x, dtype=dtype)
    for i in range(n_layers):
        x = _block(x, i, d_model, n_heads, d_ff)
    return layers.layer_norm(input=x, begin_norm_axis=2,
                             param_attr=ParamAttr(name='tr_ln_f_w'),
                             bias_attr=ParamAttr(name='tr_ln_f_b'))


def build(vocab_size, seq_len=128, n_layers=2, d_model=128, n_heads=4,
          d_ff=None, dtype='float32'):
    """Training graph in the current program guard: returns (src, target,
    avg_cost).  src is a dense [B, T] int64 token grid, target is src
    shifted by one, fed as [B, T, 1]; the vocab head is the fused
    projection + CE op."""
    if d_ff is None:
        d_ff = 4 * d_model
    if d_model % n_heads:
        raise ValueError("d_model %d not divisible by n_heads %d"
                         % (d_model, n_heads))
    src = layers.data(name='src', shape=[seq_len], dtype='int64')
    target = layers.data(name='target', shape=[seq_len, 1], dtype='int64')
    x = _trunk(src, vocab_size, seq_len, n_layers, d_model, n_heads, d_ff,
               dtype)
    cost = layers.fused_linear_softmax_ce(
        input=x, label=target, size=vocab_size, num_flatten_dims=2,
        param_attr=ParamAttr(name='tr_head_w'),
        bias_attr=ParamAttr(name='tr_head_b'))
    avg_cost = layers.mean(x=cost)
    return src, target, avg_cost


def build_logits(vocab_size, seq_len=128, n_layers=2, d_model=128,
                 n_heads=4, d_ff=None, dtype='float32'):
    """Inference graph sharing every ``tr_*`` param with ``build``:
    returns (src, logits [B, T, V]), the full-context forward the decode
    engine is held against."""
    if d_ff is None:
        d_ff = 4 * d_model
    src = layers.data(name='src', shape=[seq_len], dtype='int64')
    x = _trunk(src, vocab_size, seq_len, n_layers, d_model, n_heads, d_ff,
               dtype)
    logits = layers.fc(input=x, size=vocab_size, num_flatten_dims=2,
                       param_attr=ParamAttr(name='tr_head_w'),
                       bias_attr=ParamAttr(name='tr_head_b'))
    if dtype in ('bfloat16', 'float16'):
        logits = layers.cast(x=logits, dtype='float32')
    return src, logits


def param_names(n_layers):
    """Every fixed parameter name of the model, in layer order."""
    names = ['tr_embed', 'tr_pos']
    for i in range(n_layers):
        names.extend('tr_l%d_%s' % (i, s) for s in _PER_LAYER)
    names.extend(['tr_ln_f_w', 'tr_ln_f_b', 'tr_head_w', 'tr_head_b'])
    return names


def param_shapes(cfg):
    """{name: (shape, init)} with init 'xavier', 'ones' or 'zeros'."""
    D, F, V, T = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.seq_len
    specs = {'tr_embed': ((V, D), 'xavier'), 'tr_pos': ((T, D), 'xavier')}
    for i in range(cfg.n_layers):
        p = 'tr_l%d_' % i
        specs.update({
            p + 'ln_attn_w': ((D,), 'ones'), p + 'ln_attn_b': ((D,), 'zeros'),
            p + 'qkv_w': ((D, 3 * D), 'xavier'),
            p + 'qkv_b': ((3 * D,), 'zeros'),
            p + 'proj_w': ((D, D), 'xavier'), p + 'proj_b': ((D,), 'zeros'),
            p + 'ln_ffn_w': ((D,), 'ones'), p + 'ln_ffn_b': ((D,), 'zeros'),
            p + 'ffn_up_w': ((D, F), 'xavier'),
            p + 'ffn_up_b': ((F,), 'zeros'),
            p + 'ffn_down_w': ((F, D), 'xavier'),
            p + 'ffn_down_b': ((D,), 'zeros'),
        })
    specs.update({'tr_ln_f_w': ((D,), 'ones'), 'tr_ln_f_b': ((D,), 'zeros'),
                  'tr_head_w': ((D, V), 'xavier'),
                  'tr_head_b': ((V,), 'zeros')})
    return specs


def init_params(cfg, generator, device=None):
    """{name: float32 tensor} for every ``param_names`` entry, drawn from
    ``generator`` (a CPU ``torch.Generator``, so a seed gives the same
    weights on every device) and placed on ``device`` (None: the card).
    Xavier-uniform bounds are sqrt(6 / (fan_in + fan_out)) over the 2-D
    shape, as the reference's XavierInitializer."""
    device = resolve_device(device)
    specs = param_shapes(cfg)
    params = {}
    for name in param_names(cfg.n_layers):
        shape, init = specs[name]
        if init == 'xavier':
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            t = torch.rand(shape, generator=generator) * (2 * limit) - limit
        elif init == 'ones':
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        params[name] = t.to(device)
    return params

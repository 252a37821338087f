"""Decoder-only transformer LM: its fixed parameter names, shapes and
random init.

Reference parity: paddle_tpu/models/transformer.py.  ``param_names`` is
the same manifest; ``init_params`` builds the ``tr_*`` tensors with the
shapes and initializer families the reference's startup program uses
(layers/layer_helper.py, initializer.py): Xavier-uniform for the
embedding, the position table and every matmul weight, zeros for biases,
ones and zeros for the layer norms.  The numbers come from a
``torch.Generator``, so they differ from the JAX startup program's;
tests carry the reference's weights over with
``inference.decode.params_from_numpy`` instead.  The Program-building
``build`` / ``build_logits`` wait for the IR slice of the port.
"""
import math
from collections import namedtuple

import torch

from ..core.place import resolve_device

__all__ = ['TransformerConfig', 'init_params', 'param_names',
           'param_shapes']

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

"""Stacked-LSTM language model.

Reference parity: paddle_tpu/models/rnn_lm.py (benchmark/paddle/rnn/rnn.py:
an LSTM LM over PTB-style sequences, next-token prediction), the program
``benchmarks/bench_lstm_lm.py`` trains.  Each layer is an fc of size 4H
and a ``dynamic_lstm``, whose time loop runs on the fused LSTM kernels
(ops/kernels/lstm.py).
"""
from .. import layers
from ..param_attr import ParamAttr

__all__ = ['build']


def build(vocab_size, emb_dim=128, hidden_dim=256, num_layers=2,
          dtype='float32', fuse_vocab_loss=True):
    """Returns (src, target, avg_cost).  src / target are token-id
    sequences (lod_level=1); target is src shifted by one.  The loss is
    the fused vocab projection + softmax CE by default, or
    ``cross_entropy(softmax(fc))`` with ``fuse_vocab_loss=False``; the
    vocab head's parameters are named ``lm_out_w`` / ``lm_out_b`` in both.
    ``dtype='bfloat16'`` / ``'float16'`` casts the embedding's output to
    the low dtype (bench_lstm_lm.py's build): the projections and the
    vocab head run in it with float32 master weights, the LSTM ops
    compute in float32, and unfused logits are cast back to float32
    before the softmax."""
    src = layers.data(name='src', shape=[1], dtype='int64', lod_level=1)
    target = layers.data(name='target', shape=[1], dtype='int64',
                         lod_level=1)
    x = layers.embedding(input=src, size=[vocab_size, emb_dim])
    if dtype in ('bfloat16', 'float16'):
        x = layers.cast(x=x, dtype=dtype)
    for _ in range(num_layers):
        fc = layers.fc(input=x, size=hidden_dim * 4, num_flatten_dims=2)
        x, _ = layers.dynamic_lstm(input=fc, size=hidden_dim * 4)
    if fuse_vocab_loss:
        cost = layers.fused_linear_softmax_ce(
            input=x, label=target, size=vocab_size, num_flatten_dims=2,
            param_attr=ParamAttr(name='lm_out_w'),
            bias_attr=ParamAttr(name='lm_out_b'))
    else:
        logits = layers.fc(
            input=x, size=vocab_size, num_flatten_dims=2, act=None,
            param_attr=ParamAttr(name='lm_out_w'),
            bias_attr=ParamAttr(name='lm_out_b'))
        if dtype in ('bfloat16', 'float16'):
            logits = layers.cast(x=logits, dtype='float32')
        probs = layers.softmax(x=logits)
        cost = layers.cross_entropy(input=probs, label=target,
                                    soft_label=False)
    # the reference's sequence average: cost carries no lengths, so every
    # step of the padded batch counts
    avg_cost = layers.mean(
        x=layers.sequence_pool(input=cost, pool_type='average'))
    return src, target, avg_cost

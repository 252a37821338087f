"""Machine translation: a GRU encoder-decoder with Luong attention.

Reference parity: paddle_tpu/models/seq2seq.py (fluid/tests/book/
test_machine_translation.py), the program ``benchmarks/bench_seq2seq.py``
trains.  A bidirectional GRU encoder over the source; a GRU decoder over
the teacher-forced target, started from an fc of the encoder's last step;
batched attention of the decoder states over the padded encoder states
(one [B, Td, H] x [B, H, Ts] product and a length-masked softmax); the
attentional hidden state tanh(W_c [state; context]) feeds the vocab head.
Both embeddings are ``is_sparse``: their gradients are SelectedRows that
Adam applies lazily to the touched rows (ops/kernels/table_update.py);
every ``gru`` op runs on the fused GRU kernels (ops/kernels/gru.py).  All
parameters carry the reference's fixed names (``mt_*``).

``dtype='bfloat16'`` / ``'float16'`` casts both embeddings' outputs to
the low dtype (bench_seq2seq.py's build): the projections run in it with
float32 master weights, the GRU ops compute in float32 and hand their
Hidden back in it, and the logits are cast back to float32 before the
softmax.  ``decode``
(beam-search generation) needs ``While`` sub-blocks, tensor arrays and
``beam_search``, which come with the control-flow ops.
"""
from .. import layers
from ..param_attr import ParamAttr

__all__ = ['encoder', 'train_net', 'build', 'decode']


def _attr(name):
    return ParamAttr(name=name)


def encoder(src_word_id, dict_size, word_dim=32, hidden_dim=32,
            dtype='float32'):
    """The bidirectional GRU encoder: [B, Ts, 2H] states."""
    src_embedding = layers.embedding(
        input=src_word_id, size=[dict_size, word_dim], dtype='float32',
        is_sparse=True, param_attr=_attr('mt_src_emb'))
    if dtype in ('bfloat16', 'float16'):
        src_embedding = layers.cast(x=src_embedding, dtype=dtype)
    fc_forward = layers.fc(
        input=src_embedding, size=hidden_dim * 3, num_flatten_dims=2,
        param_attr=_attr('mt_enc_fc_fwd_w'),
        bias_attr=_attr('mt_enc_fc_fwd_b'))
    src_forward = layers.dynamic_gru(
        input=fc_forward, size=hidden_dim,
        param_attr=_attr('mt_enc_gru_fwd_w'),
        bias_attr=_attr('mt_enc_gru_fwd_b'))
    fc_backward = layers.fc(
        input=src_embedding, size=hidden_dim * 3, num_flatten_dims=2,
        param_attr=_attr('mt_enc_fc_bwd_w'),
        bias_attr=_attr('mt_enc_fc_bwd_b'))
    src_backward = layers.dynamic_gru(
        input=fc_backward, size=hidden_dim, is_reverse=True,
        param_attr=_attr('mt_enc_gru_bwd_w'),
        bias_attr=_attr('mt_enc_gru_bwd_b'))
    return layers.concat(input=[src_forward, src_backward], axis=2)


def _decoder_init(encoded, hidden_dim):
    """The decoder's h0 from the encoder's last step."""
    enc_last = layers.sequence_last_step(input=encoded)
    return layers.fc(input=enc_last, size=hidden_dim, act='tanh',
                     param_attr=_attr('mt_dec_h0_w'),
                     bias_attr=_attr('mt_dec_h0_b'))


def _attend_hidden(dec_states, encoded, hidden_dim):
    """Luong attention of dec_states [B, Td, H] over the padded encoder
    states (scores, masked softmax, context), then the attentional hidden
    state tanh(W_c [state; context]) [B, Td, H]."""
    enc_proj = layers.fc(input=encoded, size=hidden_dim,
                         num_flatten_dims=2,
                         param_attr=_attr('mt_enc_proj_w'),
                         bias_attr=_attr('mt_enc_proj_b'))
    scores = layers.matmul(dec_states, enc_proj, transpose_y=True)
    attn = layers.sequence_softmax(input=scores, length_input=encoded,
                                   axis=2)
    context = layers.matmul(attn, encoded)
    combined = layers.concat(input=[dec_states, context], axis=2)
    return layers.fc(
        input=combined, size=hidden_dim, act='tanh', num_flatten_dims=2,
        param_attr=_attr('mt_att_ht_w'), bias_attr=_attr('mt_att_ht_b'))


def train_net(src, trg, label, dict_size, word_dim=32, hidden_dim=32,
              dtype='float32', fuse_vocab_loss=True):
    """(prediction, avg_cost).  With ``fuse_vocab_loss`` the loss is the
    fused vocab projection + softmax CE over the same head parameters as
    ``prediction``'s fc; else softmax_with_cross_entropy on the logits."""
    encoded = encoder(src, dict_size, word_dim, hidden_dim, dtype=dtype)
    dec_h0 = _decoder_init(encoded, hidden_dim)
    trg_embedding = layers.embedding(
        input=trg, size=[dict_size, word_dim], dtype='float32',
        is_sparse=True, param_attr=_attr('mt_trg_emb'))
    if dtype in ('bfloat16', 'float16'):
        trg_embedding = layers.cast(x=trg_embedding, dtype=dtype)
    dec_fc = layers.fc(
        input=trg_embedding, size=hidden_dim * 3, num_flatten_dims=2,
        param_attr=_attr('mt_dec_fc_w'), bias_attr=_attr('mt_dec_fc_b'))
    dec_out = layers.dynamic_gru(
        input=dec_fc, size=hidden_dim, h_0=dec_h0,
        param_attr=_attr('mt_dec_gru_w'), bias_attr=_attr('mt_dec_gru_b'))
    att_h = _attend_hidden(dec_out, encoded, hidden_dim)
    # kept for fetches; a run that fetches only the loss skips it
    # (core/executor.py live_ops), as the reference's XLA trace drops it
    logits = layers.fc(
        input=att_h, size=dict_size, num_flatten_dims=2, act=None,
        param_attr=_attr('mt_out_fc_w'), bias_attr=_attr('mt_out_fc_b'))
    if logits.dtype in ('bfloat16', 'float16'):
        logits = layers.cast(x=logits, dtype='float32')
    prediction = layers.softmax(x=logits)
    if fuse_vocab_loss:
        cost = layers.fused_linear_softmax_ce(
            input=att_h, label=label, size=dict_size, num_flatten_dims=2,
            param_attr=_attr('mt_out_fc_w'), bias_attr=_attr('mt_out_fc_b'))
    else:
        cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_cost = layers.mean(
        x=layers.sequence_pool(input=cost, pool_type='sum'))
    return prediction, avg_cost


def build(dict_size, word_dim=32, hidden_dim=32, dtype='float32',
          fuse_vocab_loss=True):
    """Returns (src, trg, label, prediction, avg_cost): the training
    program's data layers (token-id sequences, lod_level=1) and
    outputs."""
    src = layers.data(name='src_word_id', shape=[1], dtype='int64',
                      lod_level=1)
    trg = layers.data(name='target_language_word', shape=[1],
                      dtype='int64', lod_level=1)
    label = layers.data(name='target_language_next_word', shape=[1],
                        dtype='int64', lod_level=1)
    prediction, avg_cost = train_net(src, trg, label, dict_size, word_dim,
                                     hidden_dim, dtype=dtype,
                                     fuse_vocab_loss=fuse_vocab_loss)
    return src, trg, label, prediction, avg_cost


def decode(src, dict_size, word_dim=32, hidden_dim=32, beam_size=4,
           max_len=16, start_id=0, end_id=1):
    """Beam-search generation: raises until control flow is ported."""
    raise NotImplementedError(
        "seq2seq.decode (beam-search generation) needs While sub-blocks, "
        "tensor arrays and beam_search: ROADMAP.md Queue 1 item 6")

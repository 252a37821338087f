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
softmax.  ``decode`` is beam-search generation (bench_decode.py's
program): a ``While`` loop over the decoder cell, tensor arrays of the
per-step beams and ``beam_search``, in the scope training left.
"""
import numpy as np

from .. import layers
from ..param_attr import ParamAttr

__all__ = ['encoder', 'train_net', 'build', 'decode', 'rescoring_feed']


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


def _enc_proj(encoded, hidden_dim):
    """The encoder states projected to H for the attention scores."""
    return layers.fc(input=encoded, size=hidden_dim, num_flatten_dims=2,
                     param_attr=_attr('mt_enc_proj_w'),
                     bias_attr=_attr('mt_enc_proj_b'))


def _attend_hidden(dec_states, encoded, enc_proj, hidden_dim):
    """Luong attention of dec_states [B, Td | K, H] over the padded encoder
    states (scores, masked softmax, context), then the attentional hidden
    state tanh(W_c [state; context]) [B, Td | K, H].  Training and the
    beam decode share it."""
    scores = layers.matmul(dec_states, enc_proj, transpose_y=True)
    attn = layers.sequence_softmax(input=scores, length_input=encoded,
                                   axis=2)
    context = layers.matmul(attn, encoded)
    combined = layers.concat(input=[dec_states, context], axis=2)
    return layers.fc(
        input=combined, size=hidden_dim, act='tanh', num_flatten_dims=2,
        param_attr=_attr('mt_att_ht_w'), bias_attr=_attr('mt_att_ht_b'))


def _attend_and_score(dec_states, encoded, enc_proj, dict_size,
                      hidden_dim):
    """Attention, the vocab head and its softmax: [B, K, V] probabilities."""
    att_h = _attend_hidden(dec_states, encoded, enc_proj, hidden_dim)
    logits = layers.fc(
        input=att_h, size=dict_size, num_flatten_dims=2, act=None,
        param_attr=_attr('mt_out_fc_w'), bias_attr=_attr('mt_out_fc_b'))
    if logits.dtype in ('bfloat16', 'float16'):
        logits = layers.cast(x=logits, dtype='float32')
    return layers.softmax(x=logits)


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
    enc_proj = _enc_proj(encoded, hidden_dim)
    att_h = _attend_hidden(dec_out, encoded, enc_proj, hidden_dim)
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
    """Beam-search generation (the reference book's decode path).

    The training program's decoder cell, with the same ``mt_*``
    parameters, unrolled in a ``While`` loop of ``max_len`` ticks: each
    tick embeds the [B, K] beam tokens, advances the GRU cell, attends
    over the encoder states, scores the vocab and keeps the top K
    continuations.  Returns (sentence_ids [B, K, max_len], end_id-padded,
    sentence_scores [B, K]), best first along K."""
    encoded = encoder(src, dict_size, word_dim, hidden_dim)
    dec_h0 = _decoder_init(encoded, hidden_dim)           # [B, H]
    enc_proj = _enc_proj(encoded, hidden_dim)             # [B, Ts, H]

    pre_ids, pre_scores = layers.beam_search_init(
        dec_h0, beam_size=beam_size, start_id=start_id)   # [B, K]
    hidden = layers.expand(
        layers.reshape(dec_h0, shape=[-1, 1, hidden_dim]),
        expand_times=[1, beam_size, 1])                    # [B, K, H]

    counter = layers.zeros(shape=[1], dtype='int64')
    limit = layers.fill_constant(shape=[1], dtype='int64', value=max_len)
    cond = layers.less_than(x=counter, y=limit)

    ids_arr = layers.create_array('int64')
    parents_arr = layers.create_array('int64')
    scores_arr = layers.create_array('float32')

    while_op = layers.While(cond=cond, max_iters=max_len)
    with while_op.block():
        emb = layers.embedding(
            input=pre_ids, size=[dict_size, word_dim], dtype='float32',
            param_attr=_attr('mt_trg_emb'))
        # lookup_table squeezes a trailing size-1 axis (fluid's [N, 1] id
        # convention), which eats the beam axis when K == 1: restore it
        emb = layers.reshape(emb, shape=[-1, beam_size, word_dim])
        step_fc = layers.fc(
            input=emb, size=hidden_dim * 3, num_flatten_dims=2,
            param_attr=_attr('mt_dec_fc_w'), bias_attr=_attr('mt_dec_fc_b'))
        flat_in = layers.reshape(step_fc, shape=[-1, hidden_dim * 3])
        flat_h = layers.reshape(hidden, shape=[-1, hidden_dim])
        new_h_flat, _, _ = layers.gru_unit(
            input=flat_in, hidden=flat_h, size=hidden_dim * 3,
            param_attr=_attr('mt_dec_gru_w'),
            bias_attr=_attr('mt_dec_gru_b'))               # [B*K, H]
        new_h = layers.reshape(new_h_flat,
                               shape=[-1, beam_size, hidden_dim])

        probs = _attend_and_score(new_h, encoded, enc_proj, dict_size,
                                  hidden_dim)
        logp = layers.log(probs)                           # [B, K, V]

        sel_ids, sel_scores, parents = layers.beam_search(
            pre_ids=pre_ids, pre_scores=pre_scores, scores=logp,
            beam_size=beam_size, end_id=end_id)

        layers.array_write(sel_ids, counter, ids_arr, capacity=max_len)
        layers.array_write(parents, counter, parents_arr, capacity=max_len)
        layers.array_write(sel_scores, counter, scores_arr,
                           capacity=max_len)

        # the carry: the beams and the beam-reordered decoder state
        layers.assign(layers.beam_gather(new_h, parents), hidden)
        layers.assign(sel_ids, pre_ids)
        layers.assign(sel_scores, pre_scores)
        layers.increment(x=counter, value=1, in_place=True)
        layers.less_than(x=counter, y=limit, cond=cond)

    return layers.beam_search_decode(ids_arr, parents_arr, scores_arr,
                                     end_id=end_id)


def rescoring_feed(src_ids, src_lens, sentence_ids, start_id=0, end_id=1):
    """A teacher-forced feed of ``build``'s training program that scores
    ``decode``'s hypotheses: row b * K + k is hypothesis (b, k) of
    ``sentence_ids`` [B, K, T], cut after its first ``end_id`` (all T
    tokens if it has none), as ``target_language_next_word``, with
    [start_id] + its tokens but the last as ``target_language_word``, and
    source b.  The training program's per-row summed cross entropy (its
    ``sequence_pool`` output) is then minus the hypothesis's score, as the
    decode's GRU step and the training program's GRU compute one cell."""
    src_ids = np.asarray(src_ids)
    src_lens = np.asarray(src_lens)
    sentence_ids = np.asarray(sentence_ids)
    B, K, T = sentence_ids.shape
    hyps = []
    for b in range(B):
        for k in range(K):
            ids = [int(t) for t in sentence_ids[b, k]]
            if end_id in ids:
                ids = ids[:ids.index(end_id) + 1]
            hyps.append(ids)

    def pad(seqs):
        lens = np.asarray([len(q) for q in seqs], np.int64)
        out = np.zeros((len(seqs), int(lens.max()), 1), np.int64)
        for r, q in enumerate(seqs):
            out[r, :len(q), 0] = q
        return out, lens
    rows = np.repeat(np.arange(B), K)
    return {'src_word_id': (src_ids[rows], src_lens[rows]),
            'target_language_word': pad([[start_id] + h[:-1]
                                         for h in hyps]),
            'target_language_next_word': pad(hyps)}

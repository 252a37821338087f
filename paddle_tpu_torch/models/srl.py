"""label_semantic_roles: the deep bidirectional LSTM with a CRF on
CoNLL-2005.

Reference parity: paddle_tpu/models/srl.py (fluid/tests/book/
test_label_semantic_roles.py): 8 embedded input sequences, ``depth``
stacked LSTMs of alternating direction at ``hidden_dim``, a
``linear_chain_crf`` loss and ``crf_decoding``.  The widths are module
attributes, read when ``build`` runs.  The LSTMs' relu candidate and
sigmoid cell activations send them to the ``lstm`` op's scan, as the
reference sends them to its ``lax.scan`` (ops/rnn.py ``_kernel_path``).
"""
from .. import layers
from ..param_attr import ParamAttr

__all__ = ['db_lstm', 'build']

word_dim = 32
mark_dim = 5
hidden_dim = 512
depth = 4
mix_hidden_lr = 1e-3


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            word_dict_len, pred_dict_len, mark_dict_len, label_dict_len):
    """The emission scores [B, T, label_dict_len]: the embeddings (the
    six word inputs share the frozen ``word_emb`` table), an fc each,
    summed, then ``depth`` LSTMs, each fed by two fcs of the layer
    below's input and output, the last pair's fcs to the labels."""
    predicate_embedding = layers.embedding(
        input=predicate, size=[pred_dict_len, word_dim], dtype='float32',
        param_attr='vemb')
    mark_embedding = layers.embedding(
        input=mark, size=[mark_dict_len, mark_dim], dtype='float32')
    emb_layers = [
        layers.embedding(size=[word_dict_len, word_dim], input=x,
                         param_attr=ParamAttr(name='word_emb',
                                              trainable=False))
        for x in (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
    emb_layers.append(predicate_embedding)
    emb_layers.append(mark_embedding)

    hidden_0 = layers.sums(input=[
        layers.fc(input=emb, size=hidden_dim, num_flatten_dims=2)
        for emb in emb_layers])
    lstm_0, _ = layers.dynamic_lstm(
        input=hidden_0, size=hidden_dim, candidate_activation='relu',
        gate_activation='sigmoid', cell_activation='sigmoid')

    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = layers.sums(input=[
            layers.fc(input=input_tmp[0], size=hidden_dim,
                      num_flatten_dims=2),
            layers.fc(input=input_tmp[1], size=hidden_dim,
                      num_flatten_dims=2)])
        lstm, _ = layers.dynamic_lstm(
            input=mix_hidden, size=hidden_dim, candidate_activation='relu',
            gate_activation='sigmoid', cell_activation='sigmoid',
            is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]

    return layers.sums(input=[
        layers.fc(input=input_tmp[0], size=label_dict_len,
                  num_flatten_dims=2),
        layers.fc(input=input_tmp[1], size=label_dict_len,
                  num_flatten_dims=2)])


def build(word_dict_len, pred_dict_len, mark_dict_len, label_dict_len):
    """The nine int64 sequence inputs (the feed order), the emissions,
    the Viterbi decode and the mean CRF loss: (feeds, feature_out,
    crf_decode, avg_cost).  The transition ``crfw`` learns at
    ``mix_hidden_lr`` times the optimizer's rate."""
    def seq_data(name):
        return layers.data(name=name, shape=[1], dtype='int64', lod_level=1)

    word = seq_data('word_data')
    ctx_n2 = seq_data('ctx_n2_data')
    ctx_n1 = seq_data('ctx_n1_data')
    ctx_0 = seq_data('ctx_0_data')
    ctx_p1 = seq_data('ctx_p1_data')
    ctx_p2 = seq_data('ctx_p2_data')
    predicate = seq_data('verb_data')
    mark = seq_data('mark_data')
    target = seq_data('target')

    feature_out = db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1,
                          ctx_p2, mark, word_dict_len, pred_dict_len,
                          mark_dict_len, label_dict_len)
    crf_cost = layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=ParamAttr(name='crfw', learning_rate=mix_hidden_lr))
    avg_cost = layers.mean(x=crf_cost)
    crf_decode = layers.crf_decoding(input=feature_out,
                                     param_attr=ParamAttr(name='crfw'))
    feeds = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark,
             target]
    return feeds, feature_out, crf_decode, avg_cost

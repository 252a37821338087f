"""understand_sentiment on IMDB: the convolution net, the dynamic LSTM
and the stacked bidirectional LSTM.

Reference parity: paddle_tpu/models/sentiment.py (fluid/tests/book/
test_understand_sentiment_{conv,dynamic_lstm,lstm}.py).
"""
from .. import layers, nets

__all__ = ['convolution_net', 'dynamic_lstm_net', 'stacked_lstm_net',
           'build']


def convolution_net(data, label, input_dim, class_dim=2, emb_dim=32,
                    hid_dim=32):
    """Two sequence_conv_pool branches (windows of 3 and 4 steps, tanh,
    sqrt pooling) over one embedding, then a softmax fc."""
    emb = layers.embedding(input=data, size=[input_dim, emb_dim])
    conv_3 = nets.sequence_conv_pool(
        input=emb, num_filters=hid_dim, filter_size=3, act='tanh',
        pool_type='sqrt')
    conv_4 = nets.sequence_conv_pool(
        input=emb, num_filters=hid_dim, filter_size=4, act='tanh',
        pool_type='sqrt')
    prediction = layers.fc(input=[conv_3, conv_4], size=class_dim,
                           act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction


def dynamic_lstm_net(data, label, input_dim, class_dim=2, emb_dim=32,
                     lstm_size=32):
    emb = layers.embedding(input=data, size=[input_dim, emb_dim])
    fc0 = layers.fc(input=emb, size=lstm_size * 4, num_flatten_dims=2)
    lstm_h, _ = layers.dynamic_lstm(input=fc0, size=lstm_size * 4,
                                    is_reverse=False)
    lstm_max = layers.sequence_pool(input=lstm_h, pool_type='max')
    prediction = layers.fc(input=lstm_max, size=class_dim, act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction


def stacked_lstm_net(data, label, input_dim, class_dim=2, emb_dim=128,
                     hid_dim=512, stacked_num=3):
    """``stacked_num`` LSTM layers (odd), every even-numbered one running
    backwards in time; each fc sees the previous fc and LSTM outputs."""
    if stacked_num % 2 != 1:
        raise ValueError("stacked_num must be odd, got %d" % stacked_num)
    emb = layers.embedding(input=data, size=[input_dim, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim, num_flatten_dims=2)
        lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type='max')
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max')
    prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act='softmax')
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(x=cost)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction


def build(input_dim, net='conv', class_dim=2):
    """Returns (data, label, avg_cost, acc, prediction); ``net`` is
    'conv', 'dynamic_lstm' or 'stacked_lstm'."""
    data = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    fn = {'conv': convolution_net, 'dynamic_lstm': dynamic_lstm_net,
          'stacked_lstm': stacked_lstm_net}[net]
    avg_cost, acc, prediction = fn(data, label, input_dim,
                                   class_dim=class_dim)
    return data, label, avg_cost, acc, prediction

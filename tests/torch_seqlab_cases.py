"""The seeded numpy inputs of the sequence-labelling slice's op tests
(tests/test_torch_{crf,ctc,sequence_ops,metrics_ops}.py), shared with
``chip_smoke.py``'s op sweep, which runs the same cases on the card.
numpy only: no JAX, no torch.

Each case is (op type, {slot: [arrays]}, attrs); int arrays are int64,
as a feeder makes them (both executors narrow them to int32).
"""
import numpy as np

__all__ = ['CRF_LENGTHS', 'crf_case', 'CTC_CASES', 'ctc_case',
           'SEQUENCE_CASES', 'SEQUENCE_GRAD_CASES', 'CHUNK_SCHEMES',
           'chunk_case', 'EDIT_CASES', 'edit_case', 'precision_recall_case',
           'pos_neg_case', 'sweep_cases']

# ---------------------------------------------------------------- CRF
CRF_B, CRF_T, CRF_N = 4, 7, 5
CRF_LENGTHS = {
    'ones': [1, 1, 1, 1],
    'full': [CRF_T] * 4,
    'mixed': [CRF_T, 1, 4, 6],
}


def crf_case(kind, seed=0, coarse=False):
    """Emission [4, 7, 5], Transition [7, 5], Label [4, 7, 1] (drawn on
    the padding too) and EmissionLen; ``coarse`` rounds the scores so the
    Viterbi max has exact ties."""
    rng = np.random.default_rng(seed)
    emission = rng.standard_normal((CRF_B, CRF_T, CRF_N)).astype(np.float32)
    transition = rng.standard_normal((CRF_N + 2, CRF_N)).astype(np.float32)
    if coarse:
        emission = np.round(emission)
        transition = np.round(transition)
    labels = rng.integers(0, CRF_N, (CRF_B, CRF_T, 1)).astype(np.int64)
    return {'Emission': [emission], 'Transition': [transition],
            'Label': [labels],
            'EmissionLen': [np.asarray(CRF_LENGTHS[kind], np.int64)]}


# ---------------------------------------------------------------- CTC
CTC_B, CTC_T, CTC_V, CTC_L = 4, 9, 6, 4
# name: (ctc_case kwargs, attrs)
CTC_CASES = {
    'plain': (dict(seed=0), {}),
    'norm_by_times': (dict(seed=1), {'norm_by_times': True}),
    'counted_label_lengths': (dict(seed=2, label_len=False), {}),
    'trailing_label_dim': (dict(seed=3, trailing=True), {}),
    'blank_5': (dict(seed=4, blank=5), {'blank': 5}),
}


def ctc_case(seed, label_len=True, trailing=False, blank=0):
    """Logits [4, 9, 6] of lengths 9, 5, 7, 3 against labels [4, 4] of
    lengths 4, 1, 3, 0 (row 2 repeats a label, so its skip is barred),
    none equal to ``blank``."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((CTC_B, CTC_T, CTC_V)).astype(np.float32)
    labels = np.zeros((CTC_B, CTC_L), np.int64)
    lens = np.asarray([4, 1, 3, 0], np.int64)
    for b, n in enumerate(lens):
        labels[b, :n] = rng.integers(1, CTC_V, n)
    labels[2, :3] = [3, 3, 2]
    if blank:
        labels[labels == blank] = CTC_V - 1 if blank != CTC_V - 1 else 1
    ins = {'Logits': [logits],
           'Label': [labels[..., None] if trailing else labels],
           'LogitsLen': [np.asarray([9, 5, 7, 3], np.int64)]}
    if label_len:
        ins['LabelLen'] = [lens]
    return ins


# ------------------------------------------------ LoD and sequence ops
def _sequence_cases():
    rng = np.random.default_rng(0)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def i64(*a):
        return np.asarray(a, np.int64)

    return {
        'expand_ragged': ('sequence_expand',
                          {'X': [f32(3, 4)], 'Y': [f32(3, 5, 1)],
                           'YLen': [i64(5, 0, 2)]}, {}),
        'expand_3d_no_len': ('sequence_expand',
                             {'X': [f32(2, 2, 3)], 'Y': [f32(2, 4)]}, {}),
        'concat_two': ('sequence_concat',
                       {'X': [f32(3, 4, 2), f32(3, 3, 2)],
                        'XLen': [i64(2, 4, 0), i64(3, 1, 2)]}, {}),
        'concat_three': ('sequence_concat',
                         {'X': [f32(2, 2, 3), f32(2, 5, 3), f32(2, 1, 3)],
                          'XLen': [i64(1, 2), i64(5, 0), i64(1, 1)]}, {}),
        'concat_no_len': ('sequence_concat',
                          {'X': [f32(2, 3), f32(2, 2)]}, {}),
        'slice': ('sequence_slice',
                  {'X': [f32(4, 6, 2)], 'Offset': [i64(1, 0, 5, 3)],
                   'Length': [i64(2, 3, 1, 0)]}, {'max_length': 3}),
        'slice_clamped': ('sequence_slice',
                          {'X': [f32(3, 4, 2)], 'Offset': [i64(9, -2, 4)],
                           'Length': [i64(2, 4, 1)]}, {}),
        'erase': ('sequence_erase',
                  {'X': [np.asarray([[2, 1, 3, 1, 5], [1, 1, 2, 0, 0],
                                     [4, 4, 4, 4, 4]], np.int64)],
                   'XLen': [i64(5, 3, 0)]}, {'tokens': [1, 4]}),
        'erase_all': ('sequence_erase',
                      {'X': [np.asarray([[1, 1, 7]], np.int64)]},
                      {'tokens': [1, 7]}),
        'erase_none': ('sequence_erase',
                       {'X': [np.asarray([[3, 2, 5], [6, 0, 0]], np.int64)],
                        'XLen': [i64(3, 1)]}, {'tokens': []}),
        'lod_reset_attr': ('lod_reset', {'X': [f32(3, 4)]},
                           {'target_lod': [2, 4, 1]}),
        'lod_reset_y': ('lod_reset', {'X': [f32(2, 3, 2)],
                                      'Y': [i64(3, 1)]}, {}),
        'one_hot': ('one_hot', {'X': [i64([[0], [3], [5], [-1], [2]])]},
                    {'depth': 4}),
        'one_hot_seq': ('one_hot',
                        {'X': [rng.integers(0, 6, (2, 3, 1))]},
                        {'depth': 6}),
        'sequence_reshape': ('sequence_reshape', {'X': [f32(2, 6, 4)]},
                             {'new_dim': 8}),
        'im2sequence': ('im2sequence', {'X': [f32(2, 3, 5, 6)]},
                        {'kernels': [2, 3], 'strides': [1, 2],
                         'paddings': [0, 1, 1, 0]}),
        'im2sequence_sym': ('im2sequence', {'X': [f32(1, 2, 4, 4)]},
                            {'kernels': [3, 3], 'strides': [1, 1],
                             'paddings': [1, 1]}),
        'row_conv_1': ('row_conv', {'X': [f32(2, 5, 3)],
                                    'Filter': [f32(1, 3)]}, {}),
        'row_conv_4': ('row_conv', {'X': [f32(3, 6, 4)],
                                    'Filter': [f32(4, 4)]}, {}),
    }


SEQUENCE_CASES = _sequence_cases()
SEQUENCE_GRAD_CASES = ['expand_ragged', 'concat_three', 'slice',
                       'im2sequence', 'row_conv_4']

# ------------------------------------------------------------ metrics
CHUNK_SCHEMES = {'plain': 1, 'IOB': 2, 'IOE': 2, 'IOBES': 4}


def chunk_case(scheme, num_types, seed):
    """Inference and Label [6, 12, 1] over every tag of ``scheme`` (the
    last one outside), 30% of the inference redrawn, rows of lengths 12,
    7, 0, 1, 12, 9."""
    rng = np.random.default_rng(seed)
    n = CHUNK_SCHEMES[scheme] * num_types + 1
    label = rng.integers(0, n, (6, 12, 1)).astype(np.int64)
    inference = label.copy()
    flip = rng.random((6, 12, 1)) < 0.3
    inference[flip] = rng.integers(0, n, int(flip.sum()))
    return {'Inference': [inference], 'Label': [label],
            'XLen': [np.asarray([12, 7, 0, 1, 12, 9], np.int64)]}


EDIT_CASES = {
    'ragged': ([[1, 2, 3, 0], [4, 5, 0, 0], [7, 7, 7, 7]],
               [[1, 3, 3, 2, 9], [4, 5, 6, 0, 0], [7, 0, 0, 0, 0]],
               [3, 2, 4], [4, 3, 1]),
    'empty_rows': ([[0, 0], [3, 1]], [[5, 6, 2], [0, 0, 0]], [0, 2],
                   [3, 0]),
    'no_lengths': (np.random.default_rng(7).integers(0, 4, (5, 6)),
                   np.random.default_rng(8).integers(0, 4, (5, 4)),
                   None, None),
}


def edit_case(name):
    hyp, ref, hl, rl = EDIT_CASES[name]
    ins = {'Hyps': [np.asarray(hyp, np.int64)],
           'Refs': [np.asarray(ref, np.int64)]}
    if hl is not None:
        ins['HypsLen'] = [np.asarray(hl, np.int64)]
        ins['RefsLen'] = [np.asarray(rl, np.int64)]
    return ins


def precision_recall_case(classes):
    """20 predictions and labels over ``classes`` classes; the op is given
    one class more, which never occurs."""
    rng = np.random.default_rng(classes)
    return ({'MaxProbs': [rng.random((20, 1)).astype(np.float32)],
             'Indices': [rng.integers(0, classes, (20, 1)).astype(np.int64)],
             'Labels': [rng.integers(0, classes, (20, 1)).astype(np.int64)]},
            {'class_number': classes + 1})


def pos_neg_case():
    """30 scores rounded to 0.1 (ties), labels 0-2, 4 queries."""
    rng = np.random.default_rng(11)
    return {'Score': [np.round(rng.random((30, 1)), 1).astype(np.float32)],
            'Label': [rng.integers(0, 3, (30, 1)).astype(np.float32)],
            'QueryID': [rng.integers(0, 4, (30, 1)).astype(np.int64)]}


def sweep_cases():
    """[(name, op, ins, attrs)]: every case above, each of the 16 op
    types at least once."""
    out = []
    for kind in CRF_LENGTHS:
        for coarse in (False, True):
            ins = crf_case(kind, seed=3, coarse=coarse)
            out.append(('crf_%s_%s' % (kind, 'coarse' if coarse else 'fine'),
                        'linear_chain_crf', ins, {}))
            out.append(('viterbi_%s_%s' % (kind, 'coarse' if coarse
                                            else 'fine'),
                        'crf_decoding', {k: v for k, v in ins.items()
                                         if k != 'Label'}, {}))
            out.append(('viterbi_label_%s_%s' % (
                kind, 'coarse' if coarse else 'fine'), 'crf_decoding', ins,
                {}))
    for name, (kw, attrs) in CTC_CASES.items():
        out.append(('ctc_' + name, 'warpctc', ctc_case(**kw), attrs))
    for name, (op, ins, attrs) in SEQUENCE_CASES.items():
        out.append((name, op, ins, attrs))
    for scheme in CHUNK_SCHEMES:
        for excluded in (None, [1], [0, 2]):
            out.append(('chunk_%s_%s' % (scheme, excluded), 'chunk_eval',
                        chunk_case(scheme, 3, 0),
                        {'chunk_scheme': scheme, 'num_chunk_types': 3,
                         'excluded_chunk_types': excluded}))
    for name in EDIT_CASES:
        for normalized in (True, False):
            out.append(('edit_%s_%s' % (name, normalized), 'edit_distance',
                        edit_case(name), {'normalized': normalized}))
    for classes in (3, 5):
        ins, attrs = precision_recall_case(classes)
        out.append(('precision_recall_%d' % classes, 'precision_recall',
                    ins, attrs))
    out.append(('pos_neg_pair', 'positive_negative_pair', pos_neg_case(),
                {}))
    return out

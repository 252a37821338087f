"""Beam-search layers.

Reference parity: paddle_tpu/layers/beam_search.py (fluid.layers.
beam_search / beam_search_decode; paddle/operators/beam_search_op.cc,
beam_search_decode_op.cc).  Beams live in a dense [B, K] lattice
(ops/beam_search.py): ``beam_search`` takes the top K of the K * V
continuations, ``beam_gather`` reorders per-beam decoder state by parent,
and ``beam_search_decode`` backtracks the [T, B, K] parent lattice.
"""
from .layer_helper import LayerHelper

__all__ = ['beam_search', 'beam_search_decode', 'beam_search_init',
           'beam_gather']


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, name=None,
                **kwargs):
    """One pruning step over next-token log-probs.

    pre_ids/pre_scores: [B, K] current beams; scores: [B, K, V] log-probs
    for each continuation.  Returns (selected_ids [B, K],
    selected_scores [B, K], parent_idx [B, K]).  Finished beams (that
    already emitted `end_id`) freeze their score and only propose
    `end_id`, matching beam_search_op.cc's pruning of ended hypotheses.
    """
    helper = LayerHelper('beam_search', name=name, **kwargs)
    ids = helper.create_tmp_variable('int64')
    sel_scores = helper.create_tmp_variable('float32')
    parents = helper.create_tmp_variable('int64')
    helper.append_op(
        type='beam_search',
        inputs={'pre_ids': [pre_ids], 'pre_scores': [pre_scores],
                'scores': [scores]},
        outputs={'selected_ids': [ids], 'selected_scores': [sel_scores],
                 'parent_idx': [parents]},
        attrs={'beam_size': int(beam_size), 'end_id': int(end_id)})
    for v in (ids, sel_scores, parents):
        v.stop_gradient = True
    return ids, sel_scores, parents


def beam_search_decode(ids, parents, scores, end_id, **kwargs):
    """Backtrack the per-step lattices into full sequences.

    ids/parents/scores are tensor arrays (or stacked [T, B, K] tensors)
    written once per step.  Returns (sentence_ids [B, K, T] end_id-padded,
    sentence_scores [B, K]) ordered best-first along K — the dense
    counterpart of beam_search_decode_op.cc's LoD sentence assembly.
    """
    helper = LayerHelper('beam_search_decode', **kwargs)
    seq_ids = helper.create_tmp_variable('int64')
    seq_scores = helper.create_tmp_variable('float32')
    helper.append_op(
        type='beam_search_decode',
        inputs={'Ids': [ids], 'Parents': [parents], 'Scores': [scores]},
        outputs={'SentenceIds': [seq_ids], 'SentenceScores': [seq_scores]},
        attrs={'end_id': int(end_id)})
    seq_ids.stop_gradient = True
    seq_scores.stop_gradient = True
    return seq_ids, seq_scores


def beam_search_init(ref, beam_size, start_id, **kwargs):
    """Seed beams: ids [B, K] = start_id; scores [B, K] = [0, -inf, ...]
    so the first expansion comes from a single live beam.  `ref` supplies
    the batch dimension (any [B, ...] tensor)."""
    helper = LayerHelper('beam_search_init', **kwargs)
    ids = helper.create_tmp_variable('int64')
    scores = helper.create_tmp_variable('float32')
    helper.append_op(
        type='beam_search_init',
        inputs={'X': [ref]},
        outputs={'Ids': [ids], 'Scores': [scores]},
        attrs={'beam_size': int(beam_size), 'start_id': int(start_id)})
    ids.stop_gradient = True
    scores.stop_gradient = True
    return ids, scores


def beam_gather(x, index, **kwargs):
    """Reorder per-beam state `x` [B, K, ...] by `index` [B, K] (the
    parent_idx from `beam_search`) so decoder state follows its beam."""
    helper = LayerHelper('beam_gather', **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type='beam_gather',
        inputs={'X': [x], 'Index': [index]},
        outputs={'Out': [out]})
    return out

"""Beam-search ops.

Reference parity: paddle_tpu/ops/beam_search.py (paddle/operators/
beam_search_op.cc, beam_search_decode_op.cc).  Beams live in a dense
[B, K] lattice: one step takes the top K of the K * V continuations of
each source, a finished beam (its last id ``end_id``) keeps its score and
proposes only ``end_id``, per-beam state follows its beam through
``beam_gather``, and the decode backtracks the [T, B, K] parent lattice.

Ties.  ``lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order; equal values are common here (step 1
adds ``NEG_INF`` to every log-prob of beams 1..K-1, which rounds to
exactly -1e9 in float32, and a finished beam's other candidates are all
``NEG_INF``).  ``_top_k`` sorts stably, so the lower flat index wins a tie
as in the reference.  Ids and parents are int32, as the reference's.
"""
import torch

from ..core.registry import register_op
from .common import first
from .tensor_array import TArray

__all__ = ['beam_search_step', 'beam_search_backtrack', 'NEG_INF']

NEG_INF = -1e9


def _top_k(x, k):
    """The k largest entries of each row of ``x`` [B, N], in descending
    order, ties to the lower index (``lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def beam_search_step(pre_ids, pre_scores, scores, beam_size, end_id):
    """One pruning step.  pre_ids, pre_scores: [B, K]; scores: [B, K, V]
    log-probs of the next token.  Returns (ids [B, K], accumulated scores
    [B, K], parents [B, K])."""
    B, K, V = scores.shape
    finished = pre_ids == end_id
    total = pre_scores[:, :, None] + scores.float()
    # a finished beam's only candidate is end_id, at its frozen score
    fin = torch.full_like(total, NEG_INF)
    fin[:, :, end_id] = pre_scores
    total = torch.where(finished[:, :, None], fin, total)
    top_scores, top_idx = _top_k(total.reshape(B, K * V), beam_size)
    parents = torch.div(top_idx, V, rounding_mode='floor')
    ids = top_idx - parents * V
    return ids.to(torch.int32), top_scores, parents.to(torch.int32)


@register_op('beam_search')
def _beam_search(ctx, ins, attrs):
    pre_ids = first(ins, 'pre_ids')
    pre_scores = first(ins, 'pre_scores')
    scores = first(ins, 'scores')
    beam_size = int(attrs['beam_size'])
    end_id = int(attrs['end_id'])
    if pre_ids.dim() == 3:
        pre_ids = pre_ids[..., 0]
    if pre_scores.dim() == 3:
        pre_scores = pre_scores[..., 0]
    ids, sc, parents = beam_search_step(pre_ids, pre_scores, scores,
                                        beam_size, end_id)
    return {'selected_ids': [ids], 'selected_scores': [sc],
            'parent_idx': [parents]}


def beam_search_backtrack(ids_tbk, parents_tbk, steps, end_id):
    """ids, parents: [T, B, K] lattices; steps: the number of valid steps
    (a 0-d tensor, never read on the host).  Returns the sequences
    [B, K, T], end_id past ``steps``, best first."""
    T, B, K = ids_tbk.shape
    device = ids_tbk.device
    valid = torch.arange(T, device=device) < steps
    ptr = torch.arange(K, device=device).repeat(B, 1)
    end = torch.full((B, K), end_id, dtype=ids_tbk.dtype, device=device)
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        tok = ids_tbk[t].gather(1, ptr)
        par = parents_tbk[t].gather(1, ptr).to(torch.int64)
        toks[t] = torch.where(valid[t], tok, end)
        ptr = torch.where(valid[t], par, ptr)
    return torch.stack(toks, dim=2)


@register_op('beam_search_init')
def _beam_search_init(ctx, ins, attrs):
    """The lattice's start: ids [B, K] all ``start_id``; scores [B, K] 0 in
    column 0 and NEG_INF elsewhere, so step 1 expands one beam (the
    reference's LoD nesting grows real beams lazily)."""
    ref = first(ins, 'X')   # any [B, ...] tensor: the batch size
    beam_size = int(attrs['beam_size'])
    start_id = int(attrs['start_id'])
    B = ref.shape[0]
    ids = torch.full((B, beam_size), start_id, dtype=torch.int32,
                     device=ref.device)
    scores = torch.full((B, beam_size), NEG_INF, dtype=torch.float32,
                        device=ref.device)
    scores[:, 0] = 0.0
    return {'Ids': [ids], 'Scores': [scores]}


@register_op('beam_gather')
def _beam_gather(ctx, ins, attrs):
    """Per-beam state ``X`` [B, K, ...] reordered by parent indices
    ``Index`` [B, K]: the reference's host-side state shuffle."""
    x = first(ins, 'X')
    idx = first(ins, 'Index').to(torch.int64)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return {'Out': [x.gather(1, idx.expand(
        tuple(idx.shape[:2]) + tuple(x.shape[2:])))]}


@register_op('beam_search_decode')
def _beam_search_decode(ctx, ins, attrs):
    ids_arr = first(ins, 'Ids')   # a TArray [T, B, K], or a stacked tensor
    parents_arr = first(ins, 'Parents')
    scores_arr = first(ins, 'Scores')
    end_id = int(attrs['end_id'])
    if isinstance(ids_arr, TArray):
        steps = ids_arr.size
        ids_tbk, parents_tbk = ids_arr.data, parents_arr.data
    else:
        ids_tbk, parents_tbk = ids_arr, parents_arr
        steps = torch.full((), ids_tbk.shape[0], dtype=torch.int32,
                           device=ids_tbk.device)
    seqs = beam_search_backtrack(ids_tbk, parents_tbk, steps, end_id)
    if isinstance(scores_arr, TArray):
        last = torch.clamp(scores_arr.size - 1, min=0).to(torch.int64)
        final_scores = scores_arr.data.index_select(
            0, last.reshape(1)).squeeze(0)   # [B, K]
    else:
        final_scores = scores_arr[-1]
    return {'SentenceIds': [seqs], 'SentenceScores': [final_scores]}

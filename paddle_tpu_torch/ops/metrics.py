"""Metric ops (paddle_tpu/ops/metrics.py; paddle/operators/{accuracy,
auc,precision_recall,edit_distance,positive_negative_pair,chunk_eval}_op).
Each computes on its inputs' device; counts are exact integers.
"""
import torch

from ..core.registry import register_op
from .common import first
from .sequence import _lengths, _time_mask


@register_op('accuracy')
def _accuracy(ctx, ins, attrs):
    """Share of rows whose int label is among the top-k ``Indices`` (from
    a top_k op); also the counts Correct and Total."""
    idx = first(ins, 'Indices').to(torch.int32)
    label = first(ins, 'Label').to(torch.int32)
    if label.dim() == 2 and label.shape[1] == 1:
        label = label[:, 0]
    hit = (idx == label[:, None]).any(dim=1)
    total = torch.full((1,), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    correct = hit.sum().to(torch.int32).reshape(1)
    acc = correct.float() / total.float()
    return {'Accuracy': [acc], 'Correct': [correct], 'Total': [total]}


@register_op('auc')
def _auc(ctx, ins, attrs):
    """The batch's ROC AUC over ``num_thresholds`` thresholds (auc_op.h's
    200), with no streaming state: the score is column 1 of a two-column
    probability input (else the input flattened), each threshold's true
    and false positive rates come from counts, and the area is the
    trapezoid over the thresholds in decreasing order.  Not
    differentiable."""
    probs = first(ins, 'Out').float()
    label = first(ins, 'Label').to(torch.int32).reshape(-1)
    if probs.dim() == 2 and probs.shape[1] == 2:
        score = probs[:, 1]
    else:
        score = probs.reshape(-1)
    num_t = int(attrs.get('num_thresholds', 200))
    thresholds = (torch.arange(num_t, dtype=torch.float32,
                               device=probs.device) + 0.5) / num_t
    pos = label == 1
    above = score[None, :] >= thresholds[:, None]
    tp = (above & pos[None, :]).sum(dim=1).float()
    fp = (above & ~pos[None, :]).sum(dim=1).float()
    npos = torch.clamp(pos.sum().float(), min=1e-6)
    nneg = torch.clamp((~pos).sum().float(), min=1e-6)
    auc = -torch.trapezoid(tp / npos, fp / nneg)
    return {'AUC': [auc.abs().reshape(1)]}


@register_op('precision_recall')
def _precision_recall(ctx, ins, attrs):
    """The batch's per-class precision, recall and F1, their macro means
    and the micro figures from the summed counts: BatchMetrics [1, 6]
    (macro p, r, f1, micro p, r, f1), AccumMetrics the same (no
    streaming state), AccumStatesInfo [C, 4] (tp, fp, fn, 0)."""
    num_classes = attrs['class_number']
    first(ins, 'MaxProbs')   # a declared slot whose values are not used
    pred = first(ins, 'Indices').to(torch.int32).reshape(-1)
    label = first(ins, 'Labels').to(torch.int32).reshape(-1)
    cls = torch.arange(num_classes, device=pred.device)[:, None]
    pred_is = pred[None, :] == cls
    lab_is = label[None, :] == cls
    tp = (pred_is & lab_is).sum(dim=1).float()
    fp = (pred_is & ~lab_is).sum(dim=1).float()
    fn = (~pred_is & lab_is).sum(dim=1).float()
    prec = tp / torch.clamp(tp + fp, min=1e-6)
    rec = tp / torch.clamp(tp + fn, min=1e-6)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-6)
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    mprec = stp / torch.clamp(stp + sfp, min=1e-6)
    mrec = stp / torch.clamp(stp + sfn, min=1e-6)
    mf1 = 2 * mprec * mrec / torch.clamp(mprec + mrec, min=1e-6)
    metrics = torch.stack([prec.mean(), rec.mean(), f1.mean(), mprec, mrec,
                           mf1]).reshape(1, 6)
    states = torch.stack([tp, fp, fn, tp * 0], dim=1)
    return {'BatchMetrics': [metrics], 'AccumMetrics': [metrics],
            'AccumStatesInfo': [states]}


@register_op('edit_distance')
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance of each padded hypothesis row [B, M] to its
    reference row [B, N] (operators/edit_distance_op), over the rows'
    lengths (``HypsLen``, ``RefsLen``): Out [B, 1] float32, divided by
    the reference's length (at least 1) when ``normalized``, and
    SequenceNum [1].  One pass a hypothesis step for the whole batch:
    the DP row's left-to-right chain ``d[j] = min(d[j - 1] + 1, c[j])``
    is ``j + cummin(c[k] - k)``, exact in float32 for these integers."""
    hyp = first(ins, 'Hyps').to(torch.int32)
    ref = first(ins, 'Refs').to(torch.int32)
    if hyp.dim() == 1:
        hyp, ref = hyp[None, :], ref[None, :]
    b, m = hyp.shape
    n = ref.shape[1]
    dev = hyp.device
    hyp_len = _lengths(ins, hyp, 'HypsLen')
    ref_len = _lengths(ins, ref, 'RefsLen')
    cols = torch.arange(n + 1, device=dev)
    colsf = cols.float()[None, :]
    inf = torch.full((), float('inf'), device=dev)
    row = torch.where(cols[None, :] <= ref_len[:, None], colsf, inf)
    for i in range(m):
        sub = row[:, :-1] + (ref != hyp[:, i:i + 1]).float()
        cand = torch.cat([torch.full((b, 1), i + 1.0, device=dev),
                          torch.minimum(row[:, 1:] + 1, sub)], dim=1)
        new = torch.cummin(cand - colsf, dim=1).values + colsf
        row = torch.where((i < hyp_len)[:, None], new, row)
    d = torch.gather(row, 1, ref_len[:, None])[:, 0]
    if attrs.get('normalized', True):
        d = d / torch.clamp(ref_len.float(), min=1.0)
    return {'Out': [d.reshape(b, 1)],
            'SequenceNum': [torch.full((1,), b, dtype=torch.int32,
                                       device=dev)]}


@register_op('positive_negative_pair')
def _pos_neg_pair(ctx, ins, attrs):
    """Over the pairs of one query with a higher label first: those the
    scores order the same way (positive), the other way (negative), and
    ties (neutral, half to each); the ratio of positive to negative."""
    score = first(ins, 'Score').float().reshape(-1)
    label = first(ins, 'Label').float().reshape(-1)
    qid = first(ins, 'QueryID').to(torch.int32).reshape(-1)
    mask = (qid[:, None] == qid[None, :]) & (label[:, None] > label[None, :])
    si, sj = score[:, None], score[None, :]
    neu = (mask & (si == sj)).sum().float()
    pos = (mask & (si > sj)).sum().float() + 0.5 * neu
    neg = (mask & (si < sj)).sum().float() + 0.5 * neu
    ratio = pos / torch.clamp(neg, min=1e-6)
    return {'PositivePair': [pos.reshape(1)],
            'NegativePair': [neg.reshape(1)],
            'NeutralPair': [neu.reshape(1)],
            'PositiveRatio': [ratio.reshape(1)]}


def _shift_right(v, fill):
    pad = torch.full((v.shape[0], 1), fill, dtype=v.dtype, device=v.device)
    return torch.cat([pad, v[:, :-1]], dim=1)


def _shift_left(v, fill):
    pad = torch.full((v.shape[0], 1), fill, dtype=v.dtype, device=v.device)
    return torch.cat([v[:, 1:], pad], dim=1)


def _chunk_flags(tags, num_chunk_types, scheme, valid):
    """Per step of a [B, T] tag batch: (in a chunk, its type, a chunk
    starts, a chunk ends) under the plain, IOB, IOE or IOBES scheme, with
    the reference's tag convention: kind = tag % n_tag, type = tag //
    n_tag, outside from num_chunk_types * n_tag on."""
    if scheme == 'plain':
        kind = torch.zeros_like(tags)
        ctype = tags
        outside = tags >= num_chunk_types
    else:
        n_tag = {'IOB': 2, 'IOE': 2, 'IOBES': 4}[scheme]
        kind = tags % n_tag
        ctype = tags // n_tag
        outside = tags >= num_chunk_types * n_tag
    in_chunk = ~outside & valid
    ctype = torch.where(in_chunk, ctype, torch.full_like(ctype, -1))
    prev_in = _shift_right(in_chunk, False)
    next_in = _shift_left(in_chunk, False)
    boundary_prev = ~prev_in | (_shift_right(ctype, -1) != ctype)
    boundary_next = ~next_in | (_shift_left(ctype, -1) != ctype)
    if scheme == 'plain':
        start = in_chunk & boundary_prev
        end = in_chunk & boundary_next
    elif scheme == 'IOB':   # B=0, I=1
        start = in_chunk & ((kind == 0) | boundary_prev)
        end = in_chunk & (boundary_next |
                          (next_in & (_shift_left(kind, 0) == 0)))
    elif scheme == 'IOE':   # I=0, E=1
        prev_ended = prev_in & (_shift_right(kind, 0) == 1)
        start = in_chunk & (boundary_prev | prev_ended)
        end = in_chunk & ((kind == 1) | boundary_next)
    else:   # IOBES: B=0, I=1, E=2, S=3
        start = in_chunk & ((kind == 0) | (kind == 3) | boundary_prev)
        end = in_chunk & ((kind == 2) | (kind == 3) | boundary_next)
    return in_chunk, ctype, start, end


@register_op('chunk_eval')
def _chunk_eval(ctx, ins, attrs):
    """Chunk precision, recall and F1 of Inference against Label [B, T]
    (or [B, T, 1]) over the lengths XLen (operators/chunk_eval_op), and
    the three counts.  A chunk is correct when both sides start it at the
    same step with the same type, agree on (in a chunk, type) at every
    step of the label's chunk and end it at the same step.  Chunks of an
    ``excluded_chunk_types`` type are not counted."""
    inference = first(ins, 'Inference').to(torch.int32)
    label = first(ins, 'Label').to(torch.int32)
    if inference.dim() == 3:
        inference = inference[..., 0]
    if label.dim() == 3:
        label = label[..., 0]
    b, t = label.shape
    dev = label.device
    lengths = _lengths(ins, label)
    steps = torch.arange(t, device=dev)
    valid = _time_mask(lengths, t, 2)
    scheme = attrs.get('chunk_scheme', 'IOB')
    num_types = attrs['num_chunk_types']
    excluded = list(attrs.get('excluded_chunk_types') or [])

    def kept(ty):
        # compared one type at a time: no host-to-device copy of the list
        keep = torch.ones_like(ty, dtype=torch.bool)
        for e in excluded:
            keep = keep & (ty != e)
        return keep

    i_in, i_ty, i_st, i_en = _chunk_flags(inference, num_types, scheme,
                                          valid)
    l_in, l_ty, l_st, l_en = _chunk_flags(label, num_types, scheme, valid)
    num_infer = (i_st & kept(i_ty)).sum()
    num_label = (l_st & kept(l_ty)).sum()

    agree = (i_in == l_in) & (i_ty == l_ty)
    both_start = i_st & l_st & agree & kept(l_ty)
    both_end = i_en & l_en & agree
    mis_cum = torch.cumsum((~agree).to(torch.int32), dim=1)
    # for each start s, the first step e >= s where both end; the span is
    # correct when no step of [s, e] disagrees
    cand = torch.where((steps[None, None, :] >= steps[None, :, None]) &
                       both_end[:, None, :], steps[None, None, :],
                       torch.full((), t, device=dev))
    ends = cand.amin(dim=2)   # [B, T]
    at_end = torch.gather(mis_cum, 1, torch.clamp(ends, max=t - 1))
    before = torch.where(steps[None, :] > 0, torch.gather(
        mis_cum, 1, torch.clamp(steps - 1, min=0).expand(b, t)),
        torch.zeros((), dtype=mis_cum.dtype, device=dev))
    span_clean = (ends < t) & (at_end - before == 0)
    num_correct = (both_start & span_clean).sum()

    num_infer_f = num_infer.float()
    num_label_f = num_label.float()
    num_correct_f = num_correct.float()
    precision = num_correct_f / torch.clamp(num_infer_f, min=1e-6)
    recall = num_correct_f / torch.clamp(num_label_f, min=1e-6)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-6)
    return {
        'Precision': [precision.reshape(1)],
        'Recall': [recall.reshape(1)],
        'F1-Score': [f1.reshape(1)],
        'NumInferChunks': [num_infer.to(torch.int32).reshape(1)],
        'NumLabelChunks': [num_label.to(torch.int32).reshape(1)],
        'NumCorrectChunks': [num_correct.to(torch.int32).reshape(1)],
    }

"""Linear-chain CRF ops: ``linear_chain_crf`` and ``crf_decoding``.

Reference parity: paddle_tpu/ops/crf.py (paddle/operators/
linear_chain_crf_op and crf_decoding_op).  Emissions are padded [B, T, N]
with lengths [B] (slot ``EmissionLen``); the forward (log-partition)
recursion and the Viterbi recursion each walk T once for the whole batch,
as the reference's ``lax.scan`` does, and a masked step carries its state
through unchanged, so the padded tail contributes nothing.  Everything
stays on the tensors' device; the loss's gradient comes from autograd
through the recursion, as the reference's comes from ``jax.grad``.

Transition layout (the reference's): [N + 2, N], row 0 the start scores,
row 1 the end scores, rows 2.. the N x N transitions.
"""
import torch

from ..core.registry import register_op
from .common import first
from .sequence import _lengths, _time_mask

__all__ = ['crf_nll', 'crf_viterbi']


def crf_nll(emission, lengths, transition, labels):
    """The negative log-likelihood of each sequence's labels, [B] float32.
    The gold path ends at ``max(len - 1, 0)``, as the reference's."""
    b, t, _ = emission.shape
    emission = emission.float()
    transition = transition.float()
    start, end, trans = transition[0], transition[1], transition[2:]
    labels = labels.long()
    lengths = lengths.long()
    mask = _time_mask(lengths, t, 2)

    alpha = start[None, :] + emission[:, 0, :]
    for s in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + emission[:, s, :]
        alpha = torch.where(mask[:, s, None], new, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)

    zero = torch.zeros((), device=emission.device)
    emit = torch.gather(emission, 2, labels[:, :, None])[..., 0]
    emit_sum = torch.where(mask, emit, zero).sum(dim=1)
    steps = trans[labels[:, :-1], labels[:, 1:]]
    trans_sum = torch.where(mask[:, 1:], steps, zero).sum(dim=1)
    last_idx = torch.clamp(lengths - 1, min=0)
    last_label = torch.gather(labels, 1, last_idx[:, None])[:, 0]
    gold = emit_sum + trans_sum + start[labels[:, 0]] + end[last_label]
    return log_z - gold


def crf_viterbi(emission, lengths, transition):
    """The best path of each sequence, [B, T] int32, zeros past its
    length.  Ties go to the lowest tag, as ``jnp.argmax``'s; past a
    sequence's end the backpointer is the identity, so the backtrace
    passes through the padding to the last valid step."""
    b, t, n = emission.shape
    emission = emission.float()
    transition = transition.float()
    start, end, trans = transition[0], transition[1], transition[2:]
    mask = _time_mask(lengths.long(), t, 2)
    ident = torch.arange(n, device=emission.device)[None, :]

    delta = start[None, :] + emission[:, 0, :]
    bps = []
    for s in range(1, t):
        scores = delta[:, :, None] + trans[None, :, :]   # [B, prev, cur]
        m = mask[:, s, None]
        new = scores.amax(dim=1) + emission[:, s, :]
        bps.append(torch.where(m, scores.argmax(dim=1), ident))
        delta = torch.where(m, new, delta)
    tag = (delta + end[None, :]).argmax(dim=1)
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1).to(torch.int32)
    return torch.where(mask, path, torch.zeros_like(path))


def _label2d(label):
    return label[..., 0] if label.dim() == 3 else label


@register_op('linear_chain_crf')
def _linear_chain_crf(ctx, ins, attrs):
    """Emission [B, T, N], Transition [N + 2, N], Label [B, T] (or [B, T,
    1]) -> LogLikelihood [B, 1], the negative log-likelihood (the
    reference's name)."""
    emission = first(ins, 'Emission')
    nll = crf_nll(emission, _lengths(ins, emission, 'EmissionLen'),
                  first(ins, 'Transition'), _label2d(first(ins, 'Label')))
    return {'LogLikelihood': [nll[:, None]]}


@register_op('crf_decoding')
def _crf_decoding(ctx, ins, attrs):
    """ViterbiPath [B, T, 1] int32; with a ``Label``, 1 where the Viterbi
    tag equals the label and 0 elsewhere and on the padding
    (crf_decoding_op.h's ``path[i] = label[i] == path[i]``)."""
    emission = first(ins, 'Emission')
    lengths = _lengths(ins, emission, 'EmissionLen')
    path = crf_viterbi(emission, lengths, first(ins, 'Transition'))
    label = first(ins, 'Label')
    if label is not None:
        mask = _time_mask(lengths, emission.shape[1], 2)
        hit = (path == _label2d(label).to(torch.int32)) & mask
        return {'ViterbiPath': [hit.to(torch.int32)[..., None]]}
    return {'ViterbiPath': [path[..., None]]}

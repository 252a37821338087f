"""CTC loss: ``warpctc``.

Reference parity: paddle_tpu/ops/ctc.py (paddle/operators/warpctc_op).
The alpha (forward) recursion in log space over the extended label
sequence (blank, l1, blank, l2, ..., blank), the whole batch at once, one
step a time step; a row whose logits have ended is frozen.  It runs on
the tensors' device, and its gradient comes from autograd, as the
reference's comes from ``jax.grad`` (warp-ctc's hand-written backward has
no counterpart in either package).
"""
import torch

from ..core.registry import register_op
from .common import first
from .sequence import _lengths

__all__ = ['ctc_loss']

_NEG_INF = -1e30


def _shift(v, k, fill):
    """v [B, S] moved k columns right, ``fill`` in the first k."""
    pad = torch.full((v.shape[0], k), fill, dtype=v.dtype, device=v.device)
    return torch.cat([pad, v], dim=1)[:, :v.shape[1]]


def ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank=0):
    """log_probs [B, T, V] (log-softmax applied), labels [B, L]: the
    negative log-likelihood of each row, [B]."""
    b, t, _ = log_probs.shape
    s = 2 * labels.shape[1] + 1
    dev = log_probs.device
    logit_lengths = logit_lengths.long()
    label_lengths = label_lengths.long()
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    can_skip = (ext != blank) & (ext != _shift(ext, 2, -1))
    neg = torch.full((), _NEG_INF, device=dev)

    first_emit = torch.gather(log_probs[:, 0], 1, ext)
    col1 = torch.where(label_lengths[:, None] > 0, first_emit[:, 1:2], neg)
    alpha = torch.cat([first_emit[:, :1], col1,
                       neg.expand(b, max(s - 2, 0))], dim=1)[:, :s]
    for step in range(1, t):
        merged = torch.logaddexp(alpha, _shift(alpha, 1, _NEG_INF))
        merged = torch.where(
            can_skip, torch.logaddexp(merged, _shift(alpha, 2, _NEG_INF)),
            merged)
        new = merged + torch.gather(log_probs[:, step], 1, ext)
        alpha = torch.where((step < logit_lengths)[:, None], new, alpha)
    final_s = 2 * label_lengths
    last = torch.gather(alpha, 1, final_s[:, None])[:, 0]
    second = torch.gather(alpha, 1,
                          torch.clamp(final_s - 1, min=0)[:, None])[:, 0]
    second = torch.where(label_lengths > 0, second, neg)
    return -torch.logaddexp(last, second)


@register_op('warpctc')
def _warpctc(ctx, ins, attrs):
    """Logits [B, T, V] (lengths ``LogitsLen``, default T), Label [B, L]
    or [B, L, 1] (lengths ``LabelLen``, default the count of labels above
    0) -> Loss [B, 1], divided by the logits' length with
    ``norm_by_times``; WarpCTCGrad is the log-softmax."""
    logits = first(ins, 'Logits')
    labels = first(ins, 'Label')
    label_len = first(ins, 'LabelLen')
    if labels.dim() == 3 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    b = logits.shape[0]
    if label_len is None:
        label_len = (labels > 0).sum(dim=1)
    logit_len = _lengths(ins, logits, 'LogitsLen')
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss = ctc_loss(lp, logit_len, labels, label_len.reshape(-1),
                    blank=attrs.get('blank', 0))
    if attrs.get('norm_by_times', False):
        loss = loss / torch.clamp(logit_len.float(), min=1.0)
    return {'Loss': [loss.reshape(b, 1)], 'WarpCTCGrad': [lp]}

"""Recurrent ops: ``lstm`` and ``lstm_unit``.

Reference parity: paddle_tpu/ops/rnn.py (paddle/operators/{lstm,
lstm_unit}_op).  A ragged batch is padded [B, T, ...] with lengths [B]
(XLen).  The ``lstm`` op takes one of two paths, chosen by its own attrs
exactly as the reference chooses (rnn.py :129-134): ``use_pallas`` with
the default activations and no H0 / C0 runs the fused time loop of
ops/kernels/lstm.py (the hand-written kernels on CUDA tensors, their plain
versions on CPU tensors); any other configuration runs the reference's
scan as an eager loop over T, which in the reference is ``lax.scan``
computed by XLA, not a Pallas kernel.  The reference's VMEM fit test is
not ported, and its ``pallas_interpret`` attr is ignored.

The two paths treat padding differently and agree on every valid output
and gradient: the kernel path runs unmasked over all T (lengths are
prefixes, so padded steps never reach a valid one), reversing each row's
valid prefix before it for ``is_reverse`` and zeroing the padded outputs
after it, which also zeroes their cotangents; the scan path freezes each
finished row's state.

``gru`` and ``gru_unit`` come with the seq2seq slice.
"""
import torch

from ..core.registry import register_op
from .common import first
from .kernels import lstm as lstm_kernels

_ACTS = {
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'relu': torch.relu,
    'identity': lambda v: v,
}


def _maybe_reverse(xf, lengths, is_reverse):
    """Reverse each row's valid prefix (the padded tail stays in place).
    Returns (x, rev_idx), rev_idx None when not reversing; the same gather
    applied to the outputs undoes it."""
    if not is_reverse:
        return xf, None
    b, t = xf.shape[0], xf.shape[1]
    idx = torch.arange(t, device=xf.device)
    ln = (torch.full((b,), t, dtype=torch.long, device=xf.device)
          if lengths is None else lengths.reshape(-1).long())
    rev_idx = torch.where(idx[None, :] < ln[:, None],
                          ln[:, None] - 1 - idx[None, :], idx[None, :])
    return _gather_time(xf, rev_idx), rev_idx


def _gather_time(v, idx):
    return torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[2]))


def _unreverse_and_mask(seqs, rev_idx, lengths, t):
    """Undo _maybe_reverse's gather and zero the steps at or past each
    row's length, for each [B, T, H] tensor of ``seqs``."""
    mask = None
    if lengths is not None:
        mask = (torch.arange(t, device=seqs[0].device)[None, :]
                < lengths.reshape(-1).long()[:, None])[..., None]
    outs = []
    for v in seqs:
        if rev_idx is not None:
            v = _gather_time(v, rev_idx)
        if mask is not None:
            v = torch.where(mask, v, torch.zeros_like(v))
        outs.append(v)
    return outs


def _kernel_path(attrs, h0, c0):
    return (attrs.get('use_pallas') and h0 is None and c0 is None and
            attrs.get('gate_activation', 'sigmoid') == 'sigmoid' and
            attrs.get('cell_activation', 'tanh') == 'tanh' and
            attrs.get('candidate_activation', 'tanh') == 'tanh')


@register_op('lstm')
def _lstm(ctx, ins, attrs):
    """Dynamic LSTM over a padded batch (operators/lstm_op.cc).  Input is
    the pre-projected gates [B, T, 4H]; Weight [H, 4H] the recurrent
    projection; Bias [1, 4H], or [1, 7H] with the peepholes (w_ic, w_fc,
    w_oc) after the gate bias; gate order (i, f, cand, o)."""
    x = first(ins, 'Input')
    w = first(ins, 'Weight').float()
    bias = first(ins, 'Bias')
    lengths = first(ins, 'XLen')
    h0 = first(ins, 'H0')
    c0 = first(ins, 'C0')
    b, t, four_h = x.shape
    h = four_h // 4
    if x.device.type == 'meta':   # build-time shape inference
        hs = torch.empty((b, t, h), dtype=x.dtype, device=x.device)
        return {'Hidden': [hs], 'Cell': [torch.empty_like(hs)]}
    use_peepholes = attrs.get('use_peepholes', True) and bias is not None \
        and bias.shape[-1] == 7 * h
    is_reverse = attrs.get('is_reverse', False)
    xf = x.float()
    if bias is not None:
        xf = xf + bias.float().reshape(-1)[:4 * h].reshape(1, 1, -1)
    pw = (bias.float().reshape(-1)[4 * h:7 * h].reshape(3, h)
          if use_peepholes else None)

    if _kernel_path(attrs, h0, c0):
        xin, rev_idx = _maybe_reverse(xf, lengths, is_reverse)
        hs, cs = lstm_kernels.lstm_scan(
            xin.transpose(0, 1).contiguous(), w, pw)
        hs, cs = _unreverse_and_mask(
            [hs.transpose(0, 1), cs.transpose(0, 1)], rev_idx, lengths, t)
        return {'Hidden': [hs.to(x.dtype)], 'Cell': [cs.to(x.dtype)]}

    ln = (torch.full((b,), t, dtype=torch.long, device=x.device)
          if lengths is None else lengths.reshape(-1).long())
    gate_act = _ACTS[attrs.get('gate_activation', 'sigmoid')]
    cell_act = _ACTS[attrs.get('cell_activation', 'tanh')]
    cand_act = _ACTS[attrs.get('candidate_activation', 'tanh')]
    rev_idx = None
    if is_reverse:
        xf, rev_idx = _maybe_reverse(xf, ln, True)
    h_p = (h0.float() if h0 is not None
           else torch.zeros((b, h), dtype=torch.float32, device=x.device))
    c_p = (c0.float() if c0 is not None
           else torch.zeros((b, h), dtype=torch.float32, device=x.device))
    hs, cs = [], []
    for s in range(t):
        g = xf[:, s] + torch.matmul(h_p, w)
        gi, gf, gc, go = torch.split(g, h, dim=1)
        if use_peepholes:
            gi = gi + c_p * pw[0]
            gf = gf + c_p * pw[1]
        i = gate_act(gi)
        f = gate_act(gf)
        c = f * c_p + i * cand_act(gc)
        if use_peepholes:
            go = go + c * pw[2]
        h_t = gate_act(go) * cell_act(c)
        alive = (s < ln)[:, None]
        h_p = torch.where(alive, h_t, h_p)
        c_p = torch.where(alive, c, c_p)
        hs.append(h_p)
        cs.append(c_p)
    hs, cs = _unreverse_and_mask(
        [torch.stack(hs, dim=1), torch.stack(cs, dim=1)], rev_idx, lengths,
        t)
    return {'Hidden': [hs.to(x.dtype)], 'Cell': [cs.to(x.dtype)]}


@register_op('lstm_unit')
def _lstm_unit(ctx, ins, attrs):
    """One LSTM cell step (operators/lstm_unit_op): X [B, 4H] gates and
    C_prev [B, H] -> (C, H).  Gate order (i, f, o, j), unlike ``lstm``."""
    x = first(ins, 'X').float()
    c_prev = first(ins, 'C_prev').float()
    forget_bias = attrs.get('forget_bias', 0.0)
    i, f, o, j = torch.chunk(x, 4, dim=1)
    c = torch.sigmoid(f + forget_bias) * c_prev + \
        torch.sigmoid(i) * torch.tanh(j)
    h = torch.sigmoid(o) * torch.tanh(c)
    dt = first(ins, 'X').dtype
    return {'C': [c.to(dt)], 'H': [h.to(dt)]}


def _gru_later(ctx, ins, attrs):
    raise NotImplementedError(
        "GRU ops come with the seq2seq slice (kernels #9 and #10): "
        "ROADMAP.md Queue 1")


register_op('gru')(_gru_later)
register_op('gru_unit')(_gru_later)

"""Recurrent ops: ``lstm``, ``lstm_unit``, ``gru`` and ``gru_unit``.

Reference parity: paddle_tpu/ops/rnn.py (paddle/operators/{lstm,
lstm_unit,gru,gru_unit}_op).  A ragged batch is padded [B, T, ...] with
lengths [B] (XLen).  The ``lstm`` and ``gru`` ops take one of two paths,
chosen by their own attrs and the hidden width as the reference chooses
(rnn.py :129-134, :240-244): ``use_pallas`` with the default activations
(and, for ``lstm``, no H0 / C0) at a width the kernels take runs the fused
time loop of ops/kernels/lstm.py or ops/kernels/gru.py (the hand-written
kernels on CUDA tensors, their plain versions on CPU tensors); any other
configuration runs the reference's scan as an eager loop over T, which in
the reference is ``lax.scan`` computed by XLA, not a Pallas kernel.  The
width test is the kernels' own (``kernel_takes``: the hidden width,
padded to a multiple of 4, within their shared-memory caps), the
analogue of the reference's VMEM fit test (``_pallas_rnn_fits_vmem``):
each sends only a width whose state its kernels cannot hold on chip to
the scan, on every device.  The reference's ``pallas_interpret`` attr is
ignored.  A bfloat16 or float16 Input (an AMP or low-precision build)
computes in float32 on both paths, and Hidden (and Cell) come back in
the Input's dtype, as the reference's ``x.astype(jnp.float32)`` and
``hs.astype(x.dtype)`` do; the kernels themselves take float32.

The two paths treat padding differently and agree on every valid output
and gradient: the kernel path runs unmasked over all T (lengths are
prefixes, so padded steps never reach a valid one), reversing each row's
valid prefix before it for ``is_reverse`` and zeroing the padded outputs
after it, which also zeroes their cotangents; the scan path freezes each
finished row's state.  With an initial state (the GRU's H0) the padded
steps come after the valid ones, so their zero cotangents leave the dh
chain at zero until the valid steps, and dH0 agrees too.
"""
import torch

from ..core.registry import register_op
from .common import first
from .kernels import gru as gru_kernels
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


def _kernel_path(attrs, h0, c0, h):
    return bool(attrs.get('use_pallas') and h0 is None and c0 is None and
                attrs.get('gate_activation', 'sigmoid') == 'sigmoid' and
                attrs.get('cell_activation', 'tanh') == 'tanh' and
                attrs.get('candidate_activation', 'tanh') == 'tanh' and
                lstm_kernels.kernel_takes(h))


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

    if _kernel_path(attrs, h0, c0, h):
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


def _gru_kernel_path(attrs, h):
    return bool(attrs.get('use_pallas') and
                attrs.get('gate_activation', 'sigmoid') == 'sigmoid' and
                attrs.get('activation', 'tanh') == 'tanh' and
                gru_kernels.kernel_takes(h))


@register_op('gru')
def _gru(ctx, ins, attrs):
    """Dynamic GRU over a padded batch (operators/gru_op.cc).  Input is the
    pre-projected gates [B, T, 3H]; Weight [H, 3H] packs the update and
    reset gates' [H, 2H] and the candidate's [H, H]; Bias [1, 3H] is added
    to the input; H0 [B, H] is the optional initial state."""
    x = first(ins, 'Input')
    w = first(ins, 'Weight').float()
    bias = first(ins, 'Bias')
    lengths = first(ins, 'XLen')
    h0 = first(ins, 'H0')
    b, t, three_h = x.shape
    h = three_h // 3
    if x.device.type == 'meta':   # build-time shape inference
        return {'Hidden': [torch.empty((b, t, h), dtype=x.dtype,
                                       device=x.device)]}
    xf = x.float()
    if bias is not None:
        xf = xf + bias.float().reshape(1, 1, -1)
    h0f = None if h0 is None else h0.float()
    is_reverse = attrs.get('is_reverse', False)

    if _gru_kernel_path(attrs, h):
        xin, rev_idx = _maybe_reverse(xf, lengths, is_reverse)
        hs = gru_kernels.gru_scan(xin.transpose(0, 1).contiguous(), w, h0f)
        hs, = _unreverse_and_mask([hs.transpose(0, 1)], rev_idx, lengths, t)
        return {'Hidden': [hs.to(x.dtype)]}

    ln = (torch.full((b,), t, dtype=torch.long, device=x.device)
          if lengths is None else lengths.reshape(-1).long())
    gate_act = _ACTS[attrs.get('gate_activation', 'sigmoid')]
    cand_act = _ACTS[attrs.get('activation', 'tanh')]
    w_rz, w_c = w[:, :2 * h], w[:, 2 * h:]
    rev_idx = None
    if is_reverse:
        xf, rev_idx = _maybe_reverse(xf, ln, True)
    h_p = (h0f if h0f is not None
           else torch.zeros((b, h), dtype=torch.float32, device=x.device))
    hs = []
    for s in range(t):
        rz = xf[:, s, :2 * h] + torch.matmul(h_p, w_rz)
        u = gate_act(rz[:, :h])
        r = gate_act(rz[:, h:])
        c = cand_act(xf[:, s, 2 * h:] + torch.matmul(r * h_p, w_c))
        h_t = u * h_p + (1.0 - u) * c
        h_p = torch.where((s < ln)[:, None], h_t, h_p)
        hs.append(h_p)
    hs, = _unreverse_and_mask([torch.stack(hs, dim=1)], rev_idx, lengths, t)
    return {'Hidden': [hs.to(x.dtype)]}


# gru_unit's integer activation codes (rnn.py :300-309)
_GATE_CODES = {0: 'sigmoid', 1: 'sigmoid', 2: 'tanh', 3: 'relu'}
_CAND_CODES = {0: 'identity', 1: 'sigmoid', 2: 'tanh', 3: 'relu'}


def _unit_act(value, codes, default):
    if isinstance(value, int):
        return _ACTS[codes.get(value, default)]
    return _ACTS[value]


@register_op('gru_unit')
def _gru_unit(ctx, ins, attrs):
    """One GRU step (operators/gru_unit_op): Input [B, 3H] pre-projected
    gates, HiddenPrev [B, H], Weight [H, 3H], optional Bias [1, 3H] ->
    Hidden, ResetHiddenPrev (r * h_prev) and Gate (u, r, c)."""
    dt = first(ins, 'Input').dtype
    x = first(ins, 'Input').float()
    h_p = first(ins, 'HiddenPrev').float()
    w = first(ins, 'Weight').float()
    bias = first(ins, 'Bias')
    h = h_p.shape[1]
    if bias is not None:
        x = x + bias.float().reshape(1, -1)
    gate_act = _unit_act(attrs.get('gate_activation', 0), _GATE_CODES,
                         'sigmoid')
    cand_act = _unit_act(attrs.get('activation', 2), _CAND_CODES, 'tanh')
    rz = x[:, :2 * h] + torch.matmul(h_p, w[:, :2 * h])
    u = gate_act(rz[:, :h])
    r = gate_act(rz[:, h:])
    c = cand_act(x[:, 2 * h:] + torch.matmul(r * h_p, w[:, 2 * h:]))
    h_t = u * h_p + (1.0 - u) * c
    return {'Hidden': [h_t.to(dt)], 'ResetHiddenPrev': [(r * h_p).to(dt)],
            'Gate': [torch.cat([u, r, c], dim=1).to(dt)]}

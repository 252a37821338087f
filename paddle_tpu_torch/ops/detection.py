"""Detection ops (paddle_tpu/ops/detection.py): ``roi_pool`` and
``detection_output``, with the box helpers ``decode_box``, ``iou_matrix``
and ``nms_mask``.

The reference computes both in XLA, outside any Pallas kernel, so here
they are torch ops on the tensors' device, with no value read back to the
host on the way (the card never waits for the host inside either op):

- ``roi_pool`` (roi_pool_op) rounds each roi's corners as floor(v * scale
  + 0.5), makes a malformed roi one cell, and max-pools each bin with two
  separable masked maxima (over H, then W), as the reference does; an
  empty bin reads 0 with Argmax -1.  The reference maps its rois one at a
  time (``lax.map``); here they go in batches of at most ``_ROI_BATCH``
  elements of the [rois, C, bins, H, W] working set, so the peak stays
  bounded whatever the number of rois.
- ``detection_output`` (detection_output_op) decodes the priors, takes the
  softmax of the class scores and runs greedy NMS as min(nms_top_k, P)
  rounds of pick-the-best-then-suppress, for every image and class at
  once: the state of each round (which boxes are alive) stays on the
  device, and each round's IoU row is computed from the picked box, never
  a P x P matrix.  The survivors' top ``keep_top_k`` scores (a stable
  sort: ties go to the lower index, as ``lax.top_k`` breaks them) make a
  fixed [N, keep_top_k, 6] output of (label, score, xmin, ymin, xmax,
  ymax), label -1 past the detections.
"""
import torch

from ..core.registry import register_op
from .common import first

# elements of roi_pool's working set a batch of rois may take (float32:
# 256 MiB)
_ROI_BATCH = 1 << 26


def decode_box(prior, loc):
    """Centre-form decode with variances: prior [P, 8] = (xmin, ymin,
    xmax, ymax, v0, v1, v2, v3), loc [..., P, 4] -> boxes [..., P, 4]."""
    p = prior.float()
    pw = p[:, 2] - p[:, 0]
    ph = p[:, 3] - p[:, 1]
    pcx = (p[:, 0] + p[:, 2]) * 0.5
    pcy = (p[:, 1] + p[:, 3]) * 0.5
    v = p[:, 4:8]
    l = loc.float()
    cx = v[:, 0] * l[..., 0] * pw + pcx
    cy = v[:, 1] * l[..., 1] * ph + pcy
    w = torch.exp(v[:, 2] * l[..., 2]) * pw
    h = torch.exp(v[:, 3] * l[..., 3]) * ph
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5, cy + h * 0.5], dim=-1)


def _iou(a, b):
    """IoU of boxes ``a`` and ``b`` [..., 4] (broadcast), in the
    reference's arithmetic, so a row of it equals a row of
    ``iou_matrix``."""
    a, b = a.float(), b.float()
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) -
                     torch.maximum(a[..., 0], b[..., 0]), min=0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) -
                     torch.maximum(a[..., 1], b[..., 1]), min=0)
    inter = iw * ih
    return inter / torch.clamp(area_a + area_b - inter, min=1e-10)


def iou_matrix(boxes):
    """Pairwise IoU [..., P, P] of boxes [..., P, 4]."""
    return _iou(boxes[..., :, None, :], boxes[..., None, :, :])


def nms_keep(boxes, scores, iou_threshold, score_threshold, max_keep):
    """Greedy NMS keep masks [N, K, P] of boxes [N, P, 4] under K score
    rows [N, K, P] each: min(max_keep, P) rounds, each picking the best
    live box of every row (the first of tied ones), keeping it and
    suppressing it and every box whose IoU with it reaches the
    threshold.  No round reads anything back to the host."""
    n, k, p = scores.shape
    alive = scores > score_threshold
    keep = torch.zeros_like(alive)
    pos = torch.arange(p, device=scores.device)
    neg_inf = scores.new_full((), float('-inf'))
    for _ in range(min(max_keep, p)):
        best = torch.where(alive, scores, neg_inf).argmax(dim=-1,
                                                          keepdim=True)
        any_alive = alive.any(dim=-1, keepdim=True)
        picked = (pos == best) & any_alive
        keep = keep | picked
        best_box = torch.gather(boxes, 1, best.expand(n, k, 4))
        row = _iou(best_box[:, :, None, :], boxes[:, None, :, :])
        alive = alive & ~((row >= iou_threshold) | (pos == best)) & \
            any_alive
    return keep


def nms_mask(boxes, scores, iou_threshold, score_threshold, max_keep):
    """The reference's single-image form: boxes [P, 4], scores [P] ->
    keep [P]."""
    return nms_keep(boxes[None], scores[None, None], iou_threshold,
                    score_threshold, max_keep)[0, 0]


def _roi_pool_batch(x, rois, ph_n, pw_n, scale):
    """(Out [R, C, ph, pw], Argmax [R, C, ph, pw]) of a batch of rois."""
    n, c, h, w = x.shape
    dev = x.device
    b = rois[:, 0].to(torch.int32).long()
    sw, sh, ew, eh = (torch.floor(rois[:, i] * scale + 0.5).to(torch.int32)
                      for i in (1, 2, 3, 4))
    bin_h = torch.clamp(eh - sh + 1, min=1).float() / ph_n
    bin_w = torch.clamp(ew - sw + 1, min=1).float() / pw_n
    ph_i = torch.arange(ph_n, dtype=torch.float32, device=dev)
    pw_i = torch.arange(pw_n, dtype=torch.float32, device=dev)

    def edges(i, size, start, extent):
        lo = torch.floor(i[None] * size[:, None]).to(torch.int32)
        hi = torch.ceil((i[None] + 1) * size[:, None]).to(torch.int32)
        return (torch.clamp(lo + start[:, None], 0, extent),
                torch.clamp(hi + start[:, None], 0, extent))

    hstart, hend = edges(ph_i, bin_h, sh, h)   # [R, ph]
    wstart, wend = edges(pw_i, bin_w, sw, w)   # [R, pw]
    hh = torch.arange(h, device=dev)
    ww = torch.arange(w, device=dev)
    hmask = (hh >= hstart[..., None]) & (hh < hend[..., None])   # [R, ph, H]
    wmask = (ww >= wstart[..., None]) & (ww < wend[..., None])   # [R, pw, W]
    feat = torch.index_select(x, 0, b)   # [R, C, H, W]
    neg_inf = feat.new_full((), float('-inf'))
    mh = torch.where(hmask[:, None, :, :, None], feat[:, :, None], neg_inf)
    col_max = torch.amax(mh, dim=3)   # [R, C, ph, W]
    col_argh = torch.argmax(mh, dim=3)
    mw = torch.where(wmask[:, None, None], col_max[:, :, :, None], neg_inf)
    out = torch.amax(mw, dim=-1)   # [R, C, ph, pw]
    argw = torch.argmax(mw, dim=-1)
    argh = torch.gather(col_argh, 3, argw)
    arg = (argh * w + argw).to(torch.int32)
    empty = ((hend <= hstart)[:, :, None] | (wend <= wstart)[:, None, :])
    empty = empty[:, None]
    return (torch.where(empty, out.new_zeros(()), out),
            torch.where(empty, arg.new_full((), -1), arg))


@register_op('roi_pool')
def _roi_pool(ctx, ins, attrs):
    """X [N, C, H, W] and ROIs [R, 5] rows (batch index, x1, y1, x2, y2)
    in image coordinates -> Out [R, C, ph, pw] (float32) and Argmax (flat
    h * W + w, int32, -1 for an empty bin)."""
    x = first(ins, 'X').float()
    rois = first(ins, 'ROIs').float()
    ph_n = int(attrs['pooled_height'])
    pw_n = int(attrs['pooled_width'])
    scale = float(attrs.get('spatial_scale', 1.0))
    c, h, w = x.shape[1:]
    per_roi = c * ph_n * w * (h + pw_n)
    step = max(1, _ROI_BATCH // max(per_roi, 1))
    outs, args = [], []
    for i in range(0, rois.shape[0], step):
        o, a = _roi_pool_batch(x, rois[i:i + step], ph_n, pw_n, scale)
        outs.append(o)
        args.append(a)
    if not outs:
        return {'Out': [x.new_zeros((0, c, ph_n, pw_n))],
                'Argmax': [torch.zeros((0, c, ph_n, pw_n), dtype=torch.int32,
                                       device=x.device)]}
    return {'Out': [torch.cat(outs)], 'Argmax': [torch.cat(args)]}


@register_op('detection_output')
def _detection_output(ctx, ins, attrs):
    """Loc [N, P, 4] offsets, Conf [N, P, C] logits and PriorBox [P, 8]
    -> Out [N, keep_top_k, 6] float32."""
    loc = first(ins, 'Loc')
    conf = first(ins, 'Conf')
    prior = first(ins, 'PriorBox')
    background = int(attrs.get('background_label_id', 0))
    nms_threshold = float(attrs.get('nms_threshold', 0.45))
    conf_threshold = float(attrs.get('confidence_threshold', 0.01))
    nms_top_k = int(attrs.get('nms_top_k', 400))
    keep_top_k = int(attrs.get('top_k', attrs.get('keep_top_k', 200)))
    attrs['num_classes']   # required, and unused, as in the reference
    n, p = loc.shape[:2]
    boxes = decode_box(prior, loc)   # [N, P, 4]
    cls_probs = torch.softmax(conf.float(), dim=-1).transpose(1, 2)
    keep = nms_keep(boxes, cls_probs, nms_threshold, conf_threshold,
                    nms_top_k)   # [N, C, P]
    keep[:, background] = False
    scores = torch.where(keep, cls_probs, cls_probs.new_zeros(()))
    scores = scores.reshape(n, -1)
    k = min(keep_top_k, scores.shape[1])
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_box = torch.gather(boxes, 1, (top_idx % p)[..., None].expand(
        n, k, 4))
    valid = top_scores > 0
    label = torch.where(valid, (top_idx // p).float(),
                        top_scores.new_full((), -1.0))
    rows = torch.cat([label[..., None], top_scores[..., None], top_box],
                     dim=-1)
    pad_row = torch.cat([rows.new_full((1,), -1.0), rows.new_zeros((5,))])
    rows = torch.where(valid[..., None], rows, pad_row)
    if k < keep_top_k:
        rows = torch.cat([rows, pad_row.expand(n, keep_top_k - k, 6)], dim=1)
    return {'Out': [rows]}

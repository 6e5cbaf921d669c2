"""The detection op family (``paddle_tpu/ops/detection.py``).

Boxes are ``[x1, y1, x2, y2]``. Everything but the greedy NMS family is
dense elementwise and gather math in plain torch over the JAX kernels'
attribute names and expressions. Numbers an attribute lists (anchors,
prior sizes, masks) are filled into tensors on the input's device, never
copied from the host, so an op over them can be captured into a CUDA
graph.

Greedy NMS. The JAX kernels take one ``fori_loop`` step a box, which on
the card would be a few launches a box a class. Here the boxes of each
class are sorted by score (stable, so ties keep their index order), and
the suppression relation ``S[i, j] = j < i and IoU(i, j) > threshold`` is
then strictly lower-triangular, so ``keep[i] = not any_j (S[i, j] and
keep[j])`` has exactly one solution, and it is greedy's answer. It is
reached by iterating that equation from all-kept, every class at once
(:func:`_greedy_keep`): after ``t`` sweeps the first ``t`` boxes are final,
and the sweeps stop at the first one that changes nothing, which the host
reads (``runtime.compiled.host_read``); ``multiclass_nms`` also reads how
many boxes of the busiest class pass ``score_threshold`` (a box below it
sorts last and can suppress no box that passes). So the NMS ops run
uncaptured: a static program that holds one is interpreted at every run.
Their outputs keep the JAX contract bit for bit: a fixed size, ``-1``
padding, the same order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import _draw
from .registry import host_read, register_op, register_shape

__all__ = []


def _const(values, dtype, device):
    """A tensor of host numbers filled on ``device`` element by element (a
    fill launches no copy from the host, so a graph can capture it)."""
    flat = np.asarray(values, dtype=np.float64)
    out = torch.empty(flat.shape, dtype=dtype, device=device)
    view = out.view(-1)
    for i, v in enumerate(flat.reshape(-1).tolist()):
        view[i] = v
    return out


def _area(boxes):
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))


def _pairwise_iou(a, b):
    """``a [..., N, 4]``, ``b [..., M, 4]`` -> ``[..., N, M]``."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(a)[..., :, None] + _area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10), 0.0)


_NMS_ENTRIES = 1 << 22  # IoU entries (classes x M x M) one greedy fixed point holds


def _greedy_keep(iou, threshold, what):
    """Greedy NMS's kept set of score-sorted boxes from their IoU ``[...,
    M, M]``: the fixed point of ``keep = not any(S @ keep)`` (the module's
    docstring); one host read a sweep."""
    m = iou.shape[-1]
    below = torch.ones((m, m), dtype=torch.bool, device=iou.device).tril(-1)
    sup = ((iou > threshold) & below).to(torch.float32)
    keep = torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)
    if m == 0:
        return keep
    host_read(what)
    while True:
        new = (sup @ keep.to(torch.float32)[..., None])[..., 0] == 0
        if torch.equal(new, keep):
            return new
        keep = new


def _argsort_desc(v, dim=-1):
    """``jnp.argsort(-v)``: descending and stable."""
    return torch.argsort(-v, dim=dim, stable=True)


@register_op("iou_similarity")
def iou_similarity(x, y, *, box_normalized=True):
    """``iou_similarity_op.cc``: pairwise IoU ``[N, M]``."""
    return _pairwise_iou(x, y)


@register_op("bbox_overlaps")
def bbox_overlaps(x, y):
    return _pairwise_iou(x, y)


@register_op("box_clip")
def box_clip(boxes, im_info):
    """``box_clip_op.cc``: clipped to the image (``im_info [..., (h, w,
    ...)]``)."""
    h = im_info[..., 0:1] - 1
    w = im_info[..., 1:2] - 1
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    return torch.stack([clip(boxes[..., 0], w[..., 0]), clip(boxes[..., 1], h[..., 0]),
                        clip(boxes[..., 2], w[..., 0]), clip(boxes[..., 3], h[..., 0])], dim=-1)


@register_op("box_coder")
def box_coder(prior_box, prior_box_var, target_box, *, code_type="encode_center_size",
              box_normalized=True):
    """``box_coder_op.cc``: encode ``[N, 4]`` targets against ``[M, 4]``
    priors -> ``[N, M, 4]``, or decode ``[N, M, 4]`` (or ``[N, 4]``)."""
    one = 0 if box_normalized else 1
    pw = prior_box[:, 2] - prior_box[:, 0] + one
    ph = prior_box[:, 3] - prior_box[:, 1] + one
    pcx = prior_box[:, 0] + pw * 0.5
    pcy = prior_box[:, 1] + ph * 0.5
    var = prior_box_var if prior_box_var is not None else torch.ones_like(prior_box)
    if code_type.lower().startswith("encode"):
        tw = target_box[:, 2] - target_box[:, 0] + one
        th = target_box[:, 3] - target_box[:, 1] + one
        tcx = target_box[:, 0] + tw * 0.5
        tcy = target_box[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.clamp(tw[:, None] / pw[None, :], min=1e-10))
        dh = torch.log(torch.clamp(th[:, None] / ph[None, :], min=1e-10))
        return torch.stack([dx, dy, dw, dh], dim=-1) / var[None, :, :]
    d = target_box * (var[None, :, :] if target_box.dim() == 3 else var)
    squeeze = d.dim() == 2
    if squeeze:
        d = d[:, None, :]
    cx = d[..., 0] * pw[None, :] + pcx[None, :]
    cy = d[..., 1] * ph[None, :] + pcy[None, :]
    w = torch.exp(d[..., 2]) * pw[None, :]
    h = torch.exp(d[..., 3]) * ph[None, :]
    out = torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5 - one, cy + h * 0.5 - one],
                      dim=-1)
    return out[:, 0, :] if squeeze else out


@register_op("prior_box", num_outputs=2)
def prior_box(input, image, *, min_sizes, max_sizes=(), aspect_ratios=(1.0,),
              variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False, step_w=0.0, step_h=0.0,
              offset=0.5, min_max_aspect_ratios_order=False):
    """``prior_box_op.cc``: SSD anchors of one feature map -> ``(boxes [H,
    W, A, 4], variances [H, W, A, 4])``."""
    h, w = input.shape[2], input.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    sw = float(step_w) or img_w / w
    sh = float(step_h) or img_h / h
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    whs = []
    for ms in min_sizes:
        ms = float(ms)
        for ar in ars:
            whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes:
            mx = float(max_sizes[list(min_sizes).index(ms)])
            whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    dev = input.device
    whs = _const(np.asarray(whs, np.float32), torch.float32, dev)
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + float(offset)) * sw
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + float(offset)) * sh
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    bw = whs[None, None, :, 0] / 2.0
    bh = whs[None, None, :, 1] / 2.0
    boxes = torch.stack([(cxg - bw) / img_w, (cyg - bh) / img_h,
                         (cxg + bw) / img_w, (cyg + bh) / img_h], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes, _const(variances, torch.float32, dev).expand(boxes.shape)


@register_op("yolo_box", num_outputs=2)
def yolo_box(x, img_size, *, anchors, class_num, conf_thresh=0.01, downsample_ratio=32,
             clip_bbox=True, scale_x_y=1.0):
    """``yolo_box_op.cc``: a YOLOv3 head decoded. ``x [N, A*(5+C), H, W]``,
    ``img_size [N, 2]`` (h, w) -> ``(boxes [N, H*W*A, 4], scores [N,
    H*W*A, C])``, in the JAX kernel's layouts."""
    n, _, h, w = x.shape
    a, c = len(anchors) // 2, int(class_num)
    x = x.reshape(n, a, 5 + c, h, w)
    grid_x = torch.arange(w, device=x.device).reshape(1, 1, 1, w)
    grid_y = torch.arange(h, device=x.device).reshape(1, 1, h, 1)
    sxy = float(scale_x_y)
    bias = -0.5 * (sxy - 1.0)
    cx = (torch.sigmoid(x[:, :, 0]) * sxy + bias + grid_x) / w
    cy = (torch.sigmoid(x[:, :, 1]) * sxy + bias + grid_y) / h
    anc = _const(np.reshape(anchors, (a, 2)), x.dtype, x.device)
    input_h, input_w = float(downsample_ratio) * h, float(downsample_ratio) * w
    bw = torch.exp(x[:, :, 2]) * anc[None, :, 0, None, None] / input_w
    bh = torch.exp(x[:, :, 3]) * anc[None, :, 1, None, None] / input_h
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    img_h = img_size[:, 0].reshape(n, 1, 1, 1).to(x.dtype)
    img_w = img_size[:, 1].reshape(n, 1, 1, 1).to(x.dtype)
    x1, y1 = (cx - bw / 2) * img_w, (cy - bh / 2) * img_h
    x2, y2 = (cx + bw / 2) * img_w, (cy + bh / 2) * img_h
    if clip_bbox:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    keep = conf > conf_thresh
    boxes = boxes * keep[..., None].to(x.dtype)
    probs = probs * keep[:, :, None].to(x.dtype)
    return (boxes.permute(0, 2, 3, 1, 4).reshape(n, h * w * a, 4),
            probs.permute(0, 3, 4, 2, 1).reshape(n, h * w * a, c))


@register_op("roi_align")
def roi_align(x, rois, rois_num, *, pooled_height, pooled_width, spatial_scale=1.0,
              sampling_ratio=-1, aligned=False):
    """``roi_align_op.cc``: bilinear RoI pooling; ``rois [R, 4]``,
    ``rois_num [N]`` RoIs an image (in order) -> ``[R, C, ph, pw]``."""
    _, c, h, w = x.shape
    r = rois.shape[0]
    ph, pw = int(pooled_height), int(pooled_width)
    scale, off = float(spatial_scale), (0.5 if aligned else 0.0)
    ends = torch.cumsum(rois_num.to(torch.int64), 0)
    bidx = torch.clamp(torch.searchsorted(ends, torch.arange(r, device=x.device), right=True),
                       max=rois_num.shape[0] - 1)
    x1, y1 = rois[:, 0] * scale - off, rois[:, 1] * scale - off
    x2, y2 = rois[:, 2] * scale - off, rois[:, 3] * scale - off
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = torch.clamp(rw, min=1.0), torch.clamp(rh, min=1.0)
    bin_w, bin_h = rw / pw, rh / ph
    ns = int(sampling_ratio) if int(sampling_ratio) > 0 else 2
    sub = (torch.arange(ns, device=x.device)[None, None, :] + 0.5) / ns
    iy = torch.arange(ph, device=x.device)[None, :, None] + sub
    ix = torch.arange(pw, device=x.device)[None, :, None] + sub
    yy = (y1[:, None, None] + iy * bin_h[:, None, None]).reshape(r, -1)
    xx = (x1[:, None, None] + ix * bin_w[:, None, None]).reshape(r, -1)
    y0 = torch.clamp(torch.floor(yy), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1).to(torch.int64)
    x1i = torch.clamp(x0 + 1, 0, w - 1).to(torch.int64)
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    wy1, wx1 = torch.clamp(yy - y0, 0, 1), torch.clamp(xx - x0, 0, 1)
    wy0, wx0 = 1 - wy1, 1 - wx1
    b = bidx[:, None, None]

    def at(yi, xi):
        return x[b, :, yi[:, :, None], xi[:, None, :]]  # [R, P, Q, C]

    def wt(a_, b_):
        return (a_[:, :, None] * b_[:, None, :])[..., None]

    vals = (at(y0i, x0i) * wt(wy0, wx0) + at(y0i, x1i) * wt(wy0, wx1)
            + at(y1i, x0i) * wt(wy1, wx0) + at(y1i, x1i) * wt(wy1, wx1))
    return vals.permute(0, 3, 1, 2).reshape(r, c, ph, ns, pw, ns).mean(dim=(3, 5))


def _nms_shape(boxes, scores, *, iou_threshold=0.5, top_k=-1):
    n = boxes.shape[0]
    k = n if top_k in (-1, None) else min(int(top_k), n)
    return (torch.empty(k, dtype=torch.int32, device="meta"),
            torch.empty((), dtype=torch.int32, device="meta"))


register_shape("nms")(_nms_shape)


@register_op("nms", num_outputs=2)
def nms(boxes, scores, *, iou_threshold=0.5, top_k=-1):
    """Greedy NMS with a fixed output size: ``(keep_idx [K] int32, -1 past
    the kept, num_kept)``, ``K`` = ``top_k`` (or N), in score order."""
    n = boxes.shape[0]
    k = n if top_k in (-1, None) else min(int(top_k), n)
    order = _argsort_desc(scores)
    bs = boxes[order]
    keep = _greedy_keep(_pairwise_iou(bs, bs), iou_threshold, "nms")
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    valid = keep & (rank < k)
    out = torch.full((k + 1,), -1, dtype=torch.int32, device=boxes.device)
    out = out.scatter(0, torch.where(valid, rank, k), torch.where(valid, order, -1).to(
        torch.int32))  # slot k takes the rest and is cut off
    return out[:k], torch.clamp(keep.sum(), max=k).to(torch.int32)


def _rows_shape(bboxes, *args, keep_top_k=100, **_):
    return (torch.empty((int(keep_top_k), 6), dtype=bboxes.dtype, device="meta"),
            torch.empty((), dtype=torch.int32, device="meta"))


for _name in ("multiclass_nms", "locality_aware_nms", "retinanet_detection_output"):
    register_shape(_name)(_rows_shape)


def _top_rows(rows, valid, k):
    """The ``k`` rows of the highest valid scores (column 1; stable, so
    ties keep their order), invalid rows ``-1``, padded to ``k``, and the
    valid count among them."""
    key = torch.where(valid, rows[:, 1], -torch.inf)
    order = _argsort_desc(key)[:k]
    out, v = rows[order], valid[order]
    out = torch.where(v[:, None], out, -1.0)
    if out.shape[0] < k:
        out = torch.cat([out, torch.full((k - out.shape[0], 6), -1.0, dtype=out.dtype,
                                         device=out.device)])
    return out, v.sum().to(torch.int32)


def _without(t, label):
    """``t``'s rows but row ``label`` (the background class)."""
    if 0 <= label < t.shape[0]:
        return torch.cat([t[:label], t[label + 1:]])
    return t


@register_op("multiclass_nms", num_outputs=2)
def multiclass_nms(bboxes, scores, *, score_threshold=0.05, nms_threshold=0.3, keep_top_k=100,
                   background_label=-1):
    """``multiclass_nms_op.cc`` with the fixed-size contract: ``bboxes [N,
    4]``, ``scores [C, N]`` -> ``(out [keep_top_k, 6], num_kept)``, rows
    ``(class, score, x1, y1, x2, y2)`` by score, padded with ``-1``. Every
    class at once: the passing boxes of each class sorted by score (the
    busiest class's count is read on the host), greedy fixed points over
    ``[classes, M, M]``, as many classes at once as ``_NMS_ENTRIES``
    allows."""
    c, _ = scores.shape
    k = int(keep_top_k)
    s = _without(scores, background_label)
    cls = _without(torch.arange(c, device=scores.device), background_label)
    passes = s >= score_threshold
    n_pass = passes.sum(1)
    host_read("multiclass_nms")
    m = int(n_pass.max()) if s.shape[0] else 0
    if m == 0:
        return (torch.full((k, 6), -1.0, dtype=bboxes.dtype, device=bboxes.device),
                torch.zeros((), dtype=torch.int32, device=bboxes.device))
    idx = _argsort_desc(torch.where(passes, s, -torch.inf), dim=1)[:, :m]
    b = bboxes[idx]
    per = max(1, _NMS_ENTRIES // (m * m))  # classes a fixed point takes at once
    keep = torch.cat([_greedy_keep(_pairwise_iou(b[i:i + per], b[i:i + per]), nms_threshold,
                                   "multiclass_nms") for i in range(0, b.shape[0], per)])
    valid = keep & (torch.arange(m, device=s.device)[None, :] < n_pass[:, None])
    rows = torch.cat([cls[:, None, None].expand(-1, m, 1).to(bboxes.dtype),
                      torch.gather(s, 1, idx)[:, :, None], b], dim=2)
    return _top_rows(rows.reshape(-1, 6), valid.reshape(-1), k)


@register_op("sigmoid_focal_loss")
def sigmoid_focal_loss(x, label, fg_num, *, gamma=2.0, alpha=0.25):
    """``sigmoid_focal_loss_op.cc``: focal loss over ``[N, C]`` logits,
    ``label [N]`` in ``{0..C}`` (0 background), divided by ``fg_num``."""
    _, c = x.shape
    fg = torch.clamp(fg_num.to(x.dtype).reshape(()), min=1.0)
    cls = torch.arange(1, c + 1, device=x.device)[None, :]
    t = (label.reshape(-1, 1) == cls).to(x.dtype)
    p = torch.sigmoid(x)
    ce = -(t * F.logsigmoid(x) + (1 - t) * F.logsigmoid(-x))
    p_t = t * p + (1 - t) * (1 - p)
    a_t = t * alpha + (1 - t) * (1 - alpha)
    return a_t * ((1 - p_t) ** gamma) * ce / fg


@register_op("anchor_generator", num_outputs=2)
def anchor_generator(x, *, anchor_sizes, aspect_ratios, stride, variances=(0.1, 0.1, 0.2, 0.2),
                     offset=0.5):
    """``anchor_generator_op.cc``: ``(anchors [H, W, A, 4], variances [H, W,
    A, 4])`` of an ``[N, C, H, W]`` map."""
    h, w = x.shape[2], x.shape[3]
    sx, sy = float(stride[0]), float(stride[1])
    cx = (torch.arange(w, device=x.device) + offset) * sx
    cy = (torch.arange(h, device=x.device) + offset) * sy
    ws, hs = [], []
    for r in aspect_ratios:
        for s in anchor_sizes:
            ws.append(s * float(np.sqrt(1.0 / r)))
            hs.append(s * float(np.sqrt(r)))
    ws, hs = _const(ws, x.dtype, x.device), _const(hs, x.dtype, x.device)
    gx, gy = cx[None, :, None], cy[:, None, None]
    shape = (h, w, ws.shape[0])
    anchors = torch.stack([(gx - 0.5 * ws[None, None, :]).expand(shape),
                           (gy - 0.5 * hs[None, None, :]).expand(shape),
                           (gx + 0.5 * ws[None, None, :]).expand(shape),
                           (gy + 0.5 * hs[None, None, :]).expand(shape)], dim=-1)
    return anchors, _const(variances, x.dtype, x.device).expand(anchors.shape)


@register_op("density_prior_box", num_outputs=2)
def density_prior_box(x, image, *, densities, fixed_sizes, fixed_ratios,
                      variances=(0.1, 0.1, 0.2, 0.2), step=(0.0, 0.0), offset=0.5, clip=False):
    """``density_prior_box_op.cc``: each (density d, size s) gives d*d
    shifted boxes a ratio -> ``(boxes [H, W, P, 4], variances)`` in [0, 1]
    image coordinates."""
    fh, fw = x.shape[2], x.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    sw = float(step[0]) or iw / fw
    sh = float(step[1]) or ih / fh
    per_loc = []
    for d, s in zip(densities, fixed_sizes):
        for r in fixed_ratios:
            bw, bh, shift = s * float(np.sqrt(r)), s / float(np.sqrt(r)), s / d
            for di in range(d):
                for dj in range(d):
                    per_loc.append((-s / 2.0 + shift / 2.0 + dj * shift,
                                    -s / 2.0 + shift / 2.0 + di * shift, bw, bh))
    p = len(per_loc)
    off = _const(per_loc, x.dtype, x.device)
    cx = (torch.arange(fw, dtype=x.dtype, device=x.device) + offset) * sw
    cy = (torch.arange(fh, dtype=x.dtype, device=x.device) + offset) * sh
    ccx = cx[None, :, None].expand(fh, fw, p) + off[None, None, :, 0]
    ccy = cy[:, None, None].expand(fh, fw, p) + off[None, None, :, 1]
    bw = off[None, None, :, 2].expand(fh, fw, p)
    bh = off[None, None, :, 3].expand(fh, fw, p)
    out = torch.stack([(ccx - bw / 2) / iw, (ccy - bh / 2) / ih,
                       (ccx + bw / 2) / iw, (ccy + bh / 2) / ih], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out, _const(variances, x.dtype, x.device).expand(out.shape)


@register_op("polygon_box_transform")
def polygon_box_transform(x):
    """``polygon_box_transform_op.cc``: EAST's geometry map, offsets to
    absolute quad coordinates (``4 * position - offset``)."""
    _, c, h, w = x.shape
    xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :] * 4.0
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None] * 4.0
    is_x = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return torch.where(is_x, xs, ys) - x


@register_op("bipartite_match", num_outputs=2)
def bipartite_match(dist, *, match_type="bipartite", dist_threshold=0.5):
    """``bipartite_match_op.cc``: greedy bipartite matching of an ``[N, M]``
    similarity (the largest entry whose row and column are free, ``min(N,
    M)`` times) -> ``(match_indices [M] int32, -1 unmatched, match_dist
    [M])``; ``per_prediction`` then matches free columns to their best row
    above ``dist_threshold``."""
    n, m = dist.shape
    col_match = torch.full((m,), -1, dtype=torch.int32, device=dist.device)
    col_dist = torch.zeros(m, dtype=dist.dtype, device=dist.device)
    d = dist
    cols = torch.arange(m, device=dist.device)
    rows = torch.arange(n, device=dist.device)
    for _ in range(min(n, m)):
        flat = torch.argmax(d).reshape(1)
        i, j = torch.div(flat, m, rounding_mode="floor"), flat % m
        ok = torch.gather(d.reshape(-1), 0, flat) > 0
        at_j = (cols == j) & ok
        col_match = torch.where(at_j, i.to(torch.int32), col_match)
        col_dist = torch.where(at_j, torch.gather(dist.reshape(-1), 0, flat), col_dist)
        hit = ((rows == i)[:, None] | (cols == j)[None, :]) & ok
        d = torch.where(hit, -1.0, d)
    if match_type == "per_prediction":
        best_val, best_row = torch.max(dist, dim=0)
        extra = (col_match < 0) & (best_val > dist_threshold)
        col_match = torch.where(extra, best_row.to(torch.int32), col_match)
        col_dist = torch.where(extra, best_val, col_dist)
    return col_match, col_dist


@register_op("target_assign", num_outputs=2)
def target_assign(x, match_indices, *, neg_value=0.0):
    """``target_assign_op.cc``: ``x [N, K]`` rows gathered by ``[M]`` match
    indices -> ``(out [M, K], weights [M])``."""
    mi = match_indices
    out = x[torch.clamp(mi, 0, x.shape[0] - 1).to(torch.int64)]
    out = torch.where((mi >= 0)[:, None], out, torch.full((), neg_value, dtype=x.dtype,
                                                          device=x.device))
    return out, (mi >= 0).to(x.dtype)


@register_op("box_decoder_and_assign", num_outputs=2)
def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score, *,
                           box_clip=4.135166556742356):
    """``box_decoder_and_assign_op.cc``: per-class deltas decoded, and each
    box's decode of its best-scoring class -> ``(decoded [N, C*4],
    assigned [N, 4])``."""
    n, c4 = target_box.shape
    c = c4 // 4
    pw = prior_box[:, 2] - prior_box[:, 0] + 1.0
    ph = prior_box[:, 3] - prior_box[:, 1] + 1.0
    pcx, pcy = prior_box[:, 0] + 0.5 * pw, prior_box[:, 1] + 0.5 * ph
    t = target_box.reshape(n, c, 4)
    var = (prior_box_var if prior_box_var is not None
           else torch.ones((n, 4), dtype=target_box.dtype, device=target_box.device))
    dx = t[..., 0] * var[:, None, 0]
    dy = t[..., 1] * var[:, None, 1]
    dw = torch.clamp(t[..., 2] * var[:, None, 2], -box_clip, box_clip)
    dh = torch.clamp(t[..., 3] * var[:, None, 3], -box_clip, box_clip)
    cx, cy = dx * pw[:, None] + pcx[:, None], dy * ph[:, None] + pcy[:, None]
    w, h = torch.exp(dw) * pw[:, None], torch.exp(dh) * ph[:, None]
    dec = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - 1.0, cy + h / 2 - 1.0], dim=-1)
    best = torch.argmax(box_score, dim=1)
    assigned = torch.gather(dec, 1, best[:, None, None].expand(n, 1, 4))[:, 0]
    return dec.reshape(n, c4), assigned


@register_op("matrix_nms", num_outputs=2)
def matrix_nms(bboxes, scores, *, score_threshold=0.05, post_threshold=0.0, nms_top_k=-1,
               keep_top_k=100, use_gaussian=False, gaussian_sigma=2.0, background_label=0):
    """``matrix_nms_op.cc``: parallel soft-NMS, each score decayed by its
    worst overlap with a higher-scoring box of its class; no sequential
    suppression, so it is captured. ``(out [keep_top_k, 6], num_kept)``."""
    c, n = scores.shape
    rows, valid_all = [], []
    for cls in range(c):
        if cls == background_label:
            continue
        s = scores[cls]
        passes = s >= score_threshold
        order = _argsort_desc(torch.where(passes, s, -torch.inf))
        b_s, s_s, p_s = bboxes[order], s[order], passes[order]
        upper = torch.tril(_pairwise_iou(b_s, b_s), -1).T
        max_overlap = torch.amax(upper, dim=0)
        if use_gaussian:
            decay = torch.exp((torch.square(max_overlap)[:, None] - torch.square(upper))
                              / gaussian_sigma)
        else:
            decay = (1.0 - upper) / torch.clamp(1.0 - max_overlap[:, None], min=1e-10)
        decay = torch.amin(torch.where(upper > 0, decay, 1.0), dim=0)
        new_s = s_s * decay
        ok = p_s & (new_s >= post_threshold)
        row = torch.cat([torch.full((n, 1), cls, dtype=bboxes.dtype, device=bboxes.device),
                         new_s[:, None], b_s], dim=1)
        rows.append(torch.where(ok[:, None], row, -1.0))
        valid_all.append(ok)
    return _top_rows(torch.cat(rows), torch.cat(valid_all), int(keep_top_k))


@register_op("locality_aware_nms", num_outputs=2)
def locality_aware_nms(bboxes, scores, *, score_threshold=0.05, nms_threshold=0.3,
                       keep_top_k=100):
    """``locality_aware_nms_op.cc`` (EAST): overlapping neighbours merged
    by score-weighted average, then greedy NMS. One class."""
    n = bboxes.shape[0]
    s = scores.reshape(-1)
    passes = s >= score_threshold
    near = (_pairwise_iou(bboxes, bboxes) > nms_threshold) & passes[None, :] & passes[:, None]
    wgt = torch.where(near, s[None, :], 0.0)
    merged = (wgt @ bboxes) / torch.clamp(wgt.sum(dim=1), min=1e-10)[:, None]
    merged = torch.where(passes[:, None], merged, bboxes)
    keep_idx, _ = nms(merged, torch.where(passes, s, -torch.inf), iou_threshold=nms_threshold,
                      top_k=n)
    gi = torch.clamp(keep_idx, 0, n - 1).to(torch.int64)
    valid = (keep_idx >= 0) & passes[gi]
    k = int(keep_top_k)
    rows = torch.cat([torch.zeros((n, 1), dtype=bboxes.dtype, device=bboxes.device),
                      s[gi][:, None], merged[gi]], dim=1)
    rows = torch.where(valid[:, None], rows, -1.0)[:k]
    valid = valid[:k]
    if rows.shape[0] < k:
        rows = torch.cat([rows, torch.full((k - rows.shape[0], 6), -1.0, dtype=rows.dtype,
                                           device=rows.device)])
    return rows, valid.sum().to(torch.int32)


@register_op("mine_hard_examples", num_outputs=2)
def mine_hard_examples(cls_loss, match_indices, *, neg_pos_ratio=3.0, mining_type="max_negative",
                       sample_size=None):
    """``mine_hard_examples_op.cc``: the hardest unmatched priors, at most
    ``neg_pos_ratio`` times the positives (or ``sample_size``) ->
    ``(neg_mask [M] int32, num_neg)``."""
    m = match_indices.shape[0]
    is_pos = match_indices >= 0
    cap = (float(int(sample_size)) if sample_size is not None
           else neg_pos_ratio * is_pos.sum().to(torch.float32))
    neg_loss = torch.where(is_pos, -torch.inf, cls_loss.reshape(-1))
    order = _argsort_desc(neg_loss)
    rank = torch.empty(m, dtype=torch.int32, device=order.device).scatter(
        0, order, torch.arange(m, dtype=torch.int32, device=order.device))
    neg_mask = (~is_pos) & (rank.to(torch.float32) < cap) & torch.isfinite(neg_loss)
    return neg_mask.to(torch.int32), neg_mask.sum().to(torch.int32)


def _decode_clip(anc, d, im_info, var=None):
    """``box_coder``'s center-size decode with ``+1`` extents, the log
    sizes capped at 10, clipped to the image ``(h, w, ...)``."""
    aw = anc[:, 2] - anc[:, 0] + 1.0
    ah = anc[:, 3] - anc[:, 1] + 1.0
    acx, acy = anc[:, 0] + 0.5 * aw, anc[:, 1] + 0.5 * ah
    if var is None:
        cx, cy = d[:, 0] * aw + acx, d[:, 1] * ah + acy
        w = torch.exp(torch.clamp(d[:, 2], max=10.0)) * aw
        h = torch.exp(torch.clamp(d[:, 3], max=10.0)) * ah
    else:
        cx, cy = var[:, 0] * d[:, 0] * aw + acx, var[:, 1] * d[:, 1] * ah + acy
        w = torch.exp(torch.clamp(var[:, 2] * d[:, 2], max=10.0)) * aw
        h = torch.exp(torch.clamp(var[:, 3] * d[:, 3], max=10.0)) * ah
    boxes = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0],
                        dim=1)
    ih, iw = im_info[0], im_info[1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1)

    return torch.stack([clip(boxes[:, 0], iw), clip(boxes[:, 1], ih),
                        clip(boxes[:, 2], iw), clip(boxes[:, 3], ih)], dim=1)


@register_shape("generate_proposals")
def _proposals_shape(scores, *args, post_nms_top_n=1000, pre_nms_top_n=6000, **_):
    k = min(int(post_nms_top_n), min(int(pre_nms_top_n), scores.shape[0]))
    return (torch.empty((k, 4), dtype=scores.dtype, device="meta"),
            torch.empty(k, dtype=scores.dtype, device="meta"),
            torch.empty((), dtype=torch.int32, device="meta"))


@register_op("generate_proposals", num_outputs=3)
def generate_proposals(scores, bbox_deltas, im_info, anchors, variances, *, pre_nms_top_n=6000,
                       post_nms_top_n=1000, nms_thresh=0.5, min_size=0.1, eta=1.0):
    """``generate_proposals_op.cc`` for one image: objectness top-k, decode,
    clip, drop small, NMS -> ``(rois [K, 4], roi_scores [K], num_valid)``."""
    pre = min(int(pre_nms_top_n), scores.shape[0])
    top_i = _argsort_desc(scores)[:pre]
    top_s = scores[top_i]
    boxes = _decode_clip(anchors[top_i], bbox_deltas[top_i], im_info, variances[top_i])
    ms = min_size * im_info[2]
    keep_size = (((boxes[:, 2] - boxes[:, 0] + 1.0) >= ms)
                 & ((boxes[:, 3] - boxes[:, 1] + 1.0) >= ms))
    keep_idx, _ = nms(boxes, torch.where(keep_size, top_s, -torch.inf), iou_threshold=nms_thresh,
                      top_k=int(post_nms_top_n))
    gi = torch.clamp(keep_idx, 0, pre - 1).to(torch.int64)
    valid = (keep_idx >= 0) & keep_size[gi]
    rois = torch.where(valid[:, None], boxes[gi], 0.0)
    return rois, torch.where(valid, top_s[gi], 0.0), valid.sum().to(torch.int32)


@register_op("distribute_fpn_proposals", num_outputs=2)
def distribute_fpn_proposals(rois, *, min_level=2, max_level=5, refer_level=4, refer_scale=224):
    """``distribute_fpn_proposals_op.cc``: each RoI's FPN level by its
    scale -> ``(level_idx [R] int32, restore_rank [R] int32)``."""
    scale = torch.sqrt(torch.clamp((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]),
                                   min=1e-10))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-10)).to(torch.int32) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level)
    order = torch.argsort(lvl, stable=True)
    restore = torch.empty_like(order).scatter(0, order, torch.arange(
        rois.shape[0], dtype=order.dtype, device=order.device))
    return lvl, restore.to(torch.int32)


@register_op("collect_fpn_proposals", num_outputs=2)
def collect_fpn_proposals(multi_rois, multi_scores, *, post_nms_top_n=1000):
    """``collect_fpn_proposals_op.cc``: the global top-k by score of the
    stacked levels ``[L, R, 4]``, ``[L, R]``."""
    rois, scores = multi_rois.reshape(-1, 4), multi_scores.reshape(-1)
    top_i = _argsort_desc(scores)[:min(int(post_nms_top_n), scores.shape[0])]
    return rois[top_i], scores[top_i]


@register_op("retinanet_detection_output", num_outputs=2)
def retinanet_detection_output(bboxes, scores, anchors, im_info, *, score_threshold=0.05,
                               nms_top_k=1000, keep_top_k=100, nms_threshold=0.3):
    """``retinanet_detection_output_op.cc`` for one image: deltas decoded,
    then ``multiclass_nms`` over ``scores [A, C]``."""
    return multiclass_nms(_decode_clip(anchors, bboxes, im_info), scores.T,
                          score_threshold=score_threshold, nms_threshold=nms_threshold,
                          keep_top_k=keep_top_k, background_label=-1)


@register_op("yolov3_loss")
def yolov3_loss(x, gt_box, gt_label, *, anchors, anchor_mask, class_num, ignore_thresh=0.7,
                downsample_ratio=32, use_label_smooth=False):
    """``yolov3_loss_op.cc``: one scale's YOLOv3 loss an image ``[N]``. ``x
    [N, A*(5+C), H, W]``; ``gt_box [N, B, 4]`` normalized (cx, cy, w, h);
    ``gt_label [N, B]`` (negative: a padding slot). A ground truth is owned
    by the anchor of the best shape IoU over all anchors, at its centre
    cell, when that anchor is in this scale's mask. The targets are
    written as the JAX kernel's scatter writes them, the last slot of a
    cell winning (padding slots write the default), made deterministic on
    the card by writing each cell's last writer only."""
    n, _, h, w = x.shape
    a, c = len(anchor_mask), int(class_num)
    dev, dt = x.device, x.dtype
    an_np = np.reshape(np.asarray(anchors, np.float64), (-1, 2))
    an_all = _const(an_np, dt, dev)
    an = _const(an_np[list(anchor_mask)], dt, dev)
    stride = float(downsample_ratio)
    in_w, in_h = w * stride, h * stride
    x = x.reshape(n, a, 5 + c, h, w)
    tx, ty, tw, th, tobj, tcls = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3], x[:, :, 4], \
        x[:, :, 5:]
    gx = torch.arange(w, dtype=dt, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=dt, device=dev)[None, None, :, None]
    px = (torch.sigmoid(tx) + gx) / w
    py = (torch.sigmoid(ty) + gy) / h
    pw = torch.exp(torch.clamp(tw, -10, 10)) * an[None, :, 0, None, None] / in_w
    ph = torch.exp(torch.clamp(th, -10, 10)) * an[None, :, 1, None, None] / in_h
    pred = torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2], dim=-1)
    gt_valid = gt_label >= 0
    gxyxy = torch.stack([gt_box[..., 0] - gt_box[..., 2] / 2, gt_box[..., 1] - gt_box[..., 3] / 2,
                         gt_box[..., 0] + gt_box[..., 2] / 2, gt_box[..., 1] + gt_box[..., 3] / 2],
                        dim=-1)
    with torch.no_grad():
        iou = _pairwise_iou(pred.detach().reshape(n, -1, 4), gxyxy)
        best_iou = torch.amax(torch.where(gt_valid[:, None, :], iou, 0.0), dim=2)
        ignore = (best_iou > ignore_thresh).reshape(n, a, h, w)
    gw, gh = gt_box[..., 2] * in_w, gt_box[..., 3] * in_h
    inter = (torch.minimum(gw[..., None], an_all[None, None, :, 0])
             * torch.minimum(gh[..., None], an_all[None, None, :, 1]))
    union = gw[..., None] * gh[..., None] + an_all[None, None, :, 0] * an_all[None, None, :, 1] \
        - inter
    best_an = torch.argmax(inter / torch.clamp(union, min=1e-10), dim=-1)
    in_mask = best_an[..., None] == _const(list(anchor_mask), torch.int64, dev)[None, None, :]
    local_a = torch.argmax(in_mask.to(torch.int32), dim=-1)
    owned = in_mask.any(dim=-1) & gt_valid
    gi = torch.clamp((gt_box[..., 0] * w).to(torch.int32), 0, w - 1).to(torch.int64)
    gj = torch.clamp((gt_box[..., 1] * h).to(torch.int32), 0, h - 1).to(torch.int64)
    b = gt_box.shape[1]
    n_idx = torch.arange(n, device=dev)[:, None].expand(n, b)
    cell = (((n_idx * a + local_a) * h + gj) * w + gi).reshape(-1)
    writer = torch.arange(n * b, device=dev)
    size = n * a * h * w
    last = torch.full((size,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, cell, writer, reduce="amax", include_self=True)
    slot = torch.where(last[cell] == writer, cell, size)  # losers write the cut-off slot

    def scatter(vals, default):
        vals = torch.where(owned, vals, torch.full((), default, dtype=dt, device=dev)).reshape(-1)
        out = torch.full((size + 1,), default, dtype=dt, device=dev).scatter(0, slot, vals)
        return out[:size].reshape(n, a, h, w)

    obj_t = scatter(torch.ones_like(gw), 0.0)
    scale_t = scatter(2.0 - gt_box[..., 2] * gt_box[..., 3], 0.0)
    tx_t = scatter(gt_box[..., 0] * w - gi.to(dt), 0.0)
    ty_t = scatter(gt_box[..., 1] * h - gj.to(dt), 0.0)
    an_loc = an[local_a]
    tw_t = scatter(torch.log(torch.clamp(gw / an_loc[..., 0], min=1e-10)), 0.0)
    th_t = scatter(torch.log(torch.clamp(gh / an_loc[..., 1], min=1e-10)), 0.0)

    def bce(logit, target):
        return -(target * F.logsigmoid(logit) + (1 - target) * F.logsigmoid(-logit))

    pos = obj_t
    loss_xy = pos * scale_t * (bce(tx, tx_t) + bce(ty, ty_t))
    loss_wh = pos * scale_t * 0.5 * (torch.square(tw - tw_t) + torch.square(th - th_t))
    noobj = (1.0 - pos) * (1.0 - ignore.to(dt))
    loss_obj = pos * bce(tobj, torch.ones_like(tobj)) + noobj * bce(tobj, torch.zeros_like(tobj))
    smooth = 1.0 / c if use_label_smooth else 0.0
    cls_t = scatter(gt_label.to(dt), -1.0)
    onehot = (cls_t[:, :, None] == torch.arange(c, device=dev)[None, None, :, None, None]).to(dt)
    onehot = torch.clamp(onehot, smooth, 1.0 - smooth if use_label_smooth else 1.0)
    loss_cls = pos[:, :, None] * bce(tcls, onehot)
    return (loss_xy.sum(dim=(1, 2, 3)) + loss_wh.sum(dim=(1, 2, 3)) + loss_obj.sum(dim=(1, 2, 3))
            + loss_cls.sum(dim=(1, 2, 3, 4)))


@register_op("rpn_target_assign", num_outputs=4)
def rpn_target_assign(anchors, gt_boxes, *, key=None, is_crowd=None, rpn_batch_size_per_im=256,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
                      use_random=True, generator=None):
    """``rpn_target_assign_op.cc`` for one image -> ``(labels [A] int32 in
    {-1, 0, 1}, matched_gt [A] int32, fg_num, bg_num)``: positives are each
    ground truth's best anchors and anchors above ``rpn_positive_overlap``,
    negatives those below ``rpn_negative_overlap``, both subsampled to the
    budget (by a uniform draw with ``use_random``, else by IoU)."""
    a = anchors.shape[0]
    iou = _pairwise_iou(anchors, gt_boxes)
    best_iou, best_gt = torch.max(iou, dim=1)
    best_per_gt = torch.amax(iou, dim=0)
    is_best = torch.any((iou >= best_per_gt[None, :] - 1e-7) & (best_per_gt[None, :] > 0), dim=1)
    pos = is_best | (best_iou >= rpn_positive_overlap)
    neg = (~pos) & (best_iou < rpn_negative_overlap)
    budget = int(rpn_batch_size_per_im)
    fg_cap = int(budget * rpn_fg_fraction)
    rk = (_draw(anchors.device, generator, lambda gen: torch.rand(
        a, generator=gen, device=anchors.device)) if use_random else -best_iou)
    ar = torch.arange(a, dtype=torch.int32, device=anchors.device)

    def subsample(mask, cap):
        order = torch.argsort(torch.where(mask, rk, torch.inf), stable=True)
        rank = torch.empty_like(ar).scatter(0, order, ar)
        return mask & (rank < cap)

    pos_s = subsample(pos, fg_cap)
    n_fg = pos_s.sum().to(torch.int32)
    neg_s = subsample(neg, budget - n_fg)
    labels = torch.where(pos_s, 1, torch.where(neg_s, 0, -1)).to(torch.int32)
    return labels, best_gt.to(torch.int32), n_fg, neg_s.sum().to(torch.int32)

"""Metric op kernels (``paddle_tpu/ops/metrics_kernels.py``): ``auc`` and ``precision_recall``.

Plain torch over the JAX kernels' expressions. The streaming statistics
are inputs and outputs the caller carries, as in the reference's
``auc_op.cc`` and ``precision_recall_op.cc``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = []


@register_op("auc", num_outputs=3)
def auc(predict, label, *, num_thresholds=4095, stat_pos=None, stat_neg=None, curve="ROC"):
    """``auc_op.cc``: the bucketed ROC AUC. ``predict [N, 2]`` (class 1's
    probability in column 1) or ``[N]``; ``label [N]`` in {0, 1}. Returns
    ``(auc, stat_pos, stat_neg)``, the per-bucket positive and negative
    counts (bucket ``floor(p * T)``) with the previous ones added."""
    p = predict[:, 1] if predict.dim() == 2 else predict
    lbl = label.reshape(-1).to(torch.int32)
    t = int(num_thresholds)
    bucket = torch.clamp((p * t).to(torch.int32), 0, t).to(torch.int64)
    dtype = torch.float64 if p.dtype == torch.float64 else torch.float32
    pos = torch.zeros(t + 1, dtype=dtype, device=p.device).index_add_(0, bucket, lbl.to(dtype))
    neg = torch.zeros_like(pos).index_add_(0, bucket, (1 - lbl).to(dtype))
    if stat_pos is not None:
        pos = pos + stat_pos
    if stat_neg is not None:
        neg = neg + stat_neg
    # TPR over FPR by the trapezoid rule, thresholds descending
    tp = torch.cumsum(pos.flip(0), 0)
    fp = torch.cumsum(neg.flip(0), 0)
    tpr = tp / torch.clamp(tp[-1], min=1e-12)
    fpr = fp / torch.clamp(fp[-1], min=1e-12)
    area = ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0).sum() + fpr[0] * tpr[0] / 2.0
    return area, pos, neg


@register_op("precision_recall", num_outputs=2)
def precision_recall(predict, label, *, num_classes):
    """``precision_recall_op.cc``: ``predict [N, C]`` scores (the argmax
    is the class) or ``[N]`` class ids, ``label [N]``. Returns ``(per_class
    [C, 3], macro_micro [6])``: precision, recall and F1 per class, then
    their macro and micro averages."""
    c = int(num_classes)
    pred = torch.argmax(predict, dim=-1) if predict.dim() == 2 else predict
    pred = pred.to(torch.int64).reshape(-1)
    lbl = label.to(torch.int64).reshape(-1)
    onehot_p = F.one_hot(pred, c).to(torch.float32)
    onehot_l = F.one_hot(lbl, c).to(torch.float32)
    tp = (onehot_p * onehot_l).sum(0)
    fp = onehot_p.sum(0) - tp
    fn = onehot_l.sum(0) - tp

    def safe_div(a, b):
        return torch.where(b > 0, a / torch.clamp(b, min=1e-12), 0.0)

    prec = safe_div(tp, tp + fp)
    rec = safe_div(tp, tp + fn)
    f1 = safe_div(2 * prec * rec, prec + rec)
    macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
    micro_p = safe_div(tp.sum(), (tp + fp).sum())
    micro_r = safe_div(tp.sum(), (tp + fn).sum())
    micro_f = safe_div(2 * micro_p * micro_r, micro_p + micro_r)
    return torch.stack([prec, rec, f1], 1), torch.cat([macro, torch.stack([micro_p, micro_r,
                                                                          micro_f])])

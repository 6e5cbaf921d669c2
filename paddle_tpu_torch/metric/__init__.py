"""paddle.metric in the port (``paddle_tpu/metric``).

Reference parity: python/paddle/metric/metrics.py (Metric base, Accuracy,
Precision, Recall, Auc) and fluid/metrics.py streaming metrics. The
metrics accumulate on the host in numpy, as the JAX package's: a tensor on
the card is read back when it is passed in.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, pred, label, *args):
        """Optional pre-processing run inside the (possibly compiled)
        eval step; default passthrough."""
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy (metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name="acc"):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        if label.ndim == pred.ndim:
            label = label.squeeze(-1)
        correct = idx == label[..., None]
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(axis=-1)
            self.total[i] += c.sum()
            self.count[i] += c.size
        c0 = correct[..., : self.topk[0]].any(axis=-1)
        return float(c0.mean())

    def accumulate(self):
        res = [
            float(t / c) if c > 0 else 0.0
            for t, c in zip(self.total, self.count)
        ]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision (metrics.py Precision)."""

    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp / denom) if denom else 0.0


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp / denom) if denom else 0.0


class Auc(Metric):
    """ROC AUC via histogram buckets (metrics.py Auc / auc_op.cc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = _np(labels).reshape(-1)
        buckets = np.minimum(
            (preds * self.num_thresholds).astype(np.int64),
            self.num_thresholds,
        )
        np.add.at(self._pos, buckets[labels == 1], 1)
        np.add.at(self._neg, buckets[labels == 0], 1)

    def accumulate(self):
        tot_pos = self._pos.sum()
        tot_neg = self._neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # sum over buckets: neg_i * (pos_above_i + pos_i/2)
        pos_cum = np.cumsum(self._pos[::-1])[::-1]
        pos_above = pos_cum - self._pos
        auc = (self._neg * (pos_above + self._pos / 2.0)).sum()
        return float(auc / (tot_pos * tot_neg))

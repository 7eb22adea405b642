"""Segmentation losses and metrics, and the host-side meters.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/metrics.py``: the
reference's sklearn metrics (utils.py:388-408) and torch DiceLoss
(utils.py:410-424) as closed-form confusion counts on the tensors' device.
The reference's quirks are kept:

* DiceLoss applies a sigmoid to its inputs even when they are binary masks
  already (eval.py:204-211 feeds it output / 255), smooth = 1;
* the metrics binarize both arguments at > 0.5;
* sklearn's zero division gives 0.
"""

from __future__ import annotations

import torch


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x.float()))


def _dice(x, t, smooth):
    inter = (x * t).sum()
    return 1.0 - (2.0 * inter + smooth) / (x.sum() + t.sum() + smooth)


def dice_loss(inputs, targets, smooth=1.0):
    """1 - (2 sum(sigmoid(x) t) + s) / (sum(sigmoid(x)) + sum(t) + s)."""
    return _dice(_sigmoid(inputs).reshape(-1), targets.reshape(-1).float(), smooth)


def dice_bce_loss(inputs, targets, smooth=1.0):
    """DiceBCELoss (unet.py:95-112): Dice plus the mean BCE of the sigmoid."""
    x = _sigmoid(inputs).reshape(-1)
    t = targets.reshape(-1).float()
    eps = 1e-7
    xc = torch.clamp(x, eps, 1.0 - eps)
    bce = -(t * torch.log(xc) + (1.0 - t) * torch.log(1.0 - xc)).mean()
    return _dice(x, t, smooth) + bce


def confusion_counts(y_true, y_pred):
    """(tp, fp, fn, tn), both arguments binarized at > 0.5 (utils.py:390-400)."""
    t = (y_true.reshape(-1) > 0.5).float()
    p = (y_pred.reshape(-1) > 0.5).float()
    tp = (t * p).sum()
    fp = ((1 - t) * p).sum()
    fn = (t * (1 - p)).sum()
    tn = ((1 - t) * (1 - p)).sum()
    return tp, fp, fn, tn


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.clamp_min(den, 1.0e-38), torch.zeros_like(num))


def calculate_metrics(y_true, y_pred):
    """[jaccard, f1, recall, precision, accuracy], sklearn's binary
    semantics (positive class 1) in utils.py:388-408's order."""
    tp, fp, fn, tn = confusion_counts(y_true, y_pred)
    jaccard = _safe_div(tp, tp + fp + fn)
    f1 = _safe_div(2 * tp, 2 * tp + fp + fn)
    recall = _safe_div(tp, tp + fn)
    precision = _safe_div(tp, tp + fp)
    acc = (tp + tn) / (tp + fp + fn + tn)
    return torch.stack([jaccard, f1, recall, precision, acc])


def roc_auc(y_true, scores, n_thresholds=256):
    """ROC-AUC of scores in [0, 1] by the Mann-Whitney identity on a
    quantized histogram (finetune.py:230-235 calls sklearn's roc_auc_score
    on sigmoid outputs): exact when the scores take at most n_thresholds
    distinct quantized values; ties count half, as sklearn's trapezoids do."""
    t = (y_true.reshape(-1) > 0.5).float()
    s = torch.clamp(scores.reshape(-1).float(), 0.0, 1.0)
    q = torch.round(s * (n_thresholds - 1)).long()
    zeros = torch.zeros(n_thresholds, dtype=torch.float32, device=t.device)
    pos_hist = zeros.index_add(0, q, t)
    neg_hist = zeros.index_add(0, q, 1 - t)
    # P(s_pos > s_neg) + 0.5 P(equal), summed over bins
    neg_below = torch.cat([zeros[:1], torch.cumsum(neg_hist, 0)[:-1]])
    wins = (pos_hist * neg_below).sum() + 0.5 * (pos_hist * neg_hist).sum()
    return _safe_div(wins, t.sum() * (1 - t).sum())


class AverageMeter:
    """Running value, sum, count and average of a host scalar
    (timm.utils.AverageMeter)."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0

"""Feature-map normalizers (the reference's utils.py:426-449).

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/normalize.py``, on tensors,
with the reference's guards: an epsilon on L1, zero-norm and zero-std
inputs passed through, the per-row softmax with an additive epsilon when a
row sums to zero.
"""

from __future__ import annotations

import torch


def l1_normalize(feat_map):
    """x / (sum|x| + 1e-8)."""
    return feat_map / (feat_map.abs().sum() + 1e-8)


def l2_normalize(x):
    """x / ||x||_2; a zero-norm input passes unchanged."""
    norm = torch.sqrt(x.square().sum())
    return torch.where(norm == 0, x, x / torch.clamp(norm, min=1e-38))


def zscore_normalize(x):
    """(x - mean) / std (population std); a zero-std input passes unchanged."""
    mean = x.mean()
    std = x.std(correction=0)
    return torch.where(std == 0, x, (x - mean) / torch.clamp(std, min=1e-38))


def softmax_normalize(feat_map):
    """Row-wise exp(x) / sum(exp(x), axis=1); 1e-8 is added to the
    exponentials when any row sums to zero (utils.py:444-449)."""
    e = torch.exp(feat_map)
    row_sums = e.sum(dim=1, keepdim=True)
    e = torch.where((row_sums == 0).any(), e + 1e-8, e)
    return e / e.sum(dim=1, keepdim=True)

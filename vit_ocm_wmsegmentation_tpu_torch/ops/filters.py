"""scipy-compatible median (rank) filter on tensors.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/filters.py``: the eval
path's ``scipy.ndimage.median_filter`` (eval.py:144; size 1 is the
identity) as a sort over the k x k neighbourhood, with scipy's default
``reflect`` border, numpy's ``symmetric`` pad: the edge sample is repeated.
"""

from __future__ import annotations

import torch


def _symmetric_index(size: int, lo: int, hi: int, device):
    """Indices of a symmetric pad of ``lo`` before and ``hi`` after an axis of
    ``size``: ..., 1, 0 | 0, 1, ..., size-1 | size-1, size-2, ... (torch's
    ``reflect`` pad leaves the edge sample out)."""
    i = torch.arange(-lo, size + hi, device=device)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= size, 2 * size - 1 - i, i)


def median_filter(x, size: int):
    """scipy.ndimage.median_filter(x, size) over the last two axes of
    (..., H, W): the element of rank (size*size)//2 of the sorted window,
    which for an even size spans [-size//2, size//2 - 1] around the pixel,
    as scipy's does. A selection, so bit-equal to scipy for any dtype."""
    if size <= 1:
        return x
    k = size
    lo, hi = k // 2, k - 1 - k // 2
    h, w = x.shape[-2:]
    rows = _symmetric_index(h, lo, hi, x.device)
    cols = _symmetric_index(w, lo, hi, x.device)
    padded = x[..., rows[:, None], cols[None, :]]
    windows = torch.stack([padded[..., dy : dy + h, dx : dx + w]
                           for dy in range(k) for dx in range(k)], dim=-1)
    return windows.sort(dim=-1).values[..., (k * k) // 2]

"""Resizes with the reference stack's coordinate conventions.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/resize.py``. The numpy table
builders are copies of the JAX package's (equal arrays, tested); each resize
is two matmuls with those (out, in) tables.

* torch ``F.interpolate(mode='bicubic', scale_factor=s)``: cubic kernel
  A=-0.75, source coordinate ``(dst+0.5)/s - 0.5`` with the given scale,
  indices clamped at the border (positional-embedding interpolation).
* cv2 ``resize(..., INTER_LINEAR)``: 2-tap bilinear at
  ``(dst+0.5)*in/out - 0.5``, no antialiasing (attention smoothing).
* torch ``F.interpolate(mode='nearest', scale_factor=p)``: exact block
  repetition (attention upsampling, utils.py:234).
"""

from __future__ import annotations

import numpy as np
import torch

_A = -0.75  # torch/cv2 cubic convolution constant


def _cubic_w1(t):
    # |x| <= 1 branch of the cubic convolution kernel
    return ((_A + 2.0) * t - (_A + 3.0)) * t * t + 1.0


def _cubic_w2(t):
    # 1 < |x| < 2 branch
    return ((_A * t - 5.0 * _A) * t + 8.0 * _A) * t - 4.0 * _A


def bicubic_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out_size, in_size) interpolation matrix replicating torch bicubic with
    an explicit scale_factor and align_corners=False."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        w = (_cubic_w2(t + 1.0), _cubic_w1(t), _cubic_w1(1.0 - t), _cubic_w2(2.0 - t))
        for k in range(4):
            idx = min(max(i0 - 1 + k, 0), in_size - 1)
            m[i, idx] += w[k]
    return m.astype(np.float32)


def linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) matrix replicating cv2 INTER_LINEAR (half-pixel
    centers, 2 taps, clamped, no antialias)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        for idx, w in ((i0, 1.0 - t), (i0 + 1, t)):
            m[i, min(max(idx, 0), in_size - 1)] += w
    return m.astype(np.float32)


def _apply_separable(x, my: np.ndarray, mx: np.ndarray):
    """Per-axis resize matrices applied to the last two axes of (..., H, W)."""
    my = torch.as_tensor(my, dtype=x.dtype, device=x.device)
    mx = torch.as_tensor(mx, dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,...hw->...ow", my, x)
    return torch.einsum("ow,...hw->...ho", mx, y)


def resize_bicubic_torch(x, out_hw, scale_hw=None):
    """Bicubic resize of (..., H, W) as torch F.interpolate computes it.
    ``scale_hw`` is the explicit scale_factor pair; None derives it from the
    sizes (torch's behaviour when size= is passed)."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    sh, sw = scale_hw if scale_hw is not None else (oh / h, ow / w)
    return _apply_separable(x, bicubic_matrix(h, oh, sh), bicubic_matrix(w, ow, sw))


def resize_linear_cv2(x, out_hw):
    """cv2.resize INTER_LINEAR equivalent on (..., H, W) float tensors."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    return _apply_separable(x, linear_matrix(h, oh), linear_matrix(w, ow))


def upsample_nearest(x, factor: int):
    """Exact block-repeat upsample of (..., H, W): torch nearest x factor."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def smooth_attention(attn_grid, patch_size: int, out_hw):
    """The reference's attention smoothing (eval.py:140-171) as one resize:
    nearest x patch_size, cv2 linear / patch_size down, cv2 linear up to
    out_hw. The nearest-up then linear-down pair is an exact identity (the
    2-tap sample at p*i + (p-1)/2 lands inside one repeated block), so the
    chain is one bilinear upsample of the (..., gh, gw) grid."""
    del patch_size  # folded away; kept for the call sites' clarity
    return resize_linear_cv2(attn_grid, out_hw)

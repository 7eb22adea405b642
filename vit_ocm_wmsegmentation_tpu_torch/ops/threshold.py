"""Otsu thresholding and the mosaic's multiplicative blend, on tensors.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/threshold.py``: the
reference blends in uint8 with truncation, and cv2's Otsu reads the 256-bin
histogram of that uint8 image, mapping pixels strictly above the threshold
to 255. Histogram counts are exact integers, cast to f32 once.

:func:`histogram_u8_kernel` is the streamed gigapixel path's histogram: it
launches ``csrc/histogram_u8.cu`` for CUDA tensors (replaces
``histogram_u8_pallas``) and takes its plain twin
:func:`histogram_u8_chunked` for CPU tensors; anything else raises. Its
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import build

_FLT_EPSILON = 1.1920929e-07
# pixels per pass of the bounded-memory helpers (an f32 chunk is 64 MB)
CHUNK_PX = 1 << 24


def min_max_normalize(x, dims=None):
    """Map to [0, 1] (utils.py:55-60); constant inputs pass unchanged.
    ``dims``: reduce over these axes only (one min/max per remaining index,
    as the JAX package's vmapped per-tile call); None reduces over all."""
    if dims is None:
        lo, hi = x.min(), x.max()
    else:
        lo, hi = x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)
    return _normalize(x, lo, hi)


def _normalize(x, lo, hi):
    return torch.where(hi == lo, x, (x - lo) / (hi - lo))


def map_rows(fn, *images):
    """uint8 (H, W) image fn(*images) computed over row chunks of about
    CHUNK_PX pixels, for an elementwise ``fn``: the same bits as one
    call, with fn's float temporaries bounded to a chunk (one f32 copy of a
    32768^2 image is 4.3 GB)."""
    h, w = images[0].shape
    out = torch.empty((h, w), dtype=torch.uint8, device=images[0].device)
    rows = max(1, CHUNK_PX // max(w, 1))
    for r0 in range(0, h, rows):
        out[r0 : r0 + rows] = fn(*(im[r0 : r0 + rows] for im in images))
    return out


def binary_above(img_u8, t):
    """(img_u8 > t) as uint8 {0, 255}, over row chunks. ``t`` is an Otsu
    threshold, an integer-valued f32 tensor in [0, 255], so comparing in
    uint8 equals comparing the f32 copy of the image."""
    t_u8 = t.to(torch.uint8)
    return map_rows(lambda x: (x > t_u8).to(torch.uint8) * 255, img_u8)


def attention_u8(attention):
    """uint8(min_max_normalize(attention) * 255), the attention image the
    heatmap Otsu thresholds, over row chunks."""
    lo, hi = attention.min().float(), attention.max().float()
    return map_rows(lambda a: (_normalize(a.float(), lo, hi) * 255.0).to(torch.uint8), attention)


def heatmap_otsu(attention):
    """threshold_multiplicative(img, attention)[2], the Otsu mask of the
    attention heatmap, with bounded memory: bit-equal for any image."""
    a8 = attention_u8(attention)
    return binary_above(a8, otsu_from_hist(histogram_u8_chunked(a8)))


def histogram_u8(img_u8):
    """256-bin histogram of a uint8 tensor (any shape): exact integer counts,
    cast to f32 once at the end."""
    return torch.bincount(img_u8.reshape(-1).long(), minlength=256).float()


def _histogram_u8_i64(flat_u8):
    """Exact int64 counts of a flat uint8 tensor (JAX ``_histogram_u8_i32``)."""
    return torch.bincount(flat_u8.long(), minlength=256)


def histogram_u8_chunked(img_u8, chunk_px: int = CHUNK_PX):
    """histogram_u8 with bounded memory for gigapixel inputs (JAX
    ``histogram_u8_chunked``): one bincount per ``chunk_px`` pixels, the
    int64 partials summed exactly, one cast to f32 at the end. Bit-equal to
    histogram_u8; the plain twin of :func:`histogram_u8_kernel`."""
    flat = img_u8.reshape(-1)
    hist = torch.zeros(256, dtype=torch.int64, device=flat.device)
    for i in range(0, flat.numel(), chunk_px):
        hist += _histogram_u8_i64(flat[i : i + chunk_px])
    return hist.float()


def histogram_u8_kernel(img_u8):
    """256-bin histogram of a uint8 tensor (any shape) as a hand-written
    CUDA kernel (replaces ``histogram_u8_pallas``): exact int64 counts,
    cast to f32 once. CPU tensors take the plain twin
    :func:`histogram_u8_chunked`; CUDA tensors launch the kernel (a
    non-contiguous input is copied first); anything else raises."""
    if img_u8.device.type == "cpu":
        return histogram_u8_chunked(img_u8)
    if img_u8.device.type != "cuda":
        raise ValueError(f"histogram_u8_kernel: no kernel for device {img_u8.device}")
    if img_u8.dtype != torch.uint8:
        raise ValueError(f"histogram_u8_kernel: want uint8, got {img_u8.dtype}")
    flat = img_u8.reshape(-1)
    counts = torch.zeros(256, dtype=torch.int64, device=flat.device)
    if flat.numel():
        rc = build.library().vitocm_histogram_u8(flat.data_ptr(), flat.numel(),
                                                 counts.data_ptr(), build.stream_ptr(flat.device))
        build.check(rc, "histogram_u8_kernel")
        histogram_u8_kernel.launches += 1
    return counts.float()


histogram_u8_kernel.launches = 0


def otsu_from_hist(hist):
    """cv2 THRESH_OTSU: argmax over t of w1*w2*(mu1-mu2)^2, first maximum
    kept, classes with vanishing mass skipped."""
    p = hist / hist.sum()
    bins = torch.arange(256, dtype=torch.float32, device=hist.device)
    w1 = torch.cumsum(p, 0)
    mu_cum = torch.cumsum(p * bins, 0)
    mu_total = mu_cum[-1]
    w2 = 1.0 - w1
    mu1 = mu_cum / torch.clamp_min(w1, _FLT_EPSILON)
    mu2 = (mu_total - mu_cum) / torch.clamp_min(w2, _FLT_EPSILON)
    sigma = w1 * w2 * (mu1 - mu2).square()
    valid = (torch.minimum(w1, w2) >= _FLT_EPSILON) & (torch.maximum(w1, w2) <= 1.0 - _FLT_EPSILON)
    sigma = torch.where(valid, sigma, torch.full_like(sigma, -1.0))
    return torch.argmax(sigma).float()  # first maximum


def otsu_binary_u8(img_u8):
    """cv2.threshold(..., THRESH_BINARY + THRESH_OTSU): (mask {0,255}, t)."""
    t = otsu_from_hist(histogram_u8(img_u8))
    mask = (img_u8.float() > t).to(torch.uint8) * 255
    return mask, t


def threshold_multiplicative(img_u8, attention):
    """sw_processing.py:37-81: result = img * minmax(attn), truncated to
    uint8. Returns the (blend, original image, attention) Otsu masks."""
    attn = min_max_normalize(attention.float())
    # the reference divides again by max(attn): 1 after min-max, or the
    # constant input's own value, guarded against zero
    result = (img_u8.float() * attn / torch.clamp_min(attn.max(), _FLT_EPSILON)).to(torch.uint8)
    attn_u8 = (attn * 255.0).to(torch.uint8)
    th, _ = otsu_binary_u8(result)
    th2, _ = otsu_binary_u8(img_u8)
    th3, _ = otsu_binary_u8(attn_u8)
    return th, th2, th3

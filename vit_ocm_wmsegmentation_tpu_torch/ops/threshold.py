"""Otsu and Yen thresholding and the reference's blends, on tensors.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/threshold.py``: the
reference blends in uint8 with truncation, and cv2's Otsu reads the 256-bin
histogram of that uint8 image, mapping pixels strictly above the threshold
to 255. Histogram counts are exact integers, cast to f32 once. The mosaic
takes the multiplicative blend (:func:`threshold_multiplicative`), the
eval path the alpha blend (:func:`threshold_ours`) and, for k-means and
Chan-Vese, the raw-max product (:func:`mult_blend_u8`). The single-image
histograms are ``torch.bincount``, as the JAX package's are XLA's
(``histogram_u8``, not its Pallas kernel).

:func:`histogram_u8_kernel` is the streamed gigapixel path's histogram: it
launches ``csrc/histogram_u8.cu`` for CUDA tensors (replaces
``histogram_u8_pallas``) and takes its plain twin
:func:`histogram_u8_chunked` for CPU tensors; anything else raises. Its
``launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
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


def histogram_u8_images(img_u8):
    """Per-image 256-bin histograms of uint8 images (..., H, W) -> (..., 256),
    one bincount for the whole batch (each image's values offset by 256 times
    its index); a 2-D image gives histogram_u8's counts."""
    lead, (h, w) = img_u8.shape[:-2], img_u8.shape[-2:]
    flat = img_u8.reshape(-1, h * w).long()
    n = flat.shape[0]
    flat = flat + 256 * torch.arange(n, device=flat.device)[:, None]
    return torch.bincount(flat.reshape(-1), minlength=256 * n).reshape(*lead, 256).float()


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
    """cv2 THRESH_OTSU of (..., 256) histograms: argmax over t of
    w1*w2*(mu1-mu2)^2, first maximum kept, classes with vanishing mass
    skipped. Returns the f32 bin index, one per histogram."""
    p = hist / hist.sum(-1, keepdim=True)
    bins = torch.arange(256, dtype=torch.float32, device=hist.device)
    w1 = torch.cumsum(p, -1)
    mu_cum = torch.cumsum(p * bins, -1)
    mu_total = mu_cum[..., -1:]
    w2 = 1.0 - w1
    mu1 = mu_cum / torch.clamp_min(w1, _FLT_EPSILON)
    mu2 = (mu_total - mu_cum) / torch.clamp_min(w2, _FLT_EPSILON)
    sigma = w1 * w2 * (mu1 - mu2).square()
    valid = (torch.minimum(w1, w2) >= _FLT_EPSILON) & (torch.maximum(w1, w2) <= 1.0 - _FLT_EPSILON)
    sigma = torch.where(valid, sigma, torch.full_like(sigma, -1.0))
    return torch.argmax(sigma, dim=-1).float()  # first maximum


def otsu_threshold_u8(img_u8):
    """Otsu threshold (an f32 bin index) of each uint8 image (..., H, W)."""
    return otsu_from_hist(histogram_u8_images(img_u8))


def otsu_binary_u8(img_u8):
    """cv2.threshold(..., THRESH_BINARY + THRESH_OTSU) of each uint8 image
    (..., H, W): (masks {0,255}, thresholds (...))."""
    t = otsu_threshold_u8(img_u8)
    mask = (img_u8.float() > t[..., None, None]).to(torch.uint8) * 255
    return mask, t


def _first_true(flags):
    """Index of the first True of a 1-D bool tensor (0 when none is)."""
    return torch.argmax(flags.to(torch.uint8))


def yen_threshold_u8(img_u8):
    """skimage.filters.threshold_yen of a uint8 image. skimage histograms
    over [img.min(), img.max()]: here a fixed 256-bin histogram whose bins
    outside that range carry no mass and are no split point. A constant
    image has no split point and gets its own value, as in skimage."""
    hist = histogram_u8(img_u8)
    bins = torch.arange(256, dtype=torch.float32, device=hist.device)
    lo = _first_true(hist > 0)
    hi = 255 - _first_true(torch.flip(hist, (0,)) > 0)
    pmf = hist / hist.sum()
    p1 = torch.cumsum(pmf, 0)
    p1_sq = torch.cumsum(pmf.square(), 0)
    tot_sq_from = pmf.square().sum() - p1_sq
    denom = p1_sq[:-1] * tot_sq_from[:-1]  # P2_sq[t+1] = sum_{i>t} pmf_i^2
    num = (p1[:-1] * (1.0 - p1[:-1])).square()
    crit = torch.log(num / denom)
    valid = (bins[:-1] >= lo) & (bins[:-1] < hi)
    crit = torch.where(valid & torch.isfinite(crit), crit, torch.full_like(crit, -torch.inf))
    return torch.where(lo == hi, bins[lo], bins[torch.argmax(crit)])


def yen_binary_u8(img_u8):
    """utils.py:237-248: the bool mask yen_threshold <= img."""
    return img_u8.float() >= yen_threshold_u8(img_u8)


def mult_blend_u8(img_u8, attention):
    """uint8(img * attention / max(attention)), truncated: the k-means and
    Chan-Vese input (utils.py:121, 203). Scales by the raw maximum, with no
    min-max, unlike threshold_ours and threshold_multiplicative."""
    a = attention.float()
    a = a / torch.clamp_min(a.max(), 1e-38)
    return (img_u8.float() * a).to(torch.uint8)


_BLEND_LUT = {}


def _blend_lut(alpha, device):
    """(256, 256) uint8 table of uint8((i / 2) * (1 - alpha) + (a / 2) * alpha)
    in float64, built once per alpha and device."""
    key = (float(alpha), str(device))
    if key not in _BLEND_LUT:
        iv = np.arange(256.0)
        lut = ((iv[:, None] / 2) * (1 - alpha) + (iv[None, :] / 2) * alpha).astype(np.uint8)
        _BLEND_LUT[key] = torch.from_numpy(lut).to(device)
    return _BLEND_LUT[key]


def blend_ours(img_u8, attention, alpha=0.4):
    """utils.py:69-81, for each image (..., H, W): the attention min-maxed
    and quantized to uint8, then alpha-blended with the half-intensity image
    and truncated to uint8.
    The reference blends in float64, whose rounding decides the ties at
    exact integers, and neither f32 nor integer arithmetic reproduces it:
    the blend of two uint8 values is read from a float64-built table.
    Returns (blend_u8, attn_u8)."""
    attn_u8 = (min_max_normalize(attention.float(), dims=(-2, -1)) * 255.0).to(torch.uint8)
    blend = _blend_lut(alpha, img_u8.device)[img_u8.long(), attn_u8.long()]
    return blend, attn_u8


def threshold_ours(img_u8, attention):
    """The reference's ``threshold`` (utils.py:62-115) of each image
    (..., H, W): the Otsu masks of the blend, of the image and of the
    attention heatmap, uint8 {0,255}."""
    blend_u8, attn_u8 = blend_ours(img_u8, attention)
    th, _ = otsu_binary_u8(blend_u8)
    th2, _ = otsu_binary_u8(img_u8)
    th3, _ = otsu_binary_u8(attn_u8)
    return th, th2, th3


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

"""Deterministic 2-means: the clustering back-ends of the eval methods.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/cluster.py``. The reference
calls cv2.kmeans on pixel triplets (utils.py:118-169) and sklearn's KMeans
on the last block's key features (utils.py:171-197), both with random
restarts. Here Lloyd's updates run a fixed number of steps from a
deterministic set of starts and the lowest-inertia solution is kept, as in
the JAX package: no host round trip, no data-dependent control flow. Ties
keep the first index (argmin, argmax), the median of an even count averages
its two middle values, and the feature z-score divides by the unbiased std.
"""

from __future__ import annotations

import torch

from .threshold import mult_blend_u8, otsu_binary_u8


def _sq_dist(points, centers):
    """(N, 2) squared distances of the points to the two centers."""
    return torch.stack([(points - c).square().sum(-1) for c in centers], dim=-1)


def _assign(points, centers):
    """Label of the nearer center, 0 on ties (argmin's first index)."""
    d = _sq_dist(points, centers)
    return (d[:, 1] < d[:, 0]).long()


def _lloyd(points, centers, iters):
    """points (N, D), centers (2, D) -> (labels (N,), centers (2, D))."""
    for _ in range(iters):
        w = torch.nn.functional.one_hot(_assign(points, centers), 2).to(points.dtype)  # (N, 2)
        tot = torch.clamp_min(w.sum(0), 1.0)
        centers = (w.T @ points) / tot[:, None]
    return _assign(points, centers), centers


def _median0(points):
    """numpy's median over axis 0: the mean of the two middle values of an
    even count. Sorts the columns (torch.quantile refuses more than 2^24
    elements, and feature clustering at 384^2 holds 147456 x 384)."""
    s = points.sort(dim=0).values
    n = points.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _candidate_inits(points, max_axis_splits=8):
    """The deterministic starts that replace cv2's and sklearn's random
    restarts: the farthest-point pair (the point of least coordinate sum and
    the point farthest from it), then for each of the max_axis_splits
    highest-variance axes (all axes when there are fewer) the means of the
    halves at or below and above the median on it. Returns (R, 2, D)."""
    c0 = points[torch.argmin(points.sum(-1))]
    c1 = points[torch.argmax((points - c0).square().sum(-1))]
    inits = [torch.stack([c0, c1])]
    med = _median0(points)
    d = points.shape[1]
    if d <= max_axis_splits:
        axes = torch.arange(d, device=points.device)
    else:
        var = points.var(dim=0, unbiased=False)
        axes = torch.argsort(-var, stable=True)[:max_axis_splits]
    cols, meds = points.index_select(1, axes), med.index_select(0, axes)
    for j in range(axes.shape[0]):
        wlo = (cols[:, j] <= meds[j]).to(points.dtype)[:, None]
        mlo = (points * wlo).sum(0) / torch.clamp_min(wlo.sum(), 1.0)
        mhi = (points * (1 - wlo)).sum(0) / torch.clamp_min((1 - wlo).sum(), 1.0)
        inits.append(torch.stack([mlo, mhi]))
    return torch.stack(inits)


def kmeans2(points, iters=20):
    """2-means of (N, D) points: (labels (N,), centers (2, D)). Lloyd from
    every start of :func:`_candidate_inits`, the lowest inertia kept (the
    first on ties), as cv2's attempts=10 and sklearn's n_init=10 keep their
    best, without randomness."""
    points = points.float()
    labels, centers, inertia = [], [], []
    for init in _candidate_inits(points):
        lab, cen = _lloyd(points, init, iters)
        labels.append(lab)
        centers.append(cen)
        inertia.append((points - cen[lab]).square().sum(-1).sum())
    best = torch.argmin(torch.stack(inertia))
    return torch.stack(labels)[best], torch.stack(centers)[best]


def _paint_and_otsu(img_u8, points):
    """Cluster the pixel triplets, paint each with its center's uint8 value,
    and Otsu the painted image: a {0,255} uint8 mask."""
    labels, centers = kmeans2(points)
    painted = centers.to(torch.uint8)[labels].reshape(img_u8.shape)
    return otsu_binary_u8(painted)[0]


def kmeans_mask_ours(img_u8, attention):
    """The reference's ``kmeans`` blend branch (utils.py:118-140): the image
    times the attention over its raw maximum (no min-max, utils.py:121),
    truncated, clustered as pixel triplets with k = 2, painted with the
    centers' uint8 values and Otsu-thresholded. reshape(-1, 3) groups three
    consecutive pixels into one point, as the reference does, so H * W must
    be a multiple of 3."""
    result = mult_blend_u8(img_u8, attention)
    return _paint_and_otsu(result, result.reshape(-1, 3).float())


def kmeans_mask_image(img_u8):
    """The ``kmeans`` original-image branch (utils.py:141-155): the gray
    pixel triplets clustered, painted, Otsu-thresholded."""
    return _paint_and_otsu(img_u8, img_u8.reshape(-1, 3).float())


def kmeans_feature_mask(features, gray_u8=None):
    """kmeans_feature (utils.py:171-197): the per-pixel (H, W, D) feature
    vectors z-scored (unbiased std), 2-means, the {0,255} uint8 label map.
    The reference's cluster identity is whichever label sklearn's random
    start gave; with ``gray_u8`` (H, W) the cluster of higher mean gray
    becomes the foreground (the bright-is-foreground convention of Otsu's
    THRESH_BINARY), as in the JAX package. No label is consulted."""
    h, w, d = features.shape
    pts = features.reshape(-1, d).float()
    pts = (pts - pts.mean(0)) / torch.clamp_min(pts.std(0), 1e-12)
    labels, _ = kmeans2(pts, iters=30)
    labels = labels.reshape(h, w)
    if gray_u8 is not None:
        g = gray_u8.float().reshape(h, w)
        on = labels.float()
        m1 = (g * on).sum() / torch.clamp_min(on.sum(), 1.0)
        m0 = (g * (1 - on)).sum() / torch.clamp_min((1 - on).sum(), 1.0)
        labels = torch.where(m1 >= m0, labels, 1 - labels)
    return labels.to(torch.uint8) * 255

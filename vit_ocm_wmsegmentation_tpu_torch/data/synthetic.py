"""Seeded synthetic inputs of the measurements and proofs on the card: an
OCM-like mosaic at any size, labeled pieces of it, and the MIM step's batch.
The same arguments give the same arrays."""

from __future__ import annotations

import numpy as np
import torch

from .mask_generator import MaskGenerator

MIM_BATCH, MIM_SIZE = 16, 384  # mim.py's defaults


def make_mosaic(size: int) -> np.ndarray:
    """OCM-like synthetic content at gigapixel scale without gigabytes of
    f64 random numbers: a 4096^2 noise texture tiled, plus low-frequency
    structure so that tiles differ and the global Otsu sees a bimodal
    histogram (a copy of tools/bench_gigapixel.py's)."""
    rng = np.random.default_rng(0)
    tex = rng.normal(110, 35, (4096, 4096)).astype(np.float32)
    reps = -(-size // 4096)
    out = np.empty((size, size), np.uint8)
    yy = np.linspace(0, 2 * np.pi, size, dtype=np.float32)
    rowmod = (20 * np.sin(3 * yy)).astype(np.float32)
    colmod = (25 * np.cos(2 * yy)).astype(np.float32)
    for i in range(reps):
        y0, y1 = i * 4096, min((i + 1) * 4096, size)
        band = np.tile(tex[: y1 - y0], (1, reps))[:, :size]
        band = band + rowmod[y0:y1, None] + colmod[None, :]
        # bright "white matter" blobs on a coarse grid
        band[(np.arange(y0, y1)[:, None] // 2048 + np.arange(size)[None, :] // 2048) % 3 == 0] += 55
        out[y0:y1] = np.clip(band, 0, 255).astype(np.uint8)
    return out


def eval_pieces(n: int, size: int = 384, seed: int = 0):
    """n (size, size) uint8 pieces of make_mosaic(8192), each across a
    corner of its 2048-pixel grid of bright blobs, and their uint8 {0, 255}
    labels from the rule that placed the blobs (a bright cell is
    foreground). Returns (pieces (n, size, size), labels (n, size, size))."""
    big = make_mosaic(8192)
    rng = np.random.default_rng(seed)
    pieces, labels = [], []
    for _ in range(n):
        y0, x0 = 2048 * rng.integers(1, 4, 2) - rng.integers(84, 300, 2)
        yy, xx = np.mgrid[y0 : y0 + size, x0 : x0 + size]
        labels.append(((yy // 2048 + xx // 2048) % 3 == 0).astype(np.uint8) * 255)
        pieces.append(big[y0 : y0 + size, x0 : x0 + size])
    return np.stack(pieces), np.stack(labels)


def seg_batch(n, size, seed, dev):
    """n seeded size^2 pieces of the synthetic OCM mosaic as the loader
    gives them, x (n, size, size, 3) f32 in [0, 1], and their labels y
    (n, size, size, 1), on ``dev``."""
    pieces, labels = eval_pieces(n, size, seed)
    x = torch.from_numpy(np.repeat(pieces[..., None], 3, -1)).to(dev).float() / 255.0
    return x, torch.from_numpy(labels[..., None]).to(dev).float() / 255.0


def mim_batch(dev):
    """The MIM step's batch: MIM_BATCH random MIM_SIZE^2 RGB images in
    [0, 1) and their SimMIM masks (mask patch 16, model patch 8, ratio 0.5),
    all from ``np.random.default_rng(0)``, on ``dev``."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((MIM_BATCH, MIM_SIZE, MIM_SIZE, 3), dtype=np.float32)).to(dev)
    gen_mask = MaskGenerator(MIM_SIZE, 16, 8, 0.5)
    mask = torch.from_numpy(np.stack([gen_mask(rng) for _ in range(MIM_BATCH)])).to(dev)
    return x, mask

"""Inputs made from the seed: OCM-like uint8 mosaics and SimMIM source tiles.

:func:`ocm_mosaic` is the port's ``profile_gigapixel.make_mosaic`` (itself a
copy of ``tools/bench_gigapixel.py``'s) frozen here and seeded: a noise
texture N(110, 35) of at most 4096^2 tiled over the mosaic, a low-frequency
row and column modulation (20 sin 3y, 25 cos 2x over the mosaic's span), and
bright "white matter" blobs (+55) on the cells of a coarse grid whose index
sum is a multiple of 3, clipped to uint8. The seed draws the texture and,
where the original fixed them at 0, the modulations' phases and the blob
grid's offset, so that the mosaics of one seed differ. It runs on any
device with a generator there; one seed gives the same mosaics on one
device type.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

TEXTURE = 4096


def ocm_mosaic(height: int, width: int, blob: int, seed: int, index: int, device):
    """One (height, width) uint8 mosaic, the ``index``-th of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)[0] >> 1))
    th, tw = min(height, TEXTURE), min(width, TEXTURE)
    tex = torch.randn((th, tw), generator=gen, device=device) * 35.0 + 110.0
    phase = torch.rand(4, generator=gen, device=device)
    reps_y, reps_x = -(-height // th), -(-width // tw)
    img = tex.repeat(reps_y, reps_x)[:height, :width]
    yy = torch.linspace(0, 2 * math.pi, height, device=device)
    xx = torch.linspace(0, 2 * math.pi, width, device=device)
    img = img + (20.0 * torch.sin(3 * yy + 2 * math.pi * phase[0]))[:, None]
    img = img + (25.0 * torch.cos(2 * xx + 2 * math.pi * phase[1]))[None, :]
    oy = (phase[2] * blob).long()
    ox = (phase[3] * blob).long()
    cy = (torch.arange(height, device=device) + oy) // blob
    cx = (torch.arange(width, device=device) + ox) // blob
    img = img + 55.0 * ((cy[:, None] + cx[None, :]) % 3 == 0)
    return torch.clamp(img, 0, 255).to(torch.uint8)


def mosaic_pool(size: int, blob: int, count: int, seed: int, device):
    """``count`` distinct (size, size) mosaics of ``seed``, (count, size, size)."""
    return torch.stack([ocm_mosaic(size, size, blob, seed, i, device) for i in range(count)])


def source_tiles(tile: int, rows: int, cols: int, blob: int, seed: int, device):
    """(rows * cols, tile, tile) uint8 tiles cut row-major from one
    (rows*tile, cols*tile) OCM-like mosaic of ``seed``, as the repository's
    ``croping.py`` cuts a mosaic into training tiles."""
    m = ocm_mosaic(rows * tile, cols * tile, blob, seed, 0, device)
    return m.reshape(rows, tile, cols, tile).permute(0, 2, 1, 3).reshape(-1, tile, tile)


def write_pngs(tiles, directory: str):
    """Grayscale PNG files ``src_<i>.png`` of uint8 tiles (N, h, w); returns
    their paths."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, t in enumerate(tiles.cpu().numpy()):
        p = os.path.join(directory, f"src_{i:04d}.png")
        Image.fromarray(t).save(p, compress_level=1)
        paths.append(p)
    return paths

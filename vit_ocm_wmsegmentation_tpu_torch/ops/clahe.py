"""CLAHE: contrast-limited adaptive histogram equalization, on the device.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/clahe.py`` (the reference's
adaptive_histogram_equalization, utils.py:46-53 / sw_processing.py:21-28:
``cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))``, defined there and
off the metric path). cv2's algorithm on a uint8 (H, W) tensor: a clipped
histogram per tile with the excess redistributed as cv2 does (a uniform
batch to every bin, the residual at a stride from bin 0), an equalization
table per tile rounded with ``floor(x + 0.5)`` (cv2's saturate_cast), and
the bilinear blend of the four surrounding tiles' tables at each pixel, in
float32 with the JAX package's order of operations, so that the uint8
result is the JAX package's bit for bit.
"""

from __future__ import annotations

import torch


def clahe(img_u8, clip_limit: float = 2.0, grid: int = 8):
    """uint8 (H, W) -> uint8 (H, W) on img_u8's device. H and W must be
    multiples of grid (cv2 pads inside; the callers' sizes, 384 and 1152,
    are)."""
    h, w = img_u8.shape
    if h % grid or w % grid:
        raise ValueError(f"CLAHE: ({h}, {w}) is not a multiple of the {grid} x {grid} grid")
    dev = img_u8.device
    th, tw = h // grid, w // grid
    area = th * tw
    clip = max(int(clip_limit * area / 256.0), 1)
    t = grid * grid

    tiles = img_u8.reshape(grid, th, grid, tw).permute(0, 2, 1, 3).reshape(t, area)
    flat = (tiles.long() + torch.arange(t, device=dev)[:, None] * 256).reshape(-1)
    hists = torch.bincount(flat, minlength=t * 256).reshape(t, 256).float()

    clipped = torch.clamp(hists, max=float(clip))
    excess = (hists - clipped).sum(dim=1, keepdim=True)
    batch = torch.floor(excess / 256.0)
    residual = excess - batch * 256.0
    bins = torch.arange(256, device=dev)[None]
    res_i = residual.int()
    step = torch.clamp(256 // torch.clamp(res_i, min=1), min=1)
    gets_one = (bins % step == 0) & (bins // step < res_i) & (res_i > 0)
    clipped = clipped + batch + gets_one.float()

    cdf = torch.cumsum(clipped, dim=1)
    luts = torch.clamp(torch.floor(cdf * (255.0 / area) + 0.5), 0, 255).reshape(grid, grid, 256)

    # bilinear blend of the 4 surrounding tiles' tables, cv2's convention:
    # tile centres at (i + 0.5) * tile size
    ys = (torch.arange(h, dtype=torch.float32, device=dev) - th / 2.0) / th
    xs = (torch.arange(w, dtype=torch.float32, device=dev) - tw / 2.0) / tw
    y0 = torch.clamp(torch.floor(ys), -1, grid - 1)
    x0 = torch.clamp(torch.floor(xs), -1, grid - 1)
    wy, wx = ys - y0, xs - x0
    y0c, y1c = torch.clamp(y0, 0, grid - 1).long(), torch.clamp(y0 + 1, 0, grid - 1).long()
    x0c, x1c = torch.clamp(x0, 0, grid - 1).long(), torch.clamp(x0 + 1, 0, grid - 1).long()
    v = img_u8.long()

    def lut_at(yidx, xidx):
        return luts[yidx[:, None], xidx[None, :], v]

    top = lut_at(y0c, x0c) * (1 - wx)[None, :] + lut_at(y0c, x1c) * wx[None, :]
    bot = lut_at(y1c, x0c) * (1 - wx)[None, :] + lut_at(y1c, x1c) * wx[None, :]
    out = top * (1 - wy)[:, None] + bot * wy[:, None]
    # the output rounds as the JAX package's jnp.round does: half to even
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def adaptive_histogram_equalization(image):
    """utils.py:46-53: clip to uint8, then CLAHE(2.0, 8 x 8)."""
    return clahe(torch.clamp(image, 0, 255).to(torch.uint8), clip_limit=2.0, grid=8)

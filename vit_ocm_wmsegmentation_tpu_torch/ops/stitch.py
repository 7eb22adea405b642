"""Mosaic tiling and blended overlap-add stitching, on tensors.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/stitch.py``. The numpy
builders (tile starts, 1D blend profiles, the uint8 re-stitch table) are
copies of the JAX package's and are tested equal to them. The reference
blends overlapping tiles with an iterative linear ramp
(sw_processing.py:113-149); since that blend is linear in the tile values,
the stitched mosaic is ``sum_ij v_i(y) h_j(x) tile_ij`` with 1D profiles
simulated once per geometry in float64, and the overlap-add runs as k x k
shifted block adds (window = k * stride). The crop > 1 eval path's grid
concats (:func:`concat_crops`, :func:`concat_crops_overlap`) close it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def tile_starts(size: int, window: int, stride: int) -> np.ndarray:
    """Tile start offsets covering [0, size-window] at the given stride; the
    window must tile the span exactly (pipeline.pad_mosaic arranges that)."""
    assert (size - window) % stride == 0 and size >= window, (
        f"mosaic size {size} not tiled exactly by window {window} / stride {stride}; pad first"
    )
    return np.arange(0, size - window + 1, stride)


def extract_tiles(image, ys, xs, window: int):
    """Batched tile gather: image (H, W, ...) -> (len(ys)*len(xs), window,
    window, ...), row-major tile order (y outer, x inner)."""
    dev = image.device
    ar = torch.arange(window, device=dev)
    rows = torch.as_tensor(np.asarray(ys), device=dev)[:, None] + ar  # (I, window)
    cols = torch.as_tensor(np.asarray(xs), device=dev)[:, None] + ar  # (J, window)
    tiles = image[rows[:, None, :, None], cols[None, :, None, :]]  # (I, J, win, win, ...)
    return tiles.reshape((-1, window, window) + tuple(image.shape[2:]))


@lru_cache(maxsize=32)
def blend_profiles_1d(n: int, window: int, stride: int) -> np.ndarray:
    """Per-tile weight profiles (n, window) of the reference's iterative
    linear-ramp blend (sw_processing.py:113-149), via indicator simulation:
    feeding tile_j = 1 (others 0) through the recurrence yields tile j's
    coefficient at every global position. float64, like the reference."""
    step = window - stride
    if step == 0:  # non-overlapping tiles: plain concat, unit weights
        return np.ones((n, window))
    ramp = np.linspace(1.0, 0.0, step)
    out = np.zeros((n, window))
    for j in range(n):
        tiles = np.zeros((n, window))
        tiles[j] = 1.0
        acc = tiles[0].copy()
        for t in range(1, n):
            right = tiles[t]
            overlap = acc[-step:] * ramp + right[:step] * (1.0 - ramp)
            acc = np.concatenate([acc[:-step], overlap, right[-stride:]])
        out[j] = acc[j * stride : j * stride + window]
    return out


def overlap_add(tiles, weights_y, weights_x, window: int, stride: int, out_hw):
    """Weighted overlap-add stitch: tiles (I*J, window, window) row-major,
    weights_y (I, window), weights_x (J, window) -> (H, W). Needs
    window % stride == 0; the weighted tiles accumulate block-wise with
    k = window // stride shifted adds."""
    ii, jj = weights_y.shape[0], weights_x.shape[0]
    h, w = out_hw
    assert window % stride == 0, "overlap_add requires window to be a multiple of stride"
    k = window // stride
    wy = torch.as_tensor(weights_y, dtype=tiles.dtype, device=tiles.device)
    wx = torch.as_tensor(weights_x, dtype=tiles.dtype, device=tiles.device)
    t = tiles.reshape(ii, jj, window, window)
    t = t * wy[:, None, :, None] * wx[None, :, None, :]
    t = t.reshape(ii, jj, k, stride, k, stride).permute(2, 4, 0, 1, 3, 5)  # (k,k,I,J,s,s)
    by, bx = ii + k - 1, jj + k - 1
    acc = torch.zeros((by, bx, stride, stride), dtype=tiles.dtype, device=tiles.device)
    for dy in range(k):
        for dx in range(k):
            acc[dy : dy + ii, dx : dx + jj] += t[dy, dx]
    out = acc.permute(0, 2, 1, 3).reshape(by * stride, bx * stride)
    return out[:h, :w]


def stitch_blended(tiles, window: int, stride: int, out_hw):
    """The reference's concat_crops for float tiles: (T, window, window)
    row-major -> (H, W) with blended overlaps, as one overlap-add."""
    h, w = out_hw
    wy = blend_profiles_1d(len(tile_starts(h, window, stride)), window, stride)
    wx = blend_profiles_1d(len(tile_starts(w, window, stride)), window, stride)
    return overlap_add(tiles, wy, wx, window, stride, out_hw)


@lru_cache(maxsize=16)
def _restitch_u8_table(n: int, window: int, stride: int) -> np.ndarray:
    """(256, S) uint8 table with S = window + (n-1)*stride: the value the
    reference's concat_crops (sw_processing.py:113-134) produces at global
    1D position x when every source tile holds the constant value v, with
    its float64 blend and per-blend uint8 truncation."""
    step = window - stride
    vals = np.arange(256, dtype=np.float64)
    tile = np.repeat(vals[:, None], window, axis=1).astype(np.uint8)
    if step == 0 or n == 1:
        return np.concatenate([tile] + [tile[:, -stride:]] * (n - 1), axis=1)
    w = np.linspace(1.0, 0.0, step)
    acc = tile.copy()
    for _ in range(1, n):
        left = acc[:, -step:].astype(np.float64)
        right = tile[:, :step].astype(np.float64)
        overlap = (left * w + right * (1.0 - w)).astype(np.uint8)
        acc = np.concatenate([acc[:, :-step], overlap, tile[:, -stride:]], axis=1)
    return acc


def restitch_u8(img_u8, window: int, stride: int, chunk_px: int = 1 << 24):
    """The uint8 mosaic the reference obtains by tiling img and
    blend-restitching the tiles (sw_processing.py:227-229): a per-pixel
    gather out[y, x] = Tv[Th[img[y, x], x], y] through the two 1D truncation
    tables (horizontal blends first, then vertical, as the reference). The
    gather runs over row chunks of about ``chunk_px`` pixels, so its int64
    index temporaries stay bounded (8.6 GB each for one 32768^2 gather);
    the gathered values do not depend on the chunking."""
    h, w = img_u8.shape
    dev = img_u8.device
    n_y = len(tile_starts(h, window, stride))
    n_x = len(tile_starts(w, window, stride))
    th = torch.as_tensor(_restitch_u8_table(n_x, window, stride), device=dev)  # (256, W)
    tv = torch.as_tensor(_restitch_u8_table(n_y, window, stride), device=dev)  # (256, H)
    cols = torch.arange(w, device=dev)
    out = torch.empty_like(img_u8)
    step = max(1, chunk_px // w)
    for r0 in range(0, h, step):
        r1 = min(r0 + step, h)
        rows = torch.arange(r0, r1, device=dev)
        hpass = th[img_u8[r0:r1].long(), cols[None, :]]
        out[r0:r1] = tv[hpass.long(), rows[:, None]]
    return out


# ---------------------------------------------------------------------------
# Grid concat (utils.py:304-317) and the //2-averaged overlap concat
# (utils.py:319-347) of the crop > 1 eval and analysis paths
# ---------------------------------------------------------------------------


def concat_crops(crops):
    """(T, h, w) crops of a row-major square grid -> (sqrt(T)*h, sqrt(T)*w)."""
    t, h, w = crops.shape
    g = int(np.sqrt(t))
    if g * g != t:
        raise ValueError(f"{t} crops do not make a square grid")
    return crops.reshape(g, g, h, w).permute(0, 2, 1, 3).reshape(g * h, g * w)


def _half(x):
    """x // 2 with numpy's floor semantics for integers and floats alike."""
    return torch.div(x, 2, rounding_mode="floor")


def concat_crops_overlap(crops, stride: int):
    """utils.py concat_crops_overlap: neighbours overlap by 2 * stride and
    the overlap is a // 2 + b // 2 (floor division, for floats too). The
    literal iterative algorithm: the floor makes it non-linear."""
    t = crops.shape[0]
    g = int(np.sqrt(t))
    ov = stride * 2
    rows = []
    for i in range(g):
        horiz = crops[i * g]
        for j in range(1, g):
            right = crops[i * g + j]
            overlap = _half(horiz[:, -ov:]) + _half(right[:, :ov])
            horiz = torch.cat([horiz[:, :-ov], overlap, right[:, ov:]], dim=1)
        rows.append(horiz)
    vert = rows[0]
    for i in range(1, g):
        if i == g - 1:
            vert = torch.cat([vert, rows[i][ov:, :]], dim=0)
        else:
            top = _half(vert[-ov:, :]) + _half(rows[i][:ov, :])
            vert = torch.cat([vert[:-ov, :], top, rows[i][ov:, :]], dim=0)
    return vert

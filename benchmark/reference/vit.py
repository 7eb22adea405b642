"""Plain float32 reference of the DINO ViT and of the sliding-window mosaic
segmentation (facebookresearch/dino ``vision_transformer.py``; the paper's
``sw_processing.py``), in plain PyTorch.

It imports nothing of the program and takes its weights as a state dict of
the timm/DINO keys (``blocks.{i}.attn.qkv.weight`` ...). Every product goes
through :mod:`.precision`, so that the same code is the float32 reference
and, one precision down, the control of the correctness check. Attention is
materialized (softmax of the full score matrix), tiles run in chunks so that
the score matrices fit.

The mosaic chain is the reference's: the grayscale mosaic cut into
``window`` tiles at ``stride``, each tile replicated to RGB and scaled to
[0, 1], the last block's CLS attention over the patches averaged over heads,
min-max normalized per tile and scaled by 255, bilinearly resized to the
window (half-pixel centres, edges clamped), the tiles stitched by the
iterative linear-ramp blend (each new tile's overlap mixed in with weights
falling from 1 to 0 across the overlap, along rows first, then the rows of
tiles), and the mask taken by the multiplicative Otsu threshold: the image
times the min-max normalized attention, truncated to uint8, thresholded at
cv2's Otsu level of its histogram.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import linear, matmul, matmul_flags, round_operand, store

FLT_EPSILON = 1.1920929e-07
TILE_CHUNK = 8  # tiles per forward: (8, heads, 2305, 2305) f32 scores are 1 GB


def _p(state, name):
    return state[name].float()


def patch_embed(state, cfg, x, precision):
    """(B, H, W, 3) -> (B, gh*gw, D): the stride-p convolution."""
    w = round_operand(_p(state, "patch_embed.proj.weight"), precision)
    y = F.conv2d(round_operand(x.permute(0, 3, 1, 2), precision), w,
                 _p(state, "patch_embed.proj.bias"), stride=cfg["patch_size"])
    return store(y.flatten(2).transpose(1, 2), precision)


def pos_embed_for(state, cfg, gh, gw):
    """DINO's interpolate_pos_encoding: bicubic, the scale factor taken from
    the grid plus 0.1."""
    pos = _p(state, "pos_embed")
    n = pos.shape[1] - 1
    g = int(math.sqrt(n))
    if gh == g and gw == g:
        return pos
    grid = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + 0.1) / g, (gw + 0.1) / g), mode="bicubic")
    if grid.shape[-2:] != (gh, gw):
        raise ValueError(f"positional grid {tuple(grid.shape[-2:])} != ({gh}, {gw})")
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def layer_norm(state, prefix, cfg, x, precision="float32"):
    return store(F.layer_norm(x, (x.shape[-1],), _p(state, prefix + ".weight"),
                              _p(state, prefix + ".bias"), cfg["ln_eps"]), precision)


def _heads(t, b, n, heads):
    return t.reshape(b, n, heads, -1).permute(0, 2, 1, 3)


def block(state, cfg, i, tok, precision):
    """One pre-norm block: x + attn(ln1(x)); x + mlp(ln2(x))."""
    pre = f"blocks.{i}"
    b, n, d = tok.shape
    heads = cfg["num_heads"]
    h = layer_norm(state, pre + ".norm1", cfg, tok, precision)
    qkv = store(linear(h, _p(state, pre + ".attn.qkv.weight"),
                       _p(state, pre + ".attn.qkv.bias"), precision), precision)
    q, k, v = (_heads(t, b, n, heads) for t in qkv.split(d, dim=-1))
    scores = matmul(q, k.transpose(-1, -2), precision) * (d // heads) ** -0.5
    o = store(matmul(store(torch.softmax(scores, dim=-1), precision), v, precision), precision)
    del scores
    o = o.permute(0, 2, 1, 3).reshape(b, n, d)
    tok = store(tok + linear(o, _p(state, pre + ".attn.proj.weight"),
                             _p(state, pre + ".attn.proj.bias"), precision), precision)
    h = layer_norm(state, pre + ".norm2", cfg, tok, precision)
    h = store(F.gelu(linear(h, _p(state, pre + ".mlp.fc1.weight"),
                            _p(state, pre + ".mlp.fc1.bias"), precision)), precision)
    return store(tok + linear(h, _p(state, pre + ".mlp.fc2.weight"),
                              _p(state, pre + ".mlp.fc2.bias"), precision), precision)


def prepare_tokens(state, cfg, x, precision):
    b, hgt, wdt, _ = x.shape
    p = cfg["patch_size"]
    tok = patch_embed(state, cfg, store(x, precision), precision)
    cls = _p(state, "cls_token").expand(b, 1, -1)
    return store(torch.cat([cls, tok], dim=1) + pos_embed_for(state, cfg, hgt // p, wdt // p),
                 precision)


def cls_attention(state, cfg, x, precision="float32"):
    """The last block's CLS attention over the patches: (B, H, W, 3) in
    [0, 1] -> (B, heads, gh, gw)."""
    b, hgt, wdt, _ = x.shape
    p, heads, depth = cfg["patch_size"], cfg["num_heads"], cfg["depth"]
    tok = prepare_tokens(state, cfg, x, precision)
    for i in range(depth - 1):
        tok = block(state, cfg, i, tok, precision)
    pre = f"blocks.{depth - 1}"
    h = layer_norm(state, pre + ".norm1", cfg, tok, precision)
    n, d = tok.shape[1], tok.shape[2]
    qkv = linear(h, _p(state, pre + ".attn.qkv.weight"), _p(state, pre + ".attn.qkv.bias"),
                 precision)
    q, k, _ = (_heads(t, b, n, heads) for t in qkv.split(d, dim=-1))
    scores = matmul(q[:, :, :1], k.transpose(-1, -2), precision) * (d // heads) ** -0.5
    attn = store(torch.softmax(scores, dim=-1)[:, :, 0, 1:], precision)
    return attn.reshape(b, heads, hgt // p, wdt // p)


def tile_maps(state, cfg, tiles_u8, precision="float32"):
    """(T, w, w) uint8 tiles -> (T, w, w) float32 attention maps: head mean,
    min-max per tile, x255, bilinear to the window."""
    window = tiles_u8.shape[-1]
    out = []
    for i in range(0, tiles_u8.shape[0], TILE_CHUNK):
        x = (tiles_u8[i : i + TILE_CHUNK].float() / 255.0)[..., None].expand(-1, -1, -1, 3)
        avg = store(cls_attention(state, cfg, x, precision).mean(dim=1), precision)
        lo = avg.amin(dim=(-2, -1), keepdim=True)
        hi = avg.amax(dim=(-2, -1), keepdim=True)
        g = torch.where(hi == lo, avg, (avg - lo) / (hi - lo)) * 255.0
        out.append(F.interpolate(g[:, None], size=(window, window), mode="bilinear",
                                 align_corners=False)[:, 0])
    return torch.cat(out)


def tile_starts(size, window, stride):
    if size < window or (size - window) % stride:
        raise ValueError(f"size {size} is not tiled exactly by window {window}, stride {stride}")
    return list(range(0, size - window + 1, stride))


def blend_concat(parts, stride, dim):
    """The iterative linear-ramp concat of overlapping parts along ``dim``:
    each new part's leading overlap mixed with the canvas's trailing one,
    the canvas weighted from 1 down to 0."""
    acc = parts[0]
    step = parts[0].shape[dim] - stride
    if step == 0:
        return torch.cat(parts, dim=dim)
    shape = [1] * acc.ndim
    shape[dim] = step
    ramp = torch.linspace(1.0, 0.0, step, dtype=acc.dtype, device=acc.device).reshape(shape)
    for right in parts[1:]:
        n = acc.shape[dim]
        overlap = acc.narrow(dim, n - step, step) * ramp + right.narrow(dim, 0, step) * (1 - ramp)
        acc = torch.cat([acc.narrow(dim, 0, n - step), overlap,
                         right.narrow(dim, step, right.shape[dim] - step)], dim=dim)
    return acc


def stitch_rows(maps, n_cols, stride):
    """(R * n_cols, w, w) maps of R consecutive tile rows -> the blended
    strip (w + (R-1)*stride, W)."""
    rows = [blend_concat(list(maps[r * n_cols : (r + 1) * n_cols]), stride, dim=1)
            for r in range(maps.shape[0] // n_cols)]
    return blend_concat(rows, stride, dim=0)


@torch.no_grad()
def canvas_rows(state, cfg, img_u8, window, stride, first_row, last_row, precision="float32"):
    """The attention canvas over the mosaic rows that tile rows
    [first_row, last_row] alone determine: (rows (y0, y1), (y1 - y0, W)).
    A canvas row is final once the blend has passed it, and depends on the
    tiles that cover it only, so rows from first_row's second stride on (from
    0 for the first tile row) up to last_row's end of its first stride (the
    mosaic's end for the last tile row) equal the whole mosaic's canvas."""
    h, w = img_u8.shape
    ys, xs = tile_starts(h, window, stride), tile_starts(w, window, stride)
    if not 0 <= first_row <= last_row < len(ys):
        raise ValueError(f"tile rows [{first_row}, {last_row}] outside 0..{len(ys) - 1}")
    with matmul_flags(precision):
        maps = []
        for r in range(first_row, last_row + 1):
            strip = img_u8[ys[r] : ys[r] + window]
            tiles = torch.stack([strip[:, x : x + window] for x in xs])
            maps.append(tile_maps(state, cfg, tiles, precision))
        canvas = stitch_rows(torch.cat(maps), len(xs), stride)
    y_base = ys[first_row]
    y0 = 0 if first_row == 0 else ys[first_row] + window - stride
    y1 = h if last_row == len(ys) - 1 else ys[last_row] + stride
    return (y0, y1), canvas[y0 - y_base : y1 - y_base]


def attention_canvas(state, cfg, img_u8, window, stride, precision="float32"):
    """The whole mosaic's attention canvas (H, W) float32."""
    n_rows = len(tile_starts(img_u8.shape[0], window, stride))
    return canvas_rows(state, cfg, img_u8, window, stride, 0, n_rows - 1, precision)[1]


def otsu_cv2(hist) -> int:
    """cv2's THRESH_OTSU level of a 256-bin histogram, its loop in float64."""
    h = np.asarray(hist, dtype=np.float64)
    scale = 1.0 / h.sum()
    mu = float((np.arange(256) * h).sum() * scale)
    q1 = mu1 = max_sigma = 0.0
    max_val = 0
    for i in range(256):
        p_i = h[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < FLT_EPSILON or max(q1, q2) > 1.0 - FLT_EPSILON:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, i
    return max_val


ROW_CHUNK = 1024


@torch.no_grad()
def threshold_multiplicative(img_u8, attn):
    """The mask (H, W) uint8 {0, 255} of the multiplicative Otsu threshold,
    over row chunks: uint8(img * minmax(attn) / max(minmax(attn)))
    above its Otsu level."""
    lo, hi = attn.min(), attn.max()
    const = bool(hi == lo)
    top = torch.clamp_min(hi, FLT_EPSILON) if const else torch.ones_like(hi)

    def blend(r0):
        a = attn[r0 : r0 + ROW_CHUNK].float()
        a = a if const else (a - lo) / (hi - lo)
        return (img_u8[r0 : r0 + ROW_CHUNK].float() * a / top).to(torch.uint8)

    rows = range(0, img_u8.shape[0], ROW_CHUNK)
    hist = sum(torch.bincount(blend(r0).reshape(-1).long(), minlength=256) for r0 in rows)
    t = otsu_cv2(hist.cpu().numpy())
    return torch.cat([(blend(r0) > t).to(torch.uint8) * 255 for r0 in rows])

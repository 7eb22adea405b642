"""Plain float32 reference of DINOv2 ViT-g/14 with registers and of the
sliding-window mosaic segmentation over it, in plain PyTorch.

Written from facebookresearch/dinov2: ``hub/backbones.py``
(``dinov2_vitg14_reg``: ``vit_giant2``, ``ffn_layer="swiglufused"``, 4
register tokens, ``interpolate_antialias=True``, ``interpolate_offset=0.0``),
``models/vision_transformer.py`` (``prepare_tokens_with_masks``,
``interpolate_pos_encoding``), ``layers/block.py``, ``layers/swiglu_ffn.py``
and ``layers/layer_scale.py``; Oquab et al., arXiv:2304.07193; Darcet et al.,
arXiv:2309.16588. It imports nothing of the program and takes its weights as
a state dict of DINOv2's keys (``register_tokens``, ``blocks.{i}.ls1.gamma``,
``blocks.{i}.mlp.w12.weight`` ...). Every product goes through
:mod:`.precision`, so that the same code is the float32 reference and, one
precision down, the control of the correctness check.

The model, as published:

* tokens: the stride-14 patch convolution, the CLS token in front, the
  positional table (37 x 37 + 1 for 518^2) added, interpolated to the
  patch grid by ``F.interpolate(mode="bicubic", antialias=True, size=...)``
  in float32 where the grid is not the table's; then the register tokens
  put in after CLS, without positional embedding: [cls, reg x R, patches];
* each block: x = x + ls1 * proj(attn(norm1(x))); x = x + ls2 * w3(silu(a)
  * b) with (a, b) the two halves of w12(norm2(x)); qkv and proj with
  biases, LayerNorm eps 1e-6;
* the last block's CLS row attends over all 1 + R + n keys; the map keeps
  the n patch columns.

Departures: none in the mathematics. ``mask_token`` (iBOT's masked-patch
token) is in the state dict and unused, as at DINOv2's inference. Attention
is materialized (softmax of the full score matrix) and tiles run in chunks so
that the score matrices fit.

The mosaic chain is the benchmark's reference of the paper's
``sw_processing.py`` (``reference/vit.py``: tiles, head mean, min-max, x255,
bilinear resize to the window, the ramp-blended stitch, the multiplicative
Otsu threshold), with this model's CLS attention in DINO's place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import linear, matmul, matmul_flags, round_operand, store
from .vit import stitch_rows, tile_starts

TILE_CHUNK = 8  # tiles per forward: (8, 24, 1301, 1301) f32 scores are 1.3 GB


def _p(state, name):
    return state[name].float()


def patch_embed(state, cfg, x, precision):
    """(B, H, W, 3) -> (B, gh*gw, D): the stride-p convolution."""
    w = round_operand(_p(state, "patch_embed.proj.weight"), precision)
    y = F.conv2d(round_operand(x.permute(0, 3, 1, 2), precision), w,
                 _p(state, "patch_embed.proj.bias"), stride=cfg["patch_size"])
    return store(y.flatten(2).transpose(1, 2), precision)


def pos_embed_for(state, gh, gw):
    """DINOv2's interpolate_pos_encoding with interpolate_antialias=True and
    interpolate_offset=0: the table as it is at its own grid, else its patch
    rows through antialiased bicubic to the grid's size."""
    pos = _p(state, "pos_embed")
    n = pos.shape[1] - 1
    g = int(math.sqrt(n))
    if gh == g and gw == g:
        return pos
    grid = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def prepare_tokens(state, cfg, x, precision):
    """[cls, registers, patches] with the positional embedding on CLS and
    the patches."""
    b, hgt, wdt, _ = x.shape
    p = cfg["patch_size"]
    tok = patch_embed(state, cfg, store(x, precision), precision)
    cls = _p(state, "cls_token").expand(b, 1, -1)
    tok = torch.cat([cls, tok], dim=1) + pos_embed_for(state, hgt // p, wdt // p)
    reg = _p(state, "register_tokens").expand(b, -1, -1)
    return store(torch.cat([tok[:, :1], reg, tok[:, 1:]], dim=1), precision)


def layer_norm(state, prefix, cfg, x, precision):
    return store(F.layer_norm(x, (x.shape[-1],), _p(state, prefix + ".weight"),
                              _p(state, prefix + ".bias"), cfg["ln_eps"]), precision)


def _heads(t, b, n, heads):
    return t.reshape(b, n, heads, -1).permute(0, 2, 1, 3)


def swiglu(state, pre, h, precision):
    """w3(silu(a) * b) with (a, b) = w12(h) split in two halves."""
    x12 = store(linear(h, _p(state, pre + ".mlp.w12.weight"), _p(state, pre + ".mlp.w12.bias"),
                       precision), precision)
    a, b = x12.chunk(2, dim=-1)
    g = store(F.silu(a) * b, precision)
    return linear(g, _p(state, pre + ".mlp.w3.weight"), _p(state, pre + ".mlp.w3.bias"),
                  precision)


def block(state, cfg, i, tok, precision):
    """x + ls1 * attn(norm1(x)); x + ls2 * ffn(norm2(x))."""
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
    y = linear(o, _p(state, pre + ".attn.proj.weight"), _p(state, pre + ".attn.proj.bias"),
               precision)
    tok = store(tok + _p(state, pre + ".ls1.gamma") * store(y, precision), precision)
    h = layer_norm(state, pre + ".norm2", cfg, tok, precision)
    y = store(swiglu(state, pre, h, precision), precision)
    return store(tok + _p(state, pre + ".ls2.gamma") * y, precision)


def forward_features(state, cfg, x, precision="float32"):
    """Every block and the final LayerNorm: (B, H, W, 3) in [0, 1] ->
    (B, 1 + R + n, D), DINOv2's x_norm over [cls, registers, patches]."""
    tok = prepare_tokens(state, cfg, x, precision)
    for i in range(cfg["depth"]):
        tok = block(state, cfg, i, tok, precision)
    return layer_norm(state, "norm", cfg, tok, precision)


def cls_attention(state, cfg, x, precision="float32"):
    """The last block's CLS attention over the patches: (B, H, W, 3) in
    [0, 1] -> (B, heads, gh, gw); the row's softmax runs over every key
    (CLS, registers, patches)."""
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
    first = 1 + cfg["num_register_tokens"]
    attn = store(torch.softmax(scores, dim=-1)[:, :, 0, first:], precision)
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


@torch.no_grad()
def canvas_rows(state, cfg, img_u8, window, stride, first_row, last_row, precision="float32"):
    """The attention canvas over the mosaic rows that tile rows
    [first_row, last_row] alone determine, as reference/vit.py's
    canvas_rows: (rows (y0, y1), (y1 - y0, W))."""
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

"""Peaks of the card and the operations and bytes the layers need.

The peaks and :func:`bound` are ``chip_smoke.py``'s (lines 210-211 and 433)
frozen here: NVIDIA's H100 SXM data sheet, dense rates, 700 W. The counts
are of what the outputs need, from shapes, whatever kernel does the work:

* attention over B sequences of N tokens, h heads of d: 4 B h N^2 d FLOPs
  forward (Q K^T and P V), 8 B h N^2 d backward (dV, dP, dQ and dK; the
  recomputation of P is not counted). Bytes: q, k, v and o once forward;
  q, k, v, o and do read and dq, dk, dv written backward;
* the MLP block over R rows, width D, hidden H: 4 R D H FLOPs forward,
  8 R D H backward. Bytes: x, both weights and the output once forward,
  plus the next block's normalized input z where the kernel emits it;
  backward x, dy and the weights read, dx and both weight gradients written;
* a ViT forward: the patch embedding, per block the qkv projection, the
  attention, the output projection and the MLP, and for the mosaic's last
  block only what the CLS row needs (k over every token, q of the CLS row
  and its scores: the row's probabilities are the output);
* SimMIM's step: three times the forward (forward, and the backward's two
  products per forward product) of the encoder and the 1x1 decoder.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them; HBM3.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound(flops: float, nbytes: float, precision: str):
    """(least time in s, what bounds it) for flops and bytes on the card."""
    t_ops, t_mem = flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def tokens(img: int, patch: int) -> int:
    return (img // patch) ** 2 + 1


def attention_fwd(b, heads, n, head_dim, itemsize):
    """(FLOPs, bytes) of one attention forward."""
    d = heads * head_dim
    return 4 * b * heads * n * n * head_dim, 4 * b * n * d * itemsize


def attention_bwd(b, heads, n, head_dim, itemsize):
    d = heads * head_dim
    return 8 * b * heads * n * n * head_dim, 8 * b * n * d * itemsize


def mlp_fwd(rows, d, hidden, itemsize, emits_z=False):
    return 4 * rows * d * hidden, (rows * d * (3 if emits_z else 2) + 2 * d * hidden) * itemsize


def mlp_bwd(rows, d, hidden, itemsize):
    return 8 * rows * d * hidden, (3 * rows * d + 4 * d * hidden) * itemsize


def vit_block_flops(b, n, d, heads, hidden):
    return (2 * b * n * d * 3 * d + attention_fwd(b, heads, n, d // heads, 1)[0]
            + 2 * b * n * d * d + mlp_fwd(b * n, d, hidden, 1)[0])


def patch_embed_flops(b, img, patch, d):
    return 2 * b * (img // patch) ** 2 * 3 * patch * patch * d


def serve_tile_flops(cfg: dict, window: int) -> float:
    """FLOPs of the CLS attention of one window tile: the patch embedding,
    depth - 1 whole blocks and the last block's CLS row."""
    d, p, heads = cfg["embed_dim"], cfg["patch_size"], cfg["num_heads"]
    n = tokens(window, p)
    last = 2 * n * d * d + 2 * d * d + 2 * n * d
    return (patch_embed_flops(1, window, p, d)
            + (cfg["depth"] - 1) * vit_block_flops(1, n, d, heads, d * cfg["mlp_ratio"]) + last)


def tiles_per_mosaic(size: int, window: int, stride: int) -> int:
    per_axis = 1 if size <= window else 1 + -(-(size - window) // stride)
    return per_axis * per_axis


def serve_mosaic_flops(cfg: dict, size: int, window: int, stride: int) -> float:
    return tiles_per_mosaic(size, window, stride) * serve_tile_flops(cfg, window)


def serve_attention(cfg: dict, size: int, window: int, stride: int, precision: str):
    """(FLOPs, bytes) of the attention kernels a mosaic needs: every block
    but the last, over every tile."""
    t = tiles_per_mosaic(size, window, stride)
    f, b = attention_fwd(t, cfg["num_heads"], tokens(window, cfg["patch_size"]),
                         cfg["embed_dim"] // cfg["num_heads"], ITEMSIZE[precision])
    return (cfg["depth"] - 1) * f, (cfg["depth"] - 1) * b


def serve_mlp(cfg: dict, size: int, window: int, stride: int, precision: str):
    """(FLOPs, bytes) of the MLP kernels a mosaic needs: every block but the
    last; all but the last of those emit the next block's z."""
    rows = tiles_per_mosaic(size, window, stride) * tokens(window, cfg["patch_size"])
    d, hidden, it = cfg["embed_dim"], cfg["embed_dim"] * cfg["mlp_ratio"], ITEMSIZE[precision]
    n = cfg["depth"] - 1
    f1, b1 = mlp_fwd(rows, d, hidden, it, emits_z=True)
    f0, b0 = mlp_fwd(rows, d, hidden, it)
    return (n - 1) * f1 + f0, (n - 1) * b1 + b0


def train_attention(cfg: dict, batch: int, img: int, precision: str):
    heads = cfg["num_heads"]
    args = (batch, heads, tokens(img, cfg["patch_size"]), cfg["embed_dim"] // heads,
            ITEMSIZE[precision])
    (ff, fb), (bf, bb) = attention_fwd(*args), attention_bwd(*args)
    return cfg["depth"] * (ff + bf), cfg["depth"] * (fb + bb)


def train_mlp(cfg: dict, batch: int, img: int, precision: str):
    rows = batch * tokens(img, cfg["patch_size"])
    d, hidden, it = cfg["embed_dim"], cfg["embed_dim"] * cfg["mlp_ratio"], ITEMSIZE[precision]
    (ff, fb), (bf, bb) = mlp_fwd(rows, d, hidden, it), mlp_bwd(rows, d, hidden, it)
    return cfg["depth"] * (ff + bf), cfg["depth"] * (fb + bb)


def train_step_flops(cfg: dict, batch: int, img: int) -> float:
    """Forward and backward FLOPs of one SimMIM step of ``batch`` images."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    n = tokens(img, p)
    fwd = (patch_embed_flops(batch, img, p, d)
           + cfg["depth"] * vit_block_flops(batch, n, d, cfg["num_heads"], d * cfg["mlp_ratio"])
           + 2 * batch * (n - 1) * d * p * p * 3)
    return 3 * fwd

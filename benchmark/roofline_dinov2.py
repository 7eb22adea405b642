"""The operations and bytes a DINOv2 mosaic needs, and the per-layer metrics
of its cell that read them (``metrics/<name>.g14.py``).

Counts from shapes, of what the outputs need, whatever kernel does the work;
the peaks and :func:`roofline.bound` are the benchmark's. A tile of the
window runs N = grid^2 + 1 + R tokens (CLS and R registers before the
patches) through:

* the patch embedding, 2 grid^2 (3 p^2) D FLOPs;
* depth - 1 whole blocks: qkv 2 N D 3D, attention 4 h N^2 d, proj 2 N D^2,
  the SwiGLU FFN 6 N D H (w12: 2 N D 2H; w3: 2 N H D);
* the last block's CLS row: k over every token 2 N D^2, q of CLS 2 D^2 and
  its scores 2 N D.

The kernels this configuration adds are bound by bytes: the gate
(``swiglu_gate_kernel``) reads 2H and writes H values a row, the LayerScale
residual (``layerscale_norm_kernel``) reads x and y and writes x' and z, 4 D
values a row (the D-sized gamma and LayerNorm vectors left out); each of the
depth - 1 whole blocks runs one gate and two residuals over every row.
"""

from __future__ import annotations

from benchmark import roofline
from benchmark.program_spans import device_ms
from benchmark.readers import ATTENTION

GATE = r"\bswiglu_gate_kernel\b"
LSNORM = r"\blayerscale_norm_kernel\b"
FFN_SPANS = frozenset({"vit.ffn"})


def tokens(cfg: dict, window: int) -> int:
    return (window // cfg["patch_size"]) ** 2 + 1 + cfg["num_register_tokens"]


def block_flops(cfg: dict, n: int) -> float:
    """FLOPs of one whole block over one tile of n tokens."""
    d, h, heads = cfg["embed_dim"], cfg["ffn_hidden"], cfg["num_heads"]
    return (2 * n * d * 3 * d + roofline.attention_fwd(1, heads, n, d // heads, 1)[0]
            + 2 * n * d * d + 6 * n * d * h)


def tile_flops(cfg: dict, window: int) -> float:
    """FLOPs of the CLS attention of one window tile."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    n = tokens(cfg, window)
    last = 2 * n * d * d + 2 * d * d + 2 * n * d
    return (roofline.patch_embed_flops(1, window, p, d) + (cfg["depth"] - 1) * block_flops(cfg, n)
            + last)


def mosaic_flops(cfg: dict, size: int, window: int, stride: int) -> float:
    return roofline.tiles_per_mosaic(size, window, stride) * tile_flops(cfg, window)


def _rows(cfg, size, window, stride):
    return roofline.tiles_per_mosaic(size, window, stride) * tokens(cfg, window)


def attention(cfg: dict, size: int, window: int, stride: int, precision: str):
    """(FLOPs, bytes) of the attention kernels a mosaic needs: every whole
    block, over every tile."""
    t = roofline.tiles_per_mosaic(size, window, stride)
    heads = cfg["num_heads"]
    f, b = roofline.attention_fwd(t, heads, tokens(cfg, window), cfg["embed_dim"] // heads,
                                  roofline.ITEMSIZE[precision])
    return (cfg["depth"] - 1) * f, (cfg["depth"] - 1) * b


def gate(cfg: dict, size: int, window: int, stride: int, precision: str):
    """(FLOPs, bytes) of the gate launches a mosaic needs: 3 H values a row
    a whole block; its arithmetic, a few operations a value on the CUDA
    cores, is left out (bytes bound it 30-fold)."""
    rows = _rows(cfg, size, window, stride)
    nbytes = 3 * rows * cfg["ffn_hidden"] * roofline.ITEMSIZE[precision]
    return 0.0, (cfg["depth"] - 1) * nbytes


def lsnorm(cfg: dict, size: int, window: int, stride: int, precision: str):
    """(FLOPs, bytes) of the LayerScale residual launches a mosaic needs: 4 D
    values a row, two launches a whole block."""
    rows = _rows(cfg, size, window, stride)
    nbytes = 4 * rows * cfg["embed_dim"] * roofline.ITEMSIZE[precision]
    return 0.0, 2 * (cfg["depth"] - 1) * nbytes


def mfu(view, cell):
    """The whole mosaic's share of the card's peak: :func:`mosaic_flops`
    times the mosaics the traced window completed, over the window and the
    peak of the cell's precision, in %."""
    mosaics = view.units.get("mosaics")
    if not mosaics or view.busy_s <= 0:
        return None
    t = cell.traffic
    flops = mosaic_flops(cell.config, t["size"], t["window"], t["stride"]) * mosaics
    return 100.0 * flops / view.window_s / roofline.PEAK_FLOPS[cell.precision]


def _roofline(view, cell, pattern, counts):
    mosaics = view.units.get("mosaics")
    dev = view.device_s(pattern)
    if not mosaics or dev <= 0:
        return None
    t = cell.traffic
    f, b = counts(cell.config, t["size"], t["window"], t["stride"], cell.precision)
    return 100.0 * roofline.bound(f * mosaics, b * mosaics, cell.precision)[0] / dev


def attn_roofline(view, cell):
    """The attention kernels' share of their roofline (kernels matching
    readers.ATTENTION), in %."""
    return _roofline(view, cell, ATTENTION, attention)


def gate_roofline(view, cell):
    """The SwiGLU gate kernel's share of its roofline (bytes), in %."""
    return _roofline(view, cell, GATE, gate)


def lsnorm_roofline(view, cell):
    """The LayerScale residual kernel's share of its roofline (bytes), in %."""
    return _roofline(view, cell, LSNORM, lsnorm)


def ffn_dev_ms_per_mp(view, cell):
    """Device milliseconds a traced megapixel launched under the program's
    ``vit.ffn`` spans: the w12 and w3 products, the gate and the FFN's
    LayerScale residual."""
    mp = view.units.get("mp")
    dev = device_ms(view, FFN_SPANS)
    if not mp or dev <= 0:
        return None
    return dev / mp

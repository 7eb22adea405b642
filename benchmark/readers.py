"""What the per-layer metrics read in a traced run's :class:`TraceView`.

Each per-layer metric is a file ``metrics/<name>.py`` whose ``read(view,
cell)`` is one of these functions: one quantity reported under a name a
group of cells (``mfu.serve`` for the fused cell, ``mfu.streamed``), since each group's metric
moves its own end-to-end metric. A reader that finds nothing to read returns
None and the metric is left out of the result line.
"""

from __future__ import annotations

from benchmark import roofline

# csrc/attention_qkv_wgmma.cu, attention_qkv.cu (the folded training forward
# too), attention_savep*.cu, attention_bwd*.cu
ATTENTION = r"\b(attention_(wgmma|f32)|attn_\w+)_kernel\b"
# csrc/fused_mlp_wgmma.cu, fused_mlp.cu and their backward files' kernels
MLP = r"\b(fused_mlp\w*|mlp_\w+|reduce_splits|reduce_rows)_kernel\b"


def device_idle(view, cell):
    """Share of the traced window in which no operation ran on the card:
    1 - (union of the device operations' intervals) / window, in %. Copies
    and kernels on two streams that overlap count once."""
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def serve_mfu(view, cell):
    """The whole mosaic's share of the card's peak: the FLOPs the masks need
    (roofline.serve_mosaic_flops: every tile's ViT up to the last block's
    CLS row) times the mosaics the traced window completed, over the window
    and the peak of the cell's precision, in %."""
    mosaics = view.units.get("mosaics")
    if not mosaics or view.busy_s <= 0:
        return None
    t = cell.traffic
    flops = roofline.serve_mosaic_flops(cell.config, t["size"], t["window"], t["stride"]) * mosaics
    return 100.0 * flops / view.window_s / roofline.PEAK_FLOPS[cell.precision]


def _share(least_s, dev_s):
    return 100.0 * least_s / dev_s


def serve_attn_roofline(view, cell):
    """The attention kernels' share of their roofline: max(FLOPs / peak,
    bytes / HBM bandwidth) of the attention every mosaic needs
    (roofline.serve_attention: 4 B h N^2 d, q k v o once) over the device
    time of the kernels matching ATTENTION, in %."""
    mosaics = view.units.get("mosaics")
    dev = view.device_s(ATTENTION)
    if not mosaics or dev <= 0:
        return None
    t = cell.traffic
    f, b = roofline.serve_attention(cell.config, t["size"], t["window"], t["stride"],
                                    cell.precision)
    return _share(roofline.bound(f * mosaics, b * mosaics, cell.precision)[0], dev)


def serve_mlp_roofline(view, cell):
    """The fused MLP kernels' share of their roofline: max(FLOPs / peak,
    bytes / HBM bandwidth) of the MLP blocks every mosaic needs
    (roofline.serve_mlp: 4 R D H; x, weights, out and z once) over the
    device time of the kernels matching MLP, in %."""
    mosaics = view.units.get("mosaics")
    dev = view.device_s(MLP)
    if not mosaics or dev <= 0:
        return None
    t = cell.traffic
    f, b = roofline.serve_mlp(cell.config, t["size"], t["window"], t["stride"], cell.precision)
    return _share(roofline.bound(f * mosaics, b * mosaics, cell.precision)[0], dev)


def post_dev_ms_per_mp(view, cell):
    """Device milliseconds a megapixel of the pipeline's work outside the
    ViT: tiles, resize, stitch, threshold and histogram (pipeline.py, ops/).
    Counted are the device operations launched under the benchmark's
    ``segment`` span but not inside its ``vit`` span around the port's
    ``cls_attention_grid``."""
    mp = view.units.get("mp")
    if not mp or view.device_s(span="vit") <= 0:
        return None
    return view.device_s(span="segment") * 1e3 / mp


def train_mfu(view, cell):
    """The whole step's share of the card's peak: forward and backward FLOPs
    of the SimMIM encoder and decoder (roofline.train_step_flops) times the
    steps the traced window completed, over the window and the peak of the
    cell's precision (bf16 for AMP, f32 without), in %."""
    steps = view.units.get("steps")
    if not steps or view.busy_s <= 0:
        return None
    t = cell.traffic
    flops = roofline.train_step_flops(cell.config, t["batch"], t["img_size"]) * steps
    return 100.0 * flops / view.window_s / roofline.PEAK_FLOPS[cell.precision]


def train_attn_roofline(view, cell):
    """The attention kernels' share of their roofline, forward and backward:
    max(FLOPs / peak, bytes / HBM bandwidth) of what the steps need
    (roofline.train_attention: 4 B h N^2 d forward + 8 backward, the
    recomputation not counted) over the device time of the kernels matching
    ATTENTION, in %."""
    steps = view.units.get("steps")
    dev = view.device_s(ATTENTION)
    if not steps or dev <= 0:
        return None
    t = cell.traffic
    f, b = roofline.train_attention(cell.config, t["batch"], t["img_size"], cell.precision)
    return _share(roofline.bound(f * steps, b * steps, cell.precision)[0], dev)


def train_mlp_roofline(view, cell):
    """The MLP kernels' share of their roofline, forward and backward:
    max(FLOPs / peak, bytes / HBM bandwidth) of what the steps need
    (roofline.train_mlp: 4 R D H forward + 8 backward) over the device time
    of the kernels matching MLP, in %."""
    steps = view.units.get("steps")
    dev = view.device_s(MLP)
    if not steps or dev <= 0:
        return None
    t = cell.traffic
    f, b = roofline.train_mlp(cell.config, t["batch"], t["img_size"], cell.precision)
    return _share(roofline.bound(f * steps, b * steps, cell.precision)[0], dev)


def loader_dev_ms(view, cell):
    """Device milliseconds a batch of the device-augmentation loader
    (data/device_aug.py): the device operations launched under the
    benchmark's ``loader`` span, per batch the traced window drew."""
    batches = view.units.get("batches")
    dev = view.device_s(span="loader")
    if not batches or dev <= 0:
        return None
    return dev * 1e3 / batches

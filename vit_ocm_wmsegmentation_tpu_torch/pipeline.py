"""Attention segmentation pipelines: image -> attention -> mask.

Counterpart of ``vit_ocm_wmsegmentation_tpu/pipeline.py``. The single-image
functions (:func:`attention_map_rgb`, :func:`attention_map_single`,
:func:`attention_heads`, :func:`segment_single`) are the eval path's crop 1
chain (eval.py:135-202): last-block CLS attention, head average, optional
median filter, bilinear smoothing, thresholds. The mosaic pipeline (the
reference's sw_processing.py rebuilt) is one batched tile
gather, the ViT over the tile batch, per-tile min-max normalization and
bilinear smoothing, the ramp-blended overlap-add stitch, and the
multiplicative Otsu threshold. Everything runs on the device of the input
tensors; nothing returns to the host between the gather and the mask.

With a ``mesh`` (parallel.mesh.make_mesh), the tiles of a mosaic, or of a
band, shard over the mesh's 'data' axis: each rank runs the ViT on its
share, padded with zero tiles to a multiple of the axis, and the per-tile
maps are all-gathered, so that every rank stitches and thresholds the same
maps and returns the same mask, as the JAX package's replicated output is.

Under a profiler a mosaic runs inside one top span,
``pipeline.segment_mosaic`` or ``pipeline.segment_mosaic_streamed``, that
holds host code alone; its work runs under the leaves ``pipeline.tiles``,
``pipeline.tile_maps`` (``vit.cls_attention_grid`` inside it),
``pipeline.stitch`` and ``pipeline.threshold``, the streamed path's
``pipeline.tile_maps`` and ``pipeline.stitch`` inside one ``pipeline.band``
a tile row (utils.profiling).
"""

from __future__ import annotations

import contextlib

import torch

from .models import vit
from .ops import stitch as st
from .ops import threshold as th
from .ops.filters import median_filter
from .ops.resize import resize_linear_cv2, smooth_attention, upsample_nearest
from .parallel.mesh import gather_rows, local_rows
from .utils.profiling import annotate

# tiles per ViT call: bounds the per-block (T, N, 3D) qkv temporaries for
# large mosaics; the 1152^2 mosaic's 49 tiles run as one batch
TILE_CHUNK = 256


@contextlib.contextmanager
def exact_matmuls():
    """Within the block, library matmuls accumulate as the JAX package's
    dots do: f32 inputs in full f32 (no TF32, which the bf16-vs-f32 mask gate
    would otherwise compare against), bf16 inputs with an f32 reduction (no
    reduced-precision split-K). torch's flags are process-wide, so the
    caller's settings are restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


def to_model_input(img_u8, dtype=torch.float32):
    """uint8 (..., H, W) grayscale -> (..., H, W, 3) in [0, 1]: PIL's
    convert('RGB') channel replication and ToTensor's /255."""
    x = (img_u8.float() / 255.0).to(dtype)
    return x[..., None].expand(x.shape + (3,))


def cast_params(model, dtype):
    """Cast the model's floating-point weights to a compute dtype (bf16)."""
    return model.to(dtype)


def head_average_attention(model, x, median_size=1, routes=vit.InferRoutes()):
    """(B, H, W, 3) -> (B, gh, gw): CLS attention grid averaged over heads
    in the compute dtype, with the optional median filter (eval.py:142-144),
    on the inference ``routes`` (models.vit.InferRoutes).

    The reference median-filters the nearest x patch upsampled map, and the
    /patch downsample after it samples 2 taps at block centres (eval.py:169).
    For size 1 that chain is the identity on the grid; for size > 1 it is
    replicated: the upsampled map filtered, then resampled back to the grid
    with the cv2 2-tap kernel."""
    avg = vit.cls_attention_grid(model, x, routes).mean(dim=1)
    if median_size > 1:
        gh, gw = avg.shape[-2:]
        up = median_filter(upsample_nearest(avg, model.cfg.patch_size), median_size)
        avg = resize_linear_cv2(up, (gh, gw))
    return avg


@torch.inference_mode()
def attention_map_rgb(model, x, median_size=1, routes=vit.InferRoutes()):
    """The eval path's crop 1 attention chain (eval.py:135-171) for float
    RGB input (B, H, W, 3) in [0, 1]: the smoothed attention map (B, H, W)
    in f32. The grids leave the ViT in f32 whatever its compute dtype, so
    smoothing and thresholds downstream are the same in bf16."""
    _, h, w, _ = x.shape
    with exact_matmuls():
        avg = head_average_attention(model, x, median_size, routes).float()
        return smooth_attention(avg, model.cfg.patch_size, (h, w))


def attention_map_single(model, img_u8, median_size=1, routes=vit.InferRoutes()):
    """:func:`attention_map_rgb` for a batch of grayscale uint8 images
    (B, H, W), fed to the ViT in float32."""
    return attention_map_rgb(model, to_model_input(img_u8), median_size, routes)


@torch.inference_mode()
def attention_heads(model, x, routes=vit.InferRoutes()):
    """Per-head CLS attention maps at image resolution, (B, h, H, W): the
    nearest x patch maps analyse_attention saves as attn-head{j}.png
    (compute_attention, utils.py:229-235)."""
    with exact_matmuls():
        grids = vit.cls_attention_grid(model, x, routes)
    return upsample_nearest(grids, model.cfg.patch_size)


@torch.inference_mode()
def segment_single(model, img_u8, method="ours", median_size=1, routes=vit.InferRoutes()):
    """The eval step of the thresholding methods for (B, H, W) uint8
    images: ((B, H, W) uint8 {0, 255} masks, (B, H, W) f32 attention)."""
    which = {"ours": 0, "otsu": 1, "heatmap_threshold": 2}[method]
    attn = attention_map_single(model, img_u8, median_size, routes)
    return th.threshold_ours(img_u8, attn)[which], attn


def validate_window_geometry(window: int, stride: int) -> None:
    """Reject window/stride pairs the blended stitch cannot represent."""
    if stride <= 0 or stride > window:
        raise ValueError(
            f"stride ({stride}) must be in [1, window ({window})]: "
            f"stride > window leaves gaps between tiles")
    if window % stride != 0:
        raise ValueError(
            f"window ({window}) must be a multiple of stride ({stride}) "
            f"for the blended overlap-add stitch (reference geometry)")


def pad_mosaic(img_u8, window, stride):
    """Edge-pad (H, W) up to window + k*stride on each axis. Returns
    (padded, (H, W))."""
    h, w = img_u8.shape

    def target(size):
        if size <= window:
            return window
        return window + -(-(size - window) // stride) * stride

    th_, tw_ = target(h), target(w)
    if (th_, tw_) == (h, w):
        return img_u8, (h, w)
    dev = img_u8.device
    rows = torch.clamp(torch.arange(th_, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(tw_, device=dev), max=w - 1)
    return img_u8[rows[:, None], cols[None, :]], (h, w)


def mosaic_tiles(img_u8, window, stride):
    """(H, W) uint8 -> (T, window, window) uint8 tile batch, row-major."""
    h, w = img_u8.shape
    return st.extract_tiles(img_u8, st.tile_starts(h, window, stride),
                            st.tile_starts(w, window, stride), window)


def _per_tile_attention(model, tiles_u8, window, median_size=1, dtype=torch.float32,
                        routes=vit.InferRoutes()):
    """Tile batch -> per-tile smoothed attention maps (sw_processing.py:
    235-258): head average, min-max per tile, *255, bilinear to the window."""
    avg = head_average_attention(model, to_model_input(tiles_u8, dtype), median_size,
                                 routes).float()
    g = th.min_max_normalize(avg, dims=(-2, -1)) * 255.0
    return resize_linear_cv2(g, (window, window))


def _tile_maps(model, tiles, window, median_size, dtype, routes, mesh):
    """:func:`_per_tile_attention` over a tile batch in TILE_CHUNK chunks;
    with a mesh, this rank's padded share of the tiles, the maps of every
    rank gathered after (module docstring)."""
    t = tiles.shape[0]
    if mesh is not None:
        tiles = local_rows(tiles, mesh, pad=True)
    maps = torch.cat([_per_tile_attention(model, tiles[i : i + TILE_CHUNK], window,
                                          median_size, dtype, routes)
                      for i in range(0, tiles.shape[0], TILE_CHUNK)])
    return maps if mesh is None else gather_rows(maps, mesh, t)


@torch.inference_mode()
def attention_mosaic(model, img_u8, window=384, stride=128, median_size=1,
                     dtype=torch.float32, routes=vit.InferRoutes(), mesh=None):
    """Full-mosaic attention map: (H, W) uint8 -> (H, W) float32, the ViT on
    the inference ``routes`` (models.vit.InferRoutes: --infer_mlp, --quant),
    the tiles sharded over ``mesh``'s 'data' axis when one is given."""
    validate_window_geometry(window, stride)
    with annotate("pipeline.tiles"):
        padded, (h, w) = pad_mosaic(img_u8, window, stride)
        tiles = mosaic_tiles(padded, window, stride)
    with exact_matmuls(), annotate("pipeline.tile_maps"):
        maps = _tile_maps(model, tiles, window, median_size, dtype, routes, mesh)
    with annotate("pipeline.stitch"):
        return st.stitch_blended(maps, window, stride, padded.shape)[:h, :w]


@torch.inference_mode()
def segment_mosaic(model, img_u8, window=384, stride=128, median_size=1,
                   dtype=torch.float32, exact_stitch=False, routes=vit.InferRoutes(), mesh=None):
    """Mosaic white-matter mask, the sw_processing.py end-to-end flow.

    Returns (mask uint8 {0,255}, attention (H, W) float32). By default the
    threshold reads the original mosaic; ``exact_stitch=True`` reads the
    reference's re-stitched uint8 image instead (ops.stitch.restitch_u8),
    bit-exactly as the reference computes it. ``routes`` selects the ViT's
    inference routes (models.vit.InferRoutes); ``mesh`` shards the tiles
    (module docstring)."""
    with annotate("pipeline.segment_mosaic"):
        attn = attention_mosaic(model, img_u8, window, stride, median_size, dtype, routes, mesh)
        with annotate("pipeline.threshold"):
            timg = img_u8
            if exact_stitch:
                padded, (h, w) = pad_mosaic(img_u8, window, stride)
                timg = st.restitch_u8(padded, window, stride)[:h, :w]
            mask, _, _ = th.threshold_multiplicative(timg, attn)
        return mask, attn


# ---------------------------------------------------------------------------
# Streamed gigapixel pipeline: one band of tile rows at a time
# ---------------------------------------------------------------------------

# sw_processing --streamed auto: mosaics above this many megapixels take
# segment_mosaic_streamed, the routing of the JAX package (pipeline.py:37)
STREAM_AUTO_MP = 22
# bands between two progress callbacks (segment_mosaic_streamed's band_chunk)
DEFAULT_BAND_CHUNK = 8


def _band_update_impl(model, img_dev, acc, y0, wy_row, wx, window, stride, median_size,
                      dtype, routes=vit.InferRoutes(), mesh=None):
    """Process the row of tiles starting at mosaic row y0 and add its
    weighted attention strip into the (H, W) f32 canvas ``acc`` in place
    (the torch counterpart of the JAX package's donated canvas).

    The tiles are views into the strip (the same pixels as extract_tiles);
    wy_row (window,) is this row's vertical blend profile and wx (J, window)
    the horizontal ones, both f32 on the device. As in the JAX package the
    maps are multiplied by wy_row first, then overlap-added with ones on y
    and wx on x. With a mesh the row's tiles shard over its 'data' axis."""
    with annotate("pipeline.tile_maps"):
        strip = img_dev[y0 : y0 + window]
        tiles = strip.unfold(1, window, stride).permute(1, 0, 2)  # (J, window, window)
        maps = _tile_maps(model, tiles, window, median_size, dtype, routes, mesh)
    with annotate("pipeline.stitch"):
        ones = torch.ones((1, window), dtype=torch.float32, device=acc.device)
        band = st.overlap_add(maps * wy_row[None, :, None], ones, wx, window, stride,
                              (window, acc.shape[1]))
        acc[y0 : y0 + window] += band


@torch.inference_mode()
def segment_mosaic_streamed(model, img_u8, window=384, stride=128, median_size=1,
                            dtype=torch.float32, exact_stitch=False, progress=None,
                            band_chunk=None, single_dispatch=False, mesh=None,
                            routes=vit.InferRoutes()):
    """segment_mosaic with memory bounded for gigapixel mosaics.

    segment_mosaic holds every tile's (window, window) attention map before
    stitching (38 GB in f32 at 32768^2). Here only the uint8 mosaic and one
    f32 attention canvas stay on the device; each tile row ("band") goes
    through the ViT by itself and adds its blended strip into the canvas,
    band after band in row order; the threshold then runs over the canvas
    in row chunks, its histogram from :func:`ops.threshold.histogram_u8_kernel`.

    ``img_u8`` (H, W) uint8 may be a numpy array, a CPU tensor or a device
    tensor; it is uploaded once to the device of the model's parameters
    (a CPU model runs everything on the CPU). ``band_chunk`` bands
    (None = DEFAULT_BAND_CHUNK) pass between two ``progress(done, total)``
    calls; canvas and mask do not depend on it. The attention agrees with
    segment_mosaic's to float tolerance (the canvas sums band by band where
    the fused stitch sums shifted blocks). ``mesh`` shards each band's row of
    tiles over its 'data' axis; the uint8 mosaic and the f32 canvas stay
    whole on every rank (module docstring). ``single_dispatch`` is the JAX
    package's one-dispatch TPU sweep and raises. ``routes`` selects the ViT's
    inference routes (models.vit.InferRoutes). Returns (mask (H, W) uint8
    {0,255}, attention (H, W) float32)."""
    if single_dispatch:
        raise NotImplementedError("single_dispatch is not ported yet")
    if band_chunk is None:
        band_chunk = DEFAULT_BAND_CHUNK
    if band_chunk < 1:
        raise ValueError(f"band_chunk must be >= 1, got {band_chunk}")
    validate_window_geometry(window, stride)
    with annotate("pipeline.segment_mosaic_streamed"):
        with annotate("pipeline.tiles"):
            dev = next(model.parameters()).device
            img = torch.as_tensor(img_u8).to(dev)
            padded, (h, w) = pad_mosaic(img, window, stride)
            ys = st.tile_starts(padded.shape[0], window, stride)
            # the blend profiles go to the device once, not once a band
            wy = torch.as_tensor(st.blend_profiles_1d(len(ys), window, stride),
                                 dtype=torch.float32, device=dev)
            wx = torch.as_tensor(
                st.blend_profiles_1d(len(st.tile_starts(padded.shape[1], window, stride)),
                                     window, stride), dtype=torch.float32, device=dev)
            acc = torch.zeros(padded.shape, dtype=torch.float32, device=dev)
            wy_rows = wy.unbind(0)
        with exact_matmuls():
            for r, y0 in enumerate(ys):
                with annotate("pipeline.band"):
                    _band_update_impl(model, padded, acc, int(y0), wy_rows[r], wx, window,
                                      stride, median_size, dtype, routes, mesh)
                if progress is not None and ((r + 1) % band_chunk == 0 or r + 1 == len(ys)):
                    progress(r + 1, len(ys))
        with annotate("pipeline.threshold"):
            attn = acc[:h, :w]
            timg = img if not exact_stitch else st.restitch_u8(padded, window, stride)[:h, :w]
            return _threshold_mult_streamed(timg, attn), attn


def _blend_u8(timg, attn):
    """The uint8 blend image threshold_multiplicative thresholds,
    uint8(timg * min_max_normalize(attn) / max), over row chunks so that the
    normalized attention is never materialised; bit-equal to it: the same
    (attn - lo) / (hi - lo) division (a reciprocal multiply differs by ulps,
    enough to flip a uint8 truncation), then the image product, then the
    division by max(attn), which is exactly 1 after the min-max, or
    max(hi, eps) for a constant canvas, which passes unchanged as
    min_max_normalize passes it."""
    lo, hi = attn.min(), attn.max()
    const = hi == lo
    rng = torch.where(const, torch.ones_like(hi), hi - lo)
    shift = torch.where(const, torch.zeros_like(lo), lo)
    denom2 = torch.where(const, torch.clamp_min(hi, th._FLT_EPSILON), torch.ones_like(hi))
    return th.map_rows(
        lambda img, a: (img.float() * ((a - shift) / rng) / denom2).to(torch.uint8), timg, attn)


def _threshold_mult_streamed(timg, attn):
    """threshold_multiplicative(timg, attn)[0] with bounded memory: the
    blend image from :func:`_blend_u8`, its histogram from
    histogram_u8_kernel, and no heatmap or image mask. Bit-equal."""
    result = _blend_u8(timg, attn)
    return th.binary_above(result, th.otsu_from_hist(th.histogram_u8_kernel(result)))

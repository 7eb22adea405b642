"""A gigapixel mosaic through the streamed path, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_gigapixel \\
        [--size 32768] [--band_chunk 1 8] [--repeats 2]

The port's counterpart of ``tools/bench_gigapixel.py``: ViT-S/8 in bf16 at
full width with random weights from seed 0, window 384, stride 128, on a
synthetic OCM-like mosaic (:func:`make_mosaic`). Prints the card's name and
power limit, the upload time, then for each ``--band_chunk`` K one JSON
line: segment seconds (the least of ``--repeats`` runs, host clock ending in
a synchronize), MP/s, ms/tile, peak device memory
(``torch.cuda.max_memory_allocated``) and a positional digest of the mask,
which must be equal for every K. Then where the time goes, with CUDA events:
the stages of ``--split_bands`` bands (tile input, ViT, normalize and
resize, blend and canvas add) and of the threshold over the whole canvas,
with the histogram kernel (once in the split, then the median of 10 calls)
beside its plain twin and ``torch.bincount`` on the threshold's own uint8
image, with the share of it in bin 0.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import pipeline as pl
from .ops import stitch as st
from .ops import threshold as th
from .ops.resize import resize_linear_cv2
from .sw_processing import load_model

WINDOW, STRIDE = 384, 128


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


def mask_digest(mask, rows_per_chunk: int = 512) -> str:
    """Positional checksum of (mask > 0) that changes if any pixel flips:
    tools/bench_gigapixel.py's uint32 arithmetic (1-based row and column
    weights, wrapping sums), in int64 reduced mod 2^32, over row chunks."""
    h, w = mask.shape
    dev = mask.device
    m32 = 1 << 32
    rw = ((torch.arange(h, device=dev, dtype=torch.int64) + 1) * 2654435761) % (1 << 24)
    cw = ((torch.arange(w, device=dev, dtype=torch.int64) + 1) * 40503) % (1 << 24)
    rows = torch.empty(h, dtype=torch.int64, device=dev)
    for r0 in range(0, h, rows_per_chunk):
        bits = (mask[r0 : r0 + rows_per_chunk] > 0).to(torch.int64)
        rows[r0 : r0 + rows_per_chunk] = (bits * cw).sum(1) % m32
    d1 = int(((rows * rw) % m32).sum()) % m32 % (1 << 31)
    d2 = int(rows.sum()) % m32 % (1 << 31)
    return f"{d1:08x}-{d2:08x}"


def _events(n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def band_split(model, img, dtype, bands):
    """Mean CUDA-event ms of each stage of a band, over ``bands`` bands."""
    names = ["tile input", "ViT", "normalize+resize", "blend+canvas add"]
    h, w = img.shape
    ys = st.tile_starts(h, WINDOW, STRIDE)
    wy = torch.as_tensor(st.blend_profiles_1d(len(ys), WINDOW, STRIDE), dtype=torch.float32,
                         device=img.device)
    wx = torch.as_tensor(st.blend_profiles_1d(len(st.tile_starts(w, WINDOW, STRIDE)), WINDOW,
                                              STRIDE), dtype=torch.float32, device=img.device)
    ones = torch.ones((1, WINDOW), dtype=torch.float32, device=img.device)
    strip_acc = torch.zeros((WINDOW, w), dtype=torch.float32, device=img.device)
    totals = dict.fromkeys(names, 0.0)
    rows = [int(r) for r in np.linspace(0, len(ys) - 1, bands).round()]
    with torch.inference_mode(), pl.exact_matmuls():
        for r in rows:
            ev = _events(len(names) + 1)
            ev[0].record()
            tiles = img[ys[r] : ys[r] + WINDOW].unfold(1, WINDOW, STRIDE).permute(1, 0, 2)
            x = pl.to_model_input(tiles, dtype).contiguous()
            ev[1].record()
            g = pl.head_average_attention(model, x).float()
            ev[2].record()
            maps = resize_linear_cv2(th.min_max_normalize(g, dims=(-2, -1)) * 255.0,
                                     (WINDOW, WINDOW))
            ev[3].record()
            strip_acc += st.overlap_add(maps * wy[r][None, :, None], ones, wx, WINDOW, STRIDE,
                                        (WINDOW, w))
            ev[4].record()
            torch.cuda.synchronize()
            for i, n in enumerate(names):
                totals[n] += ev[i].elapsed_time(ev[i + 1]) / len(rows)
    return totals


def threshold_split(timg, attn):
    """CUDA-event ms of the streamed threshold's stages over the whole canvas,
    and of the histogram kernel, its twin and torch.bincount on its image."""
    ev = _events(4)
    with torch.inference_mode():
        ev[0].record()
        result = pl._blend_u8(timg, attn)
        ev[1].record()
        hist = th.histogram_u8_kernel(result)
        ev[2].record()
        th.binary_above(result, th.otsu_from_hist(hist))
        ev[3].record()
        torch.cuda.synchronize()
        split = {"blend image": ev[0].elapsed_time(ev[1]),
                 "histogram kernel": ev[1].elapsed_time(ev[2]),
                 "otsu+mask": ev[2].elapsed_time(ev[3])}
        for name, fn in (("histogram twin", lambda: th.histogram_u8_chunked(result)),
                         ("torch.bincount", lambda: torch.bincount(result.reshape(-1),
                                                                   minlength=256))):
            fn()
            e = _events(2)
            e[0].record()
            fn()
            e[1].record()
            torch.cuda.synchronize()
            split[name] = e[0].elapsed_time(e[1])
        times = []  # the kernel again, warm: the median of 10 calls
        for _ in range(10):
            e = _events(2)
            e[0].record()
            th.histogram_u8_kernel(result)
            e[1].record()
            e[1].synchronize()
            times.append(e[0].elapsed_time(e[1]))
        split["histogram kernel, median of 10"] = float(np.median(times))
        bin0 = float(hist[0]) / result.numel()
    return split, bin0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=32768)
    ap.add_argument("--band_chunk", type=int, nargs="+", default=[1],
                    help="bands between progress reports; several values sweep K over the "
                         "same uploaded mosaic and require equal mask digests")
    ap.add_argument("--repeats", type=int, default=1,
                    help="segmentations per K; segment_s is the least")
    ap.add_argument("--split_bands", type=int, default=4,
                    help="bands in the per-stage CUDA-event split (0 = no split)")
    ap.add_argument("--no_progress", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gigapixel: no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    size = args.size
    model = pl.cast_params(load_model("vit_small", 8, seed=0, device=dev), torch.bfloat16)

    t0 = time.perf_counter()
    host = make_mosaic(size)
    print(f"synthesized {size}x{size} ({size * size / 1e9:.3f} GP) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    print(f"upload: {t_up:.3f} s ({host.nbytes / 1e9 / t_up:.2f} GB/s, pageable host memory)",
          flush=True)
    del host

    last = [time.perf_counter()]

    def progress(done, total):
        if done % 16 == 0 or done == total:
            now = time.perf_counter()
            print(f"  band {done}/{total} (+{now - last[0]:.2f} s, host clock)", flush=True)
            last[0] = now

    mp = size * size / 1e6
    per_axis = 1 if size <= WINDOW else 1 + -(-(size - WINDOW) // STRIDE)
    n_tiles = per_axis ** 2
    digests = {}
    mask = attn = None
    for bc in args.band_chunk:
        t_seg, t_first = float("inf"), None
        for _ in range(max(args.repeats, 1)):
            mask = attn = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            last[0] = t0 = time.perf_counter()
            mask, attn = pl.segment_mosaic_streamed(
                model, img, WINDOW, STRIDE, dtype=torch.bfloat16, band_chunk=bc,
                progress=None if args.no_progress else progress)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t_first = dt if t_first is None else t_first
            t_seg = min(t_seg, dt)
        peak = torch.cuda.max_memory_allocated()
        digests[bc] = mask_digest(mask)
        fg = float((mask > 0).sum()) / mask.numel()
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "mosaic": f"{size}x{size}",
            "gigapixels": size * size / 1e9, "tiles": n_tiles, "band_chunk": bc,
            "upload_s": t_up, "segment_s": t_seg, "first_run_s": t_first,
            "mp_per_s": mp / t_seg, "mp_per_s_with_upload": mp / (t_up + t_seg),
            "ms_per_tile": t_seg * 1e3 / n_tiles,
            "peak_gib": peak / 2**30, "mask_fg_fraction": fg, "mask_digest": digests[bc]}),
            flush=True)
    ok = len(set(digests.values())) == 1
    if len(digests) > 1:
        print(json.dumps({"band_chunk_bit_equal": ok, "digests": digests}), flush=True)

    split, bin0 = threshold_split(img, attn)
    print(f"threshold over the {size}^2 canvas (CUDA events, ms; bin 0 holds {bin0:.4f} of the "
          "blend image): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    mask = attn = None
    torch.cuda.empty_cache()
    if args.split_bands:
        bands = band_split(model, pl.pad_mosaic(img, WINDOW, STRIDE)[0], torch.bfloat16,
                           args.split_bands)
        print(f"one band of {per_axis} tiles, mean of {args.split_bands} bands "
              "(CUDA events, ms): " + ", ".join(f"{k} {v:.3f}" for k, v in bands.items()),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

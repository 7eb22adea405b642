"""Where one batch of the labeled eval path's time goes, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_eval [--batch 8] [--method ours]

The workload is chip_smoke.py's phase 10: ViT-S/8 at full width with random
weights from seed 0, on 384^2 pieces of the synthetic OCM mosaic of
profile_gigapixel.make_mosaic (:func:`eval_pieces`, labels from the rule
that placed its bright blobs). Prints the card's name and power limit, then
for bf16 and f32: the device time of each kernel in one torch.profiler run
of ``evaluation._batched_eval_step`` (ViT, smoothing, the method, the
metrics), that run's wall time and idle share, and a stage split timed with
CUDA events without the profiler (attention map, method, scores).
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import evaluation as ev
from . import pipeline as pl
from .models import vit
from .profile_gigapixel import make_mosaic
from .profile_mosaic import kernel_table
from .sw_processing import load_model

SIZE = 384
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def eval_pieces(n: int, size: int = SIZE, seed: int = 0):
    """n (size, size) uint8 pieces of make_mosaic(8192), each across a
    corner of its 2048-pixel grid of bright blobs, and their uint8 {0, 255}
    labels from the rule that placed the blobs (a bright cell is
    foreground). Returns (pieces (n, size, size), labels (n, size, size))."""
    big = make_mosaic(8192)
    rng = np.random.default_rng(seed)
    pieces, labels = [], []
    for _ in range(n):
        y0, x0 = 2048 * rng.integers(1, 4, 2) - rng.integers(84, 300, 2)
        yy, xx = np.mgrid[y0 : y0 + size, x0 : x0 + size]
        labels.append(((yy // 2048 + xx // 2048) % 3 == 0).astype(np.uint8) * 255)
        pieces.append(big[y0 : y0 + size, x0 : x0 + size])
    return np.stack(pieces), np.stack(labels)


def stage_split(model, grays, targets, method, dtype):
    """CUDA-event times (ms) of the batched step's stages."""
    names = ["attention map", "method", "scores"]
    ev_ = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with torch.inference_mode(), pl.exact_matmuls():
        ev_[0].record()
        attn = pl.attention_map_rgb(model, pl.to_model_input(grays, dtype))
        ev_[1].record()
        if method in ev.THRESHOLD_METHODS:  # as evaluation._batched_eval_step runs them
            masks = ev.apply_method(grays, attn, method)
        else:
            masks = torch.stack([ev.apply_method(g, a, method) for g, a in zip(grays, attn)])
        ev_[2].record()
        torch.vmap(ev.score_pair)(masks, targets)
        ev_[3].record()
    torch.cuda.synchronize()
    return {n: ev_[i].elapsed_time(ev_[i + 1]) for i, n in enumerate(names)}


def profile_step(model, grays, targets, method, dtype):
    def step():
        with torch.inference_mode(), pl.exact_matmuls():
            return ev._batched_eval_step(model, grays, targets, method, 1, dtype,
                                         vit.InferRoutes())

    for _ in range(2):  # warm-up: allocator, cuBLAS handles, the blend table
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_table(prof, wall)
    split = stage_split(model, grays, targets, method, dtype)
    print("  stages (CUDA events, no profiler): "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in split.items()))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--method", default="ours", choices=list(ev.BATCHED_METHODS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    pieces, labels = eval_pieces(args.batch)
    grays = torch.from_numpy(pieces).to(dev)
    targets = torch.from_numpy(labels).to(dev).float() / 255.0
    m32 = load_model("vit_small", 8, seed=0, device=dev)
    for tag, dtype in DTYPES.items():
        print(f"[{tag}] batched eval step, {args.method}, {args.batch} x {SIZE}^2, ViT-S/8, "
              f"weight seed 0")
        profile_step(pl.cast_params(copy.deepcopy(m32), dtype), grays, targets, args.method,
                     dtype)


if __name__ == "__main__":
    main()

"""Where one batch of the labeled eval path's time goes, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_eval [--batch 8] [--method ours]

The workload is chip_smoke.py's phase 10: ViT-S/8 at full width with random
weights from seed 0, on 384^2 pieces of the synthetic OCM mosaic
(``data.synthetic.eval_pieces``, labels from the rule that placed its
bright blobs). Prints the card's name and power limit, then
for bf16 and f32: the device time of each kernel in one torch.profiler run
of ``evaluation._batched_eval_step`` (ViT, smoothing, the method, the
metrics), that run's wall time and idle share, and a stage split timed with
CUDA events without the profiler (attention map, method, scores).
"""

from __future__ import annotations

import argparse
import copy
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import evaluation as ev
from . import pipeline as pl
from .data.synthetic import eval_pieces
from .models import vit
from .sw_processing import load_model
from .utils.profiling import card_line, kernel_table

SIZE = 384
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


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
    print(card_line())
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

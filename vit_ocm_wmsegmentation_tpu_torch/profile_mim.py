"""Where one MIM train step's time goes, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_mim

The workload is chip_smoke.py's phase 4: the SimMIM ViT (width 384, depth
4, 3 heads of 128, patch 8) with random weights from seed 0, 16 synthetic
384^2 images and their masks from ``np.random.default_rng(0)``, AdamW with
the default config. Prints the card's name and power limit, then for f32
and AMP bf16, after two warm-up steps: the device time of each kernel in
one torch.profiler run of a step, that step's wall time and idle share
(1 - kernel time / wall), and the step time without the profiler (CUDA
events, median of 10).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data.mask_generator import MaskGenerator
from .models import simmim
from .pipeline import exact_matmuls
from .profile_mosaic import kernel_table
from .train.mim_trainer import make_train_step
from .train.optim import Optimizer
from .train.schedule import build_schedule
from .utils.config import default_config

BATCH, SIZE = 16, 384


def step_ms(step, x, mask, iters=10):
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(x, mask)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_mim: no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)).to(dev)
    masks = MaskGenerator(SIZE, 16, 8, 0.5)
    mask = torch.from_numpy(np.stack([masks(rng) for _ in range(BATCH)])).to(dev)
    for tag, amp in (("f32", False), ("bf16", True)):
        cfg = default_config()
        cfg.DATA.IMG_SIZE = SIZE
        model = simmim.init(simmim.mim_vit_config(SIZE, 8), torch.Generator().manual_seed(0), dev)
        step = make_train_step(model, Optimizer(cfg, model, build_schedule(cfg, 1)), amp=amp)
        with exact_matmuls():
            for _ in range(2):
                step(x, mask)
            torch.cuda.synchronize()
            print(f"[{tag}] MIM train step, {BATCH} x {SIZE}^2, width 384, depth 4")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(x, mask)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kernel_table(prof, wall, top=20)
            print(f"  step without the profiler (CUDA events, median of 10): "
                  f"{step_ms(step, x, mask):.3f} ms")
        del model, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

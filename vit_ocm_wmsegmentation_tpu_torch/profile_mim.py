"""Where one MIM train step's time goes, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_mim [--route default ln_qkv ...]

The workload is chip_smoke.py's phases 4 and 4b: the SimMIM ViT (width 384,
depth 4, 3 heads of 128, patch 8) with random weights from seed 0, 16
synthetic 384^2 images and their masks from ``np.random.default_rng(0)``,
AdamW with the default config, on each kernel route asked for (default:
the default route; ``ln_qkv``, ``save_p``, ``gp`` and ``all`` are
TRAIN.LN_QKV kernel, TRAIN.ATTN_SAVE_P on, TRAIN.MLP_REMAT kernel+gp and
all three). Prints the card's name and power limit, then for each route,
f32 and AMP bf16, after two warm-up steps: the device time of each kernel in
one torch.profiler run of a step, that step's wall time and idle share
(1 - kernel time / wall), and the step time without the profiler (CUDA
events, median of 10) with its peak device memory.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data.mask_generator import MaskGenerator
from .models import simmim
from .models.vit import TrainRoutes
from .ops import flash_attention as fa
from .ops import fused_mlp as fm
from .ops import ln_linear as ln
from .pipeline import exact_matmuls
from .profile_mosaic import kernel_table
from .train.mim_trainer import make_train_step
from .train.optim import Optimizer
from .train.schedule import build_schedule
from .utils.config import default_config

BATCH, SIZE = 16, 384
ROUTES = {"default": TrainRoutes(), "ln_qkv": TrainRoutes(ln_qkv=True),
          "save_p": TrainRoutes(attn_save_p=True), "gp": TrainRoutes(mlp_save_gp=True),
          "all": TrainRoutes(mlp_save_gp=True, ln_qkv=True, attn_save_p=True)}


@contextlib.contextmanager
def plain_training_route():
    """Every training kernel wrapper swapped for its plain twin (the
    autograd Functions look the wrappers up at call time)."""
    twins = {(fa, "flash_attention"): fa.flash_attention_plain,
             (fa, "flash_attention_bwd"): fa.flash_attention_bwd_plain,
             (fa, "flash_attention_savep"): fa.flash_attention_savep_plain,
             (fa, "flash_attention_bwd_savep"): fa.flash_attention_bwd_savep_plain,
             (fm, "fused_mlp_block_h1"): lambda *a: fm.fused_mlp_block_plain(*a, want_h1=True),
             (fm, "fused_mlp_bwd"): fm.fused_mlp_bwd_plain,
             (fm, "fused_mlp_block_gp"): fm.fused_mlp_block_gp_plain,
             (fm, "fused_mlp_bwd_gp"): fm.fused_mlp_bwd_gp_plain,
             (ln, "ln_linear"): ln.ln_linear_plain,
             (ln, "ln_linear_bwd"): ln.ln_linear_bwd_plain}
    with contextlib.ExitStack() as stack:
        for (mod, name), twin in twins.items():
            stack.enter_context(mock.patch.object(mod, name, twin))
        yield


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", nargs="+", choices=sorted(ROUTES), default=["default"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mim: no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)).to(dev)
    masks = MaskGenerator(SIZE, 16, 8, 0.5)
    mask = torch.from_numpy(np.stack([masks(rng) for _ in range(BATCH)])).to(dev)
    for route, tag, amp in ((r, t, a) for r in args.route for t, a in (("f32", False),
                                                                          ("bf16", True))):
        cfg = default_config()
        cfg.DATA.IMG_SIZE = SIZE
        model = simmim.init(simmim.mim_vit_config(SIZE, 8), torch.Generator().manual_seed(0), dev)
        step = make_train_step(model, Optimizer(cfg, model, build_schedule(cfg, 1)), amp=amp,
                               routes=ROUTES[route])
        with exact_matmuls():
            for _ in range(2):
                step(x, mask)
            torch.cuda.synchronize()
            print(f"[{tag}] MIM train step, {BATCH} x {SIZE}^2, width 384, depth 4, "
                  f"route {route}")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(x, mask)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kernel_table(prof, wall, top=20)
            torch.cuda.reset_peak_memory_stats()
            ms = step_ms(step, x, mask)
            print(f"  step without the profiler (CUDA events, median of 10): {ms:.3f} ms, "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        del model, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

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
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .data.synthetic import MIM_BATCH, MIM_SIZE, mim_batch
from .models import simmim
from .ops.twins import TRAIN_ROUTES
from .pipeline import exact_matmuls
from .train.mim_trainer import make_train_step
from .train.optim import Optimizer
from .train.schedule import build_schedule
from .utils.config import default_config
from .utils.profiling import card_line, cuda_ms, kernel_table


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", nargs="+", choices=sorted(TRAIN_ROUTES),
                        default=["default"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mim: no CUDA device available")
    print(card_line())
    dev = torch.device("cuda")
    x, mask = mim_batch(dev)
    for route, tag, amp in ((r, t, a) for r in args.route for t, a in (("f32", False),
                                                                          ("bf16", True))):
        cfg = default_config()
        cfg.DATA.IMG_SIZE = MIM_SIZE
        model = simmim.init(simmim.mim_vit_config(MIM_SIZE, 8), torch.Generator().manual_seed(0),
                            dev)
        step = make_train_step(model, Optimizer(cfg, model, build_schedule(cfg, 1)), amp=amp,
                               routes=TRAIN_ROUTES[route])
        with exact_matmuls():
            for _ in range(2):
                step(x, mask)
            torch.cuda.synchronize()
            print(f"[{tag}] MIM train step, {MIM_BATCH} x {MIM_SIZE}^2, width 384, depth 4, "
                  f"route {route}")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(x, mask)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kernel_table(prof, wall, top=20)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(x, mask), iters=10, warmup=0)
            print(f"  step without the profiler (CUDA events, median of 10): {ms:.3f} ms, "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        del model, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

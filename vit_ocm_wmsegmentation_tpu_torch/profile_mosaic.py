"""Where one mosaic's time goes, and how the bf16 mask gates read across
weight seeds, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_mosaic [--seeds 0 1 2 3]

The workload is chip_smoke.py's: ViT-S/8 at full width with random weights,
on a 1152^2 uint8 mosaic from ``np.random.default_rng(0)``, window 384,
stride 128. Prints the card's name and power limit, then:

* for bf16 and f32 (weight seed 0): the device time of each kernel in one
  torch.profiler run of ``segment_mosaic``, that run's wall time and idle
  share (1 - kernel time / wall), and a stage split timed with CUDA events
  without the profiler;
* for each weight seed: chip_smoke.py's two bf16 mask gates (Dice of the
  bf16 mask against the f32 mask, and of the kernel route against the plain
  route in bf16), with the last block's CLS row rounded to the compute dtype
  as the JAX package rounds it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import subprocess
import time
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import pipeline as pl
from .ops import flash_attention as fa
from .ops import fused_mlp as fm
from .ops import quant as qz
from .ops import stitch as st
from .ops import threshold as th
from .ops.resize import resize_linear_cv2
from .sw_processing import load_model

SIZE, WINDOW, STRIDE = 1152, 384, 128
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def dice(a, b):
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    return 2.0 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1)


@contextlib.contextmanager
def plain_route():
    """Every kernel wrapper of the mosaic path (the int8 route's GEMM too)
    swapped for its plain twin."""
    with contextlib.ExitStack() as stack:
        for mod, name in ((fa, "attention_qkv"), (fm, "fused_mlp_block"),
                          (fm, "fused_mlp_block_lnout"), (qz, "int8_dot")):
            stack.enter_context(mock.patch.object(mod, name, getattr(mod, name + "_plain")))
        yield


def stage_split(model, img, dtype):
    """CUDA-event times (ms) of the pipeline's stages, one mosaic."""
    names = ["gather+input", "ViT", "normalize+resize", "stitch", "threshold"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with torch.inference_mode(), pl.exact_matmuls():
        ev[0].record()
        padded, (h, w) = pl.pad_mosaic(img, WINDOW, STRIDE)
        x = pl.to_model_input(pl.mosaic_tiles(padded, WINDOW, STRIDE), dtype)
        ev[1].record()
        g = pl.head_average_attention(model, x).float()
        ev[2].record()
        g = resize_linear_cv2(th.min_max_normalize(g, dims=(-2, -1)) * 255.0, (WINDOW, WINDOW))
        ev[3].record()
        attn = st.stitch_blended(g, WINDOW, STRIDE, padded.shape)[:h, :w]
        ev[4].record()
        th.threshold_multiplicative(img, attn)
        ev[5].record()
    torch.cuda.synchronize()
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def kernel_table(prof, wall, top=16):
    """Print the device time of each kernel in a torch.profiler run of
    ``wall`` ms, its idle share and the ``top`` kernels."""
    # kernels only: CPU ranges (aten ops, autograd Functions) and their GPU
    # annotations (the optimizer step) carry their kernels' time too
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if "vitocm::" in r[2])
    print(f"  wall {wall:.3f} ms under the profiler, device kernel time {busy:.3f} ms "
          f"({ours:.3f} ms in the port's kernels), idle share {1 - busy / wall:.4f}, "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in rows[:top]:
        print(f"    {ms:9.3f} ms x{count:4d}  {key[:100]}")


def profile_mosaic(model, img, dtype):
    for _ in range(2):  # warm-up: allocator, cuBLAS handles
        pl.segment_mosaic(model, img, WINDOW, STRIDE, dtype=dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pl.segment_mosaic(model, img, WINDOW, STRIDE, dtype=dtype)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_table(prof, wall)
    split = stage_split(model, img, dtype)
    print("  stages (CUDA events, no profiler): "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in split.items()))


def gates(seeds, img, dev):
    for seed in seeds:
        m32 = load_model("vit_small", 8, seed=seed, device=dev)
        m16 = pl.cast_params(copy.deepcopy(m32), torch.bfloat16)
        run = lambda m, dt: pl.segment_mosaic(m, img, WINDOW, STRIDE, dtype=dt)[0].cpu().numpy()  # noqa: E731
        k32 = run(m32, torch.float32)
        k16 = run(m16, torch.bfloat16)
        with plain_route():
            p16 = run(m16, torch.bfloat16)
        print(f"  weight seed {seed}: bf16 vs f32 {dice(k16, k32):.5f}, "
              f"kernel vs plain bf16 {dice(k16, p16):.5f}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3],
                        help="weight seeds of the gate sweep")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mosaic: no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((SIZE, SIZE)) * 255).astype(np.uint8)).to(dev)
    m32 = load_model("vit_small", 8, seed=0, device=dev)
    for tag, dtype in DTYPES.items():
        print(f"[{tag}] segment_mosaic, {SIZE}^2 mosaic, ViT-S/8, weight seed 0")
        profile_mosaic(pl.cast_params(copy.deepcopy(m32), dtype), img, dtype)
    print("bf16 mask gates (chip_smoke.py: bf16 vs f32 > 0.99, kernel vs plain >= 0.99)")
    gates(args.seeds, img, dev)


if __name__ == "__main__":
    main()

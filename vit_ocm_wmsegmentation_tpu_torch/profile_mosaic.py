"""Where one mosaic's time goes, and how the bf16 mask gates read across
weight seeds, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_mosaic [--seeds 0 1 2 3]

The workload is chip_smoke.py's: ViT-S/8 at full width with random weights,
on a 1152^2 uint8 mosaic from ``np.random.default_rng(0)``, window 384,
stride 128. Prints the card's name and power limit, then:

* for bf16 and f32 (weight seed 0): the device time of each kernel in one
  torch.profiler run of ``segment_mosaic``, that run's wall time and idle
  share (1 - the union of the device operations' intervals / wall), and the
  device time launched under each of the pipeline's spans (utils.profiling)
  in the same run;
* for each weight seed: chip_smoke.py's two bf16 mask gates (Dice of the
  bf16 mask against the f32 mask, and of the kernel route against the plain
  route in bf16), with the last block's CLS row rounded to the compute dtype
  as the JAX package rounds it.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import copy
import json
import os
import subprocess
import tempfile
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
from .sw_processing import load_model

SIZE, WINDOW, STRIDE = 1152, 384, 128
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# Chrome-trace categories of the device's operations and of their launches
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


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


def innermost_span(spans, ts):
    """Name of the innermost of ``spans`` ((start, end, name), sorted, on
    one thread; nested or disjoint) that holds ``ts``, or None."""
    for start, end, name in reversed(spans[: bisect.bisect_right(spans, (ts, float("inf"), ""))]):
        if end >= ts:
            return name
    return None


def device_ops(trace: dict):
    """[(name, start us, end us, span)] of every device operation (kernel,
    copy, set) of a Chrome trace (``export_chrome_trace``'s JSON), in order
    of start; ``span`` is the innermost ``record_function`` span on the
    launching thread when the launch ran (matched through the correlation
    id)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans, launches = {}, {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ts = float(e["ts"])
            spans.setdefault(e.get("tid"), []).append((ts, ts + float(e["dur"]), e["name"]))
        elif e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    for v in spans.values():
        v.sort()
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            ts = float(e["ts"])
            launch = launches.get(e.get("args", {}).get("correlation"))
            span = innermost_span(spans.get(launch[0], []), launch[1]) if launch else None
            out.append((e.get("name", ""), ts, ts + float(e.get("dur", 0.0)), span))
    return sorted(out, key=lambda op: op[1])


def chrome_trace(prof) -> dict:
    """The Chrome trace of a finished torch.profiler run, as JSON."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def union_ms(intervals):
    """Milliseconds of the union of (start us, end us) intervals: two that
    overlap (operations on two streams) count once."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def span_device_ms(ops):
    """{span: device ms of the union of the operations launched under it}
    of :func:`device_ops`' list, the spans in order of their first operation."""
    by_span = {}
    for _, start, end, span in ops:
        by_span.setdefault(span or "outside_spans", []).append((start, end))
    return {span: union_ms(iv) for span, iv in by_span.items()}


def kernel_table(prof, wall, top=16):
    """Print the device time of each kernel in a torch.profiler run of
    ``wall`` ms, its idle share (1 - the union of the device operations'
    intervals / wall) and the ``top`` kernels. Returns :func:`device_ops`'
    list."""
    # kernels only: CPU ranges (aten ops, autograd Functions) and their GPU
    # annotations (the optimizer step) carry their kernels' time too
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   and e.self_device_time_total > 0),
                  reverse=True)
    ops = device_ops(chrome_trace(prof))
    busy = union_ms((start, end) for _, start, end, _ in ops)
    ours = sum(r[0] for r in rows if "vitocm::" in r[2])
    print(f"  wall {wall:.3f} ms under the profiler, device busy {busy:.3f} ms "
          f"({ours:.3f} ms in the port's kernels), idle share {1 - busy / wall:.4f}, "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in rows[:top]:
        print(f"    {ms:9.3f} ms x{count:4d}  {key[:100]}")
    return ops


def profile_mosaic(model, img, dtype):
    for _ in range(2):  # warm-up: allocator, cuBLAS handles
        pl.segment_mosaic(model, img, WINDOW, STRIDE, dtype=dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pl.segment_mosaic(model, img, WINDOW, STRIDE, dtype=dtype)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = span_device_ms(kernel_table(prof, wall))
    print("  device ms by span (the same run): "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in split.items()))


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

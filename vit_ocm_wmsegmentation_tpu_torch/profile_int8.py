"""Device time of the int8 serving route's kernels at one mosaic's shapes, on
one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_int8 [--iters 20]

The rows are those of a 1152^2 mosaic at window 384 and stride 128: 49
windows of 2305 ViT-S/8 tokens, 112945 rows, bfloat16, drawn from seed 0.
Prints the card's name and power limit, then one JSON line for each of
``quantize_rows`` at the two row widths the route quantizes (384 and 1536)
and ``int8_dot`` (quantizer, GEMM and dequant, bf16 out with a bias) at the
four projections (qkv, proj, fc1, fc2): the median of single calls timed
with CUDA events, and the mean with calls queued back to back.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from .ops import quant as qz

ROWS = 49 * 2305
PROJ_SHAPES = ((384, 1152), (384, 384), (384, 1536), (1536, 384))  # (K, N)


def single_ms(fn, iters):
    """Median device time of one fn() call in ms, CUDA events around each."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, iters):
    """Device time of one fn() call in ms with iters calls queued back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = {k: torch.randn(ROWS, k, generator=gen, device=dev).to(torch.bfloat16)
          for k in sorted({k for k, _ in PROJ_SHAPES})}
    cases = [(f"quantize_rows[{k}]", lambda x=x: qz.quantize_rows(x)) for k, x in xs.items()]
    for k, n in PROJ_SHAPES:
        w = (torch.randn(n, k, generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        wq, bias = qz.colwise_int8(w), torch.randn(n, generator=gen, device=dev) * 0.1
        cases.append((f"int8_dot[{k}->{n}]",
                      lambda x=xs[k], wq=wq, b=bias: qz.int8_dot(x, wq, b, torch.bfloat16)))
    for name, fn in cases:
        print(json.dumps({"name": name, "ms": single_ms(fn, args.iters),
                          "queued_ms": queued_ms(fn, args.iters)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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

import torch

from .ops import quant as qz
from .utils.profiling import card_line, cuda_ms, queued_ms

ROWS = 49 * 2305
PROJ_SHAPES = ((384, 1152), (384, 384), (384, 1536), (1536, 384))  # (K, N)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    print(card_line())
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
        print(json.dumps({"name": name, "ms": cuda_ms(fn, iters=args.iters, warmup=2),
                          "queued_ms": queued_ms(fn, n=args.iters)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Attention variants at the mosaic's hot shape on the port's kernel:
``tools/bench_attention_variants.py`` of the JAX package, with its argv.

    python -m vit_ocm_wmsegmentation_tpu_torch.tools.bench_attention_variants

(B = 49 tiles, h = 6, N = 2305, d = 64) bf16 from the original's seed,
folded as the original folds it: kt and v zero-padded to 2432 keys, padded
keys at -1e30. Modes (``csrc/probe_attention_wgmma.cu``): full (exp(s - row
max), denominator the f32 sum of p), bf16exp (exp of bf16(s - max), rounded
to bf16), noexp (p = relu(s), denominator sum + 1), dotsonly (p = s, none).
``block_q`` is the TPU grid's block and the same launch on this card: its
rows share one time. Each row prints the median time by CUDA events, the
useful rate (4 B h N^2 d), max|d| against the plain twin and the mode's
kernel launches.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from . import add_common_args, cuda_ms, fmt_ms, max_abs_err, resolve_device, tflops

B, H, N, D = 49, 6, 2305, 64
MODES = ("full", "dotsonly", "noexp", "bf16exp")
BLOCK_Q = (256, 512, 1024)


def _round_up(x, m):
    return (x + m - 1) // m * m


def folded_inputs(b, h, n, device, d=D):
    """The original's q, k, v (B, h, N, d) from default_rng(0), folded to
    q (B h, N, d), kt (B h, d, Np) and v (B h, Np, d) with zero rows past N,
    Np = N rounded up to 128, and the -1e30 bias of the padded keys."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (b, h, n, d)) for _ in range(3))
    np_ = _round_up(n, 128)

    def fold(x, rows):
        x = torch.from_numpy(x).to(device=device, dtype=torch.bfloat16).reshape(b * h, n, d)
        return torch.nn.functional.pad(x, (0, 0, 0, rows - n))

    qf, kt, vf = fold(q, n), fold(k, np_).transpose(1, 2).contiguous(), fold(v, np_)
    bias = torch.where(torch.arange(np_, device=device) < n, 0.0, -1e30).float()
    return qf, kt, vf, bias, d ** -0.5


def main(argv=None):
    parser = argparse.ArgumentParser("bench_attention_variants (PyTorch/CUDA)")
    parser.add_argument("--shape", default=(B, H, N), type=int, nargs=3, metavar=("B", "H", "N"))
    parser.add_argument("--modes", default=list(MODES), nargs="+", choices=MODES)
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    b, h, n = args.shape
    q, kt, v, bias, scale = folded_inputs(b, h, n, device)
    flops = 4 * b * h * n * n * D
    results = {}
    for mode in args.modes:
        run = lambda mode=mode: probes.probe_attention(mode, q, kt, v, bias, scale)  # noqa: E731
        before = probes.probe_attention.launches
        err = max_abs_err(run(), probes.probe_attention_plain(mode, q, kt, v, bias, scale))
        ms = cuda_ms(run, device, args.iters)
        results[mode] = (ms, err, probes.probe_attention.launches - before)
        for bq in BLOCK_Q:
            print(f"{mode:9s} bq={bq:5d}  {fmt_ms(ms)}  {tflops(flops, ms)} TF/s(dots)  "
                  f"max|d| {err:.3e}  launches {results[mode][2]} (one launch for every bq)",
                  flush=True)
    return results


if __name__ == "__main__":
    main()

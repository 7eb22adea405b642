"""Dot-shape probe on the port's kernels: ``tools/probe_dot.py`` of the JAX
package, with its argv.

    python -m vit_ocm_wmsegmentation_tpu_torch.tools.probe_dot {mm_bf16|mm_int8|attn_int8|attn_bf16}

``mm_*`` times the tiled matmul (``csrc/matmul_wgmma.cu``) at M = K = N =
2048 on the original's seeded inputs (int8 in [-3, 3), bf16 N(0, 0.1)); B
is transposed to (N, K) once, before the timed calls. ``attn_*`` times both
attention products at the mosaic's folded shape (294 groups, 2432 keys, d
64; ``csrc/probe_attention_wgmma.cu``, variant "dot"): s = q kt / 16 + bias,
p = exp(s - row max) requantized to int8 as trunc(p * 127) or kept in bf16,
o = (p v)[:, :64] unnormalized, in bf16. Each line gives the median time by
CUDA events, the rate (useful attention FLOPs, 4 B H N^2 D, as the original
counts them), the max|d| against the plain twin and the kernel launches
the line made. ``--device cpu`` with
``--mm_size`` / ``--attn_shape`` runs a small case on the twins, untimed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from . import add_common_args, cuda_ms, fmt_ms, max_abs_err, resolve_device, tflops

B, H, N, D = 49, 6, 2305, 64
NP = 2432
MODES = ("mm_bf16", "mm_int8", "attn_int8", "attn_bf16")


def matmul_inputs(dtype, m, k, n, device):
    """The original's seeded a (M, K) and b (K, N), b returned transposed."""
    rng = np.random.default_rng(0)
    if dtype == torch.int8:
        a, b = rng.integers(-3, 3, (m, k)), rng.integers(-3, 3, (k, n))
    else:
        a, b = rng.normal(0, 0.1, (m, k)), rng.normal(0, 0.1, (k, n))
    a = torch.from_numpy(a).to(device=device, dtype=dtype)
    bt = torch.from_numpy(np.ascontiguousarray(b.T)).to(device=device, dtype=dtype)
    return a, bt


def matmul(dtype, device, size=2048, iters=10):
    a, bt = matmul_inputs(dtype, size, size, size, device)
    before = probes.probe_matmul.launches
    err = max_abs_err(probes.probe_matmul(a, bt), probes.probe_matmul_plain(a, bt))
    ms = cuda_ms(lambda: probes.probe_matmul(a, bt), device, iters)
    tf = tflops(2 * size ** 3, ms)
    print(f"{fmt_ms(ms)}  {tf} TF/s  max|d| {err:.3e} (plain twin)  launches "
          f"{probes.probe_matmul.launches - before}", flush=True)
    return ms, err


def attn_inputs(dtype, groups, np_, device):
    """The original's seeded q (G, Np, D), kt (G, D, Np), v (G, Np, 2D) and
    zero bias."""
    rng = np.random.default_rng(0)
    if dtype == torch.int8:
        q, kt, v = (rng.integers(-100, 100, s) for s in
                    ((groups, np_, D), (groups, D, np_), (groups, np_, 2 * D)))
    else:
        q, kt, v = (rng.normal(0, 1, s) for s in
                    ((groups, np_, D), (groups, D, np_), (groups, np_, 2 * D)))
    to = lambda x: torch.from_numpy(x).to(device=device, dtype=dtype)  # noqa: E731
    return to(q), to(kt), to(v), torch.zeros(np_, dtype=torch.float32, device=device)


def attn(dtype, device, groups=B * H, n=N, np_=NP, iters=10):
    q, kt, v, bias = attn_inputs(dtype, groups, np_, device)
    run = lambda: probes.probe_attention("dot", q, kt, v, bias, 1.0 / 16.0)  # noqa: E731
    before = probes.probe_attention.launches
    err = max_abs_err(run(), probes.probe_attention_plain("dot", q, kt, v, bias, 1.0 / 16.0))
    ms = cuda_ms(run, device, iters)
    tf = tflops(4 * groups * n * n * D, ms)
    print(f"{fmt_ms(ms)}  {tf} TF/s(dots, useful)  max|d| {err:.3e} (plain twin)  launches "
          f"{probes.probe_attention.launches - before}", flush=True)
    return ms, err


def main(argv=None):
    parser = argparse.ArgumentParser("probe_dot (PyTorch/CUDA)")
    parser.add_argument("which", choices=MODES)
    parser.add_argument("--mm_size", default=2048, type=int, help="M = K = N of mm_*")
    parser.add_argument("--attn_shape", default=(B * H, N, NP), type=int, nargs=3,
                        metavar=("GROUPS", "N", "NP"),
                        help="attn_*: (batch, head) groups, useful tokens, padded keys")
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.int8 if args.which.endswith("int8") else torch.bfloat16
    if args.which.startswith("mm"):
        return matmul(dtype, device, args.mm_size, args.iters)
    return attn(dtype, device, *args.attn_shape, iters=args.iters)


if __name__ == "__main__":
    main()

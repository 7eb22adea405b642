"""Attention optimisation variants on the port's kernel:
``tools/bench_attn_opt.py`` of the JAX package, with its argv (several
variants, or ``all``, may share one process).

    python -m vit_ocm_wmsegmentation_tpu_torch.tools.bench_attn_opt <variant> [<variant> ...]

One mosaic layer's attention (B = 49, h = 6, N = 2305, d = 64, 2432 padded
keys at -1e30) on the original's seeded inputs, ones-column denominators
throughout. The sixteen variants compute nine functions
(``ops.probes.VARIANTS``, ``csrc/probe_attention_wgmma.cu``): v0 (row max,
exp), exp2 (LOG2E folded into q), nomax, normbound (Cauchy-Schwarz shift),
bf16sm (bf16 scores, max and exp2), combo (normbound on untransposed k and
64-wide v), qkvflat (normbound read from the fused qkv projection, o written
into its three sections), qkvflat_pipe2 (with exp2) and qkvflat_pipe2b (with
bf16 s - m and exp2). split2/4, stagger2/4/8, grid2 and qkvflat_pipe probe
the TPU compiler's emission order and are the same launch on this card as
the function they compute (``note`` says which). One JSON line per variant:
``ms`` (median by CUDA events, in place of the original's ``slope_ms``),
``useful_tflops`` (4 B h N^2 d), ``max_abs_err`` against the plain twin and
``launches``, the kernel launches the line made (0 for a variant whose
function an earlier line measured).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import probes
from . import add_common_args, cuda_ms, max_abs_err, resolve_device, tflops

B, H, N, D = 49, 6, 2305, 64
LOG2E = 1.4426950408889634
# the original's variants -> the function each computes (ops.probes.VARIANTS)
VARIANTS = {"v0": "v0", "exp2": "exp2", "split2": "exp2", "split4": "exp2", "grid2": "v0",
            "nomax": "nomax", "normbound": "normbound", "bf16sm": "bf16sm",
            "stagger2": "exp2", "stagger4": "exp2", "stagger8": "exp2", "combo": "combo",
            "qkvflat": "qkvflat", "qkvflat_pipe": "qkvflat", "qkvflat_pipe2": "qkvflat_pipe2",
            "qkvflat_pipe2b": "qkvflat_pipe2b"}
_EXP2 = ("exp2", "bf16sm", "qkvflat_pipe2", "qkvflat_pipe2b")  # q pre-scaled by LOG2E


def _round_up(x, m):
    return (x + m - 1) // m * m


def inputs(function, device, b=B, h=H, n=N):
    """probe_attention's keyword arguments for one of the nine functions, on
    the original's inputs from default_rng(0): q rows 8-aligned (BQ), keys
    128-aligned (NP), q pre-scaled by d^-1/2 (and LOG2E for exp2)."""
    np_, bq = _round_up(n, 128), _round_up(n, 8)
    rng = np.random.default_rng(0)
    scale = D ** -0.5 * (LOG2E if function in _EXP2 else 1.0)
    bias = torch.where(torch.arange(np_, device=device) < n, 0.0, -1e30).float()
    to = lambda x: torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)  # noqa: E731
    layout = probes.VARIANTS[function].layout
    if layout == "qkvflat":
        qkv = rng.normal(0, 1, (b, np_, 3 * h * D))
        qkv[:, :, :h * D] *= scale
        return {"q": to(qkv), "bias": bias, "heads": h}
    q = to(rng.normal(0, 1, (b * h, bq, D)) * scale)
    if layout == "folded":
        k, v = to(rng.normal(0, 1, (b * h, np_, D))), to(rng.normal(0, 1, (b * h, np_, D)))
        return {"q": q, "k": k, "v": v, "bias": bias}
    kt = to(rng.normal(0, 1, (b * h, D, np_)))
    v = rng.normal(0, 1, (b * h, np_, D))
    ve = np.concatenate([v, np.ones((b * h, np_, 1)), np.zeros((b * h, np_, D - 1))], axis=-1)
    return {"q": q, "k": kt, "v": to(ve), "bias": bias}


def main(argv=None):
    parser = argparse.ArgumentParser("bench_attn_opt (PyTorch/CUDA)")
    parser.add_argument("variants", nargs="+", choices=[*VARIANTS, "all"])
    parser.add_argument("--shape", default=(B, H, N), type=int, nargs=3, metavar=("B", "H", "N"))
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    b, h, n = args.shape
    names = list(VARIANTS) if "all" in args.variants else args.variants
    measured, lines = {}, []
    for which in names:
        fn = VARIANTS[which]
        before = probes.probe_attention.launches
        if fn not in measured:
            kw = inputs(fn, device, b, h, n)
            run = lambda fn=fn, kw=kw: probes.probe_attention(fn, **kw)  # noqa: E731
            err = max_abs_err(run(), probes.probe_attention_plain(fn, **kw))
            measured[fn] = (cuda_ms(run, device, args.iters), err)
            del kw
        ms, err = measured[fn]
        line = {"variant": which, "function": fn, "ms": None if ms is None else round(ms, 4),
                "useful_tflops": tflops(4 * b * h * n * n * D, ms), "max_abs_err": err,
                "launches": probes.probe_attention.launches - before}
        if fn != which:
            line["note"] = (f"an emission-order probe of the TPU compiler: the same launch as "
                            f"{fn} on this card")
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()

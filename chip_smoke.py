#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vit_ocm_wmsegmentation_tpu_torch/csrc``
and then, failing on the first phase that fails:

0. prints the card's name and power limit (nvidia-smi) and the build time;
1. holds each kernel against its plain PyTorch twin on the card at the
   shapes its main path gives it, in float32 and bfloat16 (outputs within
   1e-5 / 1e-2 of max|twin|, gradients within 1e-4 / 2e-2), and times the
   kernel, the twin and, where one PyTorch call computes the same function,
   that call (CUDA events, median of 10 after warm-up); the mosaic kernels
   at the 49-tile mosaic's shapes, the training kernels at the MIM step's;
2. runs ``segment_mosaic`` on a 1152^2 uint8 mosaic (window 384, stride 128,
   49 tiles) with ViT-S/8 at full width and random weights from a seed, in
   float32 and bfloat16: bf16-vs-f32 mask Dice > 0.99, kernel route vs plain
   route Dice >= 0.99 in both dtypes, and the launch counts of one call
   (11 attention, 10 LN-out MLP, 1 plain fused MLP);
3. serves three mosaics from a directory through the port's
   ``sw_processing.main`` and checks the written masks;
4. trains the SimMIM ViT (width 384, depth 4, 3 heads of 128, patch 8) at
   full width on 16 synthetic 384^2 images, in float32 and in AMP bf16: the
   first step's loss, grad norm and gradients against the plain route, the
   launches of one step (4 of each training kernel), ms/step, images/s and
   peak device memory;
5. runs the MIM CLI ``mim.main`` on 32 synthetic PNGs for 2 epochs, then
   for 3 into the same output, which must resume at epoch 2 with the
   optimizer state;
6. prints the per-kernel JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero, with no result line, when no CUDA device is available or
the port's package is missing.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

SIZE, WINDOW, STRIDE = 1152, 384, 128
TILES, TOKENS = 49, 2305  # (1152-384)/128+1 = 7 per axis; 48*48 patches + CLS
MIM_BATCH, MIM_SIZE = 16, 384  # mim.py defaults; 48*48 patches + CLS = TOKENS
F32_TOL, BF16_TOL = 1e-5, 1e-2  # outputs: max|kernel - plain| / max|plain|
GRAD_TOL = {"f32": 1e-4, "bf16": 2e-2}  # gradients
LSE_TOL = {"f32": 1e-5, "bf16": 1e-3}  # f32 lse; in bf16 a one-ulp flip of a rounded P moves it
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them; HBM3
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
CSRC = "vit_ocm_wmsegmentation_tpu_torch/csrc/"
FA = "vit_ocm_wmsegmentation_tpu/ops/flash_attention.py"
FM = "vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py"
# wrapper -> (module, source file per storage dtype, TPU kernel it replaces)
KERNELS = {
    "attention_qkv": ("fa", {"f32": "attention_qkv.cu", "bf16": "attention_qkv_mma.cu"},
                      FA + ":468"),
    "fused_mlp_block_lnout": ("fm", {"f32": "fused_mlp.cu", "bf16": "fused_mlp_mma.cu"},
                              FM + ":154"),
    "fused_mlp_block": ("fm", {"f32": "fused_mlp.cu", "bf16": "fused_mlp_mma.cu"}, FM + ":123"),
    "flash_attention": ("fa", {"f32": "attention_qkv.cu", "bf16": "attention_qkv_mma.cu"},
                        FA + ":74"),
    "flash_attention_bwd": ("fa", {"f32": "attention_bwd.cu", "bf16": "attention_bwd_mma.cu"},
                            FA + ":297"),
    "fused_mlp_block_h1": ("fm", {"f32": "fused_mlp.cu", "bf16": "fused_mlp_mma.cu"},
                           FM + ":123"),
    "fused_mlp_bwd": ("fm", {"f32": "fused_mlp_bwd.cu", "bf16": "fused_mlp_bwd_mma.cu"},
                      FM + ":243"),
}
MOSAIC_LAUNCHES = {"attention_qkv": 11, "fused_mlp_block_lnout": 10, "fused_mlp_block": 1}
MIM_LAUNCHES = {"flash_attention": 4, "flash_attention_bwd": 4, "fused_mlp_block_h1": 4,
                "fused_mlp_bwd": 4}


def _modules():
    from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as fa
    from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as fm

    return {"fa": fa, "fm": fm}


def launch_counts():
    mods = _modules()
    return {name: getattr(mods[m], name).launches for name, (m, _, _) in KERNELS.items()}


def reset_counts():
    mods = _modules()
    for name, (m, _, _) in KERNELS.items():
        getattr(mods[m], name).launches = 0


@contextlib.contextmanager
def plain_training_route():
    """Every training kernel wrapper swapped for its plain twin."""
    fa, fm = _modules()["fa"], _modules()["fm"]
    twins = {(fa, "flash_attention"): fa.flash_attention_plain,
             (fa, "flash_attention_bwd"): fa.flash_attention_bwd_plain,
             (fm, "fused_mlp_block_h1"): lambda *a: fm.fused_mlp_block_plain(*a, want_h1=True),
             (fm, "fused_mlp_bwd"): fm.fused_mlp_bwd_plain}
    with contextlib.ExitStack() as stack:
        for (mod, name), twin in twins.items():
            stack.enter_context(mock.patch.object(mod, name, twin))
        yield


def cuda_ms(fn, iters=10, warmup=2):
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
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


def bound(flops, nbytes, tag):
    """(least time in ms, what bounds it) for flops and bytes on the card."""
    t_ops, t_mem = flops / PEAK_FLOPS[tag], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def _rel_err(got, want):
    got = [g.float() for g in (got if isinstance(got, (tuple, list)) else (got,))]
    want = [w.float() for w in (want if isinstance(want, (tuple, list)) else (want,))]
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    scales = [float(w.abs().max()) for w in want]
    finite = all(bool(g.isfinite().all()) for g in got)
    return max(errs), max(e / max(s, 1e-30) for e, s in zip(errs, scales)), finite


def _compare(name, tag, got, want, tol):
    err, rel, finite = _rel_err(got, want)
    print(f"  {name}[{tag}]: max|d| {err:.3e}, rel {rel:.3e} (tol {tol:g})")
    if not finite or rel > tol:
        raise AssertionError(f"{name}[{tag}] disagrees with its plain twin: rel {rel:.3e} > {tol:g}"
                             f" (finite={finite})")
    return err


def _kernel_cases(tag, dtype, gen):
    """name -> (kernel call, twin call, check(kernel out, twin out) -> max|d|,
    library call or None, flops, bytes) at the main paths' shapes."""
    import torch
    import torch.nn.functional as F

    fa, fm = _modules()["fa"], _modules()["fm"]
    dev = torch.device("cuda")
    isz = torch.finfo(dtype).bits // 8

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * std + mean

    tol = F32_TOL if tag == "f32" else BF16_TOL
    cases = {}
    # the mosaic's attention: 49 tiles, 6 heads of 64, q section pre-scaled
    heads, d, dm = 6, 64, 384
    qkv = randn(TILES, TOKENS, 3 * dm)
    qkv[..., :dm] *= d ** -0.5
    qkv = qkv.to(dtype)
    hv = lambda i: qkv[..., i * dm:(i + 1) * dm].unflatten(-1, (heads, d)).transpose(1, 2)  # noqa: E731
    cases["attention_qkv"] = (
        lambda: fa.attention_qkv(qkv, heads, TOKENS), lambda: fa.attention_qkv_plain(qkv, heads, TOKENS),
        lambda g, w: _compare("attention_qkv", tag, g, w, tol),
        lambda: F.scaled_dot_product_attention(hv(0), hv(1), hv(2), scale=1.0),
        4 * TILES * heads * TOKENS ** 2 * d, TILES * TOKENS * 4 * dm * isz)
    # the mosaic's MLP blocks: 49 * 2305 rows
    rows, hid = TILES * TOKENS, 1536
    x = randn(rows, dm).to(dtype)
    mlp = (randn(dm, std=0.1, mean=1.0), randn(dm, std=0.1),
           randn(hid, dm, std=dm ** -0.5).to(dtype), randn(hid, std=0.1),
           randn(dm, hid, std=hid ** -0.5).to(dtype), randn(dm, std=0.1))
    ln2 = (randn(dm, std=0.1, mean=1.0), randn(dm, std=0.1))
    w_bytes = 2 * dm * hid * isz
    cases["fused_mlp_block_lnout"] = (
        lambda: fm.fused_mlp_block_lnout(x, *mlp, *ln2),
        lambda: fm.fused_mlp_block_lnout_plain(x, *mlp, *ln2),
        lambda g, w: _compare("fused_mlp_block_lnout", tag, g, w, tol), None,
        4 * rows * dm * hid, 3 * rows * dm * isz + w_bytes)
    cases["fused_mlp_block"] = (
        lambda: fm.fused_mlp_block(x, *mlp), lambda: fm.fused_mlp_block_plain(x, *mlp),
        lambda g, w: _compare("fused_mlp_block", tag, g, w, tol), None,
        4 * rows * dm * hid, 2 * rows * dm * isz + w_bytes)

    # the MIM step's attention: 16 images x 3 heads of 128, folded
    bh, n, hd = MIM_BATCH * 3, TOKENS, 128
    q, k, v, do = (randn(bh, n, hd).to(dtype) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()

    def check_fwd(g, w):
        err = _compare("flash_attention", tag, g[0], w[0], tol)
        _compare("flash_attention lse", tag, g[1], w[1], LSE_TOL[tag])
        return err

    sdpa_in = [t.unflatten(0, (MIM_BATCH, 3)).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in)
    cases["flash_attention"] = (
        lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_plain(q, k, v), check_fwd,
        lambda: F.scaled_dot_product_attention(*sdpa_in),
        4 * bh * n * n * hd, (4 * bh * n * hd) * isz + bh * n * 4)
    cases["flash_attention_bwd"] = (
        lambda: fa.flash_attention_bwd(q, k, v, out, lse, do),
        lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do),
        lambda g, w: _compare("flash_attention_bwd", tag, g, w, GRAD_TOL[tag]),
        lambda: torch.autograd.grad(sdpa_out, sdpa_in, do.unflatten(0, (MIM_BATCH, 3)),
                                    retain_graph=True),
        10 * bh * n * n * hd, (8 * bh * n * hd) * isz + bh * n * 4)
    # the MIM step's MLP blocks: 16 * 2305 rows
    rows = MIM_BATCH * TOKENS
    xm, dom = randn(rows, dm).to(dtype), randn(rows, dm).to(dtype)
    _, h1 = fm.fused_mlp_block_h1(xm, *mlp)
    s, bb, w1, _, w2, _ = mlp
    cases["fused_mlp_block_h1"] = (
        lambda: fm.fused_mlp_block_h1(xm, *mlp),
        lambda: fm.fused_mlp_block_plain(xm, *mlp, want_h1=True),
        lambda g, w: _compare("fused_mlp_block_h1", tag, g, w, tol), None,
        4 * rows * dm * hid, (2 * rows * dm + rows * hid) * isz + w_bytes)
    cases["fused_mlp_bwd"] = (
        lambda: fm.fused_mlp_bwd(xm, dom, h1, s, bb, w1, w2),
        lambda: fm.fused_mlp_bwd_plain(xm, dom, h1, s, bb, w1, w2),
        lambda g, w: _compare("fused_mlp_bwd", tag, g, w, GRAD_TOL[tag]), None,
        8 * rows * dm * hid, (3 * rows * dm + rows * hid) * isz + w_bytes + 2 * dm * hid * 4)
    return cases


def phase_kernels():
    """Each kernel against its plain twin at its main path's shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for name, (kern, plain, check, library, flops, nbytes) in _kernel_cases(tag, dtype,
                                                                                gen).items():
            got = kern()
            torch.cuda.synchronize()
            err = check(got, plain())
            del got
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain, iters=5, warmup=1)
            lib_ms = cuda_ms(library) if library is not None else None
            bound_ms, bound_by = bound(flops, nbytes, tag)
            lib = f", library {lib_ms:.3f} ms" if lib_ms is not None else ""
            print(f"  {name}[{tag}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, "
                  f"bound {bound_ms:.3f} ms ({bound_by})")
            results[(name, tag)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound_ms, "bound_by": bound_by,
                                    "library_ms": lib_ms}
        torch.cuda.empty_cache()
    return results


def phase_slice():
    """segment_mosaic at full width: dtype gate, route envelope, launches."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.profile_mosaic import dice, plain_route
    from vit_ocm_wmsegmentation_tpu_torch.sw_processing import load_model

    dev = torch.device("cuda")
    model32 = load_model("vit_small", 8, seed=0, device=dev)
    models = {"f32": model32, "bf16": pl.cast_params(copy.deepcopy(model32), torch.bfloat16)}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((SIZE, SIZE)) * 255).astype(np.uint8)).to(dev)

    def run(tag):
        return pl.segment_mosaic(models[tag], img, WINDOW, STRIDE, dtype=dtypes[tag])

    for tag in dtypes:  # warm-up (allocator, cuBLAS handles)
        run(tag)
    torch.cuda.synchronize()

    out, launches = {}, {}
    for tag in dtypes:
        reset_counts()
        mask, attn = run(tag)
        torch.cuda.synchronize()
        launches[tag] = launch_counts()
        out[tag] = (mask.cpu().numpy(), attn.cpu().numpy())
        print(f"  main path [{tag}] launches: {launches[tag]}")
        want = {name: MOSAIC_LAUNCHES.get(name, 0) for name in KERNELS}
        if launches[tag] != want:
            raise AssertionError(f"launch counts {launches[tag]} != {want}")
        m, a = out[tag]
        if m.shape != (SIZE, SIZE) or a.shape != (SIZE, SIZE) or not np.isfinite(a).all():
            raise AssertionError(f"[{tag}] bad outputs: {m.shape} {a.shape}")
        if not set(np.unique(m).tolist()) <= {0, 255}:
            raise AssertionError(f"[{tag}] mask values outside {{0, 255}}")
    d16 = dice(out["f32"][0], out["bf16"][0])
    print(f"  bf16 vs f32 mask Dice {d16:.5f} (gate > 0.99)")
    if not d16 > 0.99:
        raise AssertionError(f"bf16/f32 mask Dice {d16:.5f} below the 0.99 gate")

    # the plain route: the same path with every kernel wrapper swapped for
    # its plain twin, called directly
    plain_ms = {}
    reset_counts()
    with plain_route():
        for tag in dtypes:
            mask, attn = run(tag)
            pm, pa = mask.cpu().numpy(), attn.cpu().numpy()
            dk = dice(out[tag][0], pm)
            print(f"  kernel vs plain route [{tag}]: mask Dice {dk:.5f}, attention "
                  f"max|d| {np.abs(out[tag][1] - pa).max():.3e} on the 0-255 scale")
            if not dk >= 0.99:
                raise AssertionError(f"[{tag}] kernel vs plain route Dice {dk:.5f} < 0.99")
        plain_ms["bf16"] = cuda_ms(lambda: run("bf16"), iters=5, warmup=1)
    if any(launch_counts().values()):
        raise AssertionError("the plain route launched a kernel")

    times = {tag: cuda_ms(lambda tag=tag: run(tag), iters=5, warmup=1) for tag in dtypes}
    torch.cuda.reset_peak_memory_stats()
    run("bf16")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    mp = SIZE * SIZE / 1e6
    for tag in dtypes:
        print(f"  segment_mosaic [{tag}] kernel route: {times[tag]:.2f} ms/mosaic, "
              f"{mp / (times[tag] / 1e3):.3f} MP/s")
    print(f"  segment_mosaic [bf16] plain route: {plain_ms['bf16']:.2f} ms/mosaic, "
          f"{mp / (plain_ms['bf16'] / 1e3):.3f} MP/s")
    print(f"  peak device memory, one bf16 mosaic: {peak / 2**30:.3f} GiB")
    return launches, models["bf16"]


def phase_serving(model_bf16):
    """Three mosaics served from a directory; masks equal segment_mosaic's."""
    import torch
    from PIL import Image

    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch import sw_processing as sw

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        for i in range(3):
            rng = np.random.default_rng(i + 1)
            Image.fromarray((rng.random((SIZE, SIZE)) * 255).astype(np.uint8)).save(
                os.path.join(src, f"mosaic{i}.png"))
        t0 = time.perf_counter()
        masks = sw.main(["--image_path", src, "--output_dir", dst, "--bf16", "1",
                         "--save", "mask", "--device", "cuda"])
        print(f"  served 3 mosaics in {time.perf_counter() - t0:.2f} s (host clock)")
        if sorted(masks) != [f"mosaic{i}" for i in range(3)]:
            raise AssertionError(f"served {sorted(masks)}")
        for name, mask in masks.items():
            path = os.path.join(dst, name, "otsu_sw.jpg")
            if not os.path.isfile(path):
                raise AssertionError(f"missing {path}")
            if not np.array_equal(np.asarray(Image.open(path)), mask):
                raise AssertionError(f"{path} differs from the returned mask")
            gray = torch.from_numpy(sw.decode(os.path.join(src, name + ".png"),
                                              (SIZE, SIZE))).cuda()
            want, _ = pl.segment_mosaic(model_bf16, gray, WINDOW, STRIDE, dtype=torch.bfloat16)
            if not np.array_equal(want.cpu().numpy(), mask):
                raise AssertionError(f"{name}: served mask differs from segment_mosaic's")
    print("  served masks equal segment_mosaic's")


def _mim_cfg(amp):
    from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

    cfg = default_config()
    cfg.DATA.IMG_SIZE = MIM_SIZE
    cfg.AMP_OPT_LEVEL = "O1" if amp else ""
    return cfg


def _mim_grads(model, x, mask, amp):
    """(loss, grad norm, gradients) of one MIM step's loss, no update."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.train.optim import global_norm

    if amp:
        live = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        loss, _, _ = torch.func.functional_call(model, live, (x.to(torch.bfloat16), mask))
    else:
        loss, _, _ = model(x, mask)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), float(global_norm(grads)), grads


def phase_mim():
    """The MIM train step at full width, f32 and AMP bf16."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.data.mask_generator import MaskGenerator
    from vit_ocm_wmsegmentation_tpu_torch.models import simmim
    from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step
    from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((MIM_BATCH, MIM_SIZE, MIM_SIZE, 3), dtype=np.float32)).to(dev)
    gen_mask = MaskGenerator(MIM_SIZE, 16, 8, 0.5)
    mask = torch.from_numpy(np.stack([gen_mask(rng) for _ in range(MIM_BATCH)])).to(dev)
    vit_cfg = simmim.mim_vit_config(MIM_SIZE, 8)
    model0 = simmim.init(vit_cfg, torch.Generator().manual_seed(0), dev)
    launches = {}
    for tag, amp in (("f32", False), ("bf16", True)):
        loss, gnorm, grads = _mim_grads(model0, x, mask, amp)
        with plain_training_route():
            ploss, pgnorm, pgrads = _mim_grads(model0, x, mask, amp)
        rel = max(float((g - p).abs().max()) / max(float(p.abs().max()), 1e-30)
                  for g, p in zip(grads, pgrads))
        del grads, pgrads
        tol = 1e-5 if tag == "f32" else 1e-2
        print(f"  MIM step [{tag}] first step: loss {loss:.6f} (plain {ploss:.6f}), grad norm "
              f"{gnorm:.6f} (plain {pgnorm:.6f}), max relative gradient difference {rel:.3e}")
        if not (np.isfinite(loss) and abs(loss - ploss) <= tol * abs(ploss)
                and abs(gnorm - pgnorm) <= 10 * tol * abs(pgnorm)):
            raise AssertionError(f"[{tag}] MIM step disagrees with the plain route")

        model = copy.deepcopy(model0)
        step = make_train_step(model, Optimizer(_mim_cfg(amp), model, lambda t: 1e-4), amp=amp)
        torch.cuda.synchronize()
        reset_counts()
        step(x, mask)
        torch.cuda.synchronize()
        launches[tag] = launch_counts()
        want = {name: MIM_LAUNCHES.get(name, 0) for name in KERNELS}
        print(f"  MIM step [{tag}] launches: {launches[tag]}")
        if launches[tag] != want:
            raise AssertionError(f"launch counts {launches[tag]} != {want}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(x, mask), iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated()
        lsum = float(step(x, mask)[0])
        if not np.isfinite(lsum):
            raise AssertionError(f"[{tag}] loss {lsum} after 14 steps")
        print(f"  MIM step [{tag}]: {ms:.2f} ms/step, {MIM_BATCH / (ms / 1e3):.1f} images/s, "
              f"peak device memory {peak / 2**30:.3f} GiB, loss after 14 steps {lsum:.6f}")
        del model, step
        torch.cuda.empty_cache()
    return launches


def phase_mim_cli():
    """mim.main on 32 PNGs: 2 epochs, then resume to 3 with the optimizer."""
    import torch
    from PIL import Image

    from vit_ocm_wmsegmentation_tpu_torch import mim

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "imgs")
        os.makedirs(src)
        rng = np.random.default_rng(0)
        for i in range(32):
            Image.fromarray((rng.random((MIM_SIZE, MIM_SIZE)) * 255).astype(np.uint8)).save(
                os.path.join(src, f"tile{i:02d}.png"))
        args = ["--image_path", src, "--batch_size", str(MIM_BATCH), "--device", "cuda",
                "--output", os.path.join(tmp, "out"), "--output_dir", os.path.join(tmp, "log")]
        t0 = time.perf_counter()
        _, hist = mim.main(args + ["--epochs", "2"])
        print(f"  2 epochs in {time.perf_counter() - t0:.2f} s (host clock), losses {hist}")
        _, hist2 = mim.main(args + ["--epochs", "3"])
        ckpts = sorted(glob.glob(os.path.join(tmp, "out", "*", "*", "ckpt_epoch_*")))
        names = [os.path.basename(c) for c in ckpts]
        print(f"  resumed run losses {hist2}, checkpoints {names}")
        if len(hist) != 2 or len(hist2) != 1 or not np.isfinite(hist + hist2).all():
            raise AssertionError(f"epochs run {hist} then {hist2}")
        if names != ["ckpt_epoch_0", "ckpt_epoch_1", "ckpt_epoch_2"]:
            raise AssertionError(f"checkpoints {names}")
        last = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
        steps = {int(s["step"]) for s in last["optimizer"]["opt"]["state"].values()}
        if last["optimizer"]["updates"] != 6 or steps != {6}:
            raise AssertionError(f"resume lost the optimizer state: updates "
                                 f"{last['optimizer']['updates']}, AdamW steps {steps}")
    print("  resumed at epoch 2 with the optimizer state (6 AdamW steps after 3 epochs)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from vit_ocm_wmsegmentation_tpu_torch import build, pipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({build.build_info['seconds']:.1f} s "
          f"in nvcc)")
    for line in build.build_info["ptxas"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    phases = time.perf_counter()
    with pipeline.exact_matmuls():  # the plain twins' f32 matmuls too
        print("phase 1: kernels against their plain twins")
        kernels = phase_kernels()
        print("phase 2: segment_mosaic at full width")
        launches, model_bf16 = phase_slice()
        print("phase 3: directory serving")
        phase_serving(model_bf16)
        del model_bf16
        print("phase 4: the MIM step at full width")
        mim_launches = phase_mim()
    print("phase 5: the MIM CLI, with auto-resume")
    phase_mim_cli()
    print(f"phases 1-5: {time.perf_counter() - phases:.1f} s (host clock)")

    rows = []
    for (name, tag), r in kernels.items():
        _, sources, replaces = KERNELS[name]
        path_launches = (launches if name in MOSAIC_LAUNCHES else mim_launches)[tag][name]
        rows.append({"name": f"{name}[{tag}]", "route": "cuda", "source": CSRC + sources[tag],
                     "replaces": replaces, "launches": path_launches, **r})
    print(smi[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

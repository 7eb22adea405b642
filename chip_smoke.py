#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vit_ocm_wmsegmentation_tpu_torch/csrc``
and then, failing on the first phase that fails:

0. prints the card's name and power limit (nvidia-smi) and the build time,
   ptxas' registers, spills and shared memory for the kernels of
   SASS_CHECKS and asserts that they spill nothing and that their SASS holds
   the opcodes of their design: the wgmma kernels (``csrc/*_wgmma.cu``:
   inference and training attention forward, the training attention's dk/dv
   and dq kernels on both backward routes, the saved-P forward, the MLP
   forward in every bf16 instance, inference and training, the bf16 MLP
   backward's and LN -> qkv backward's dx and weight kernels, the LN -> qkv
   forward, and the GEMM of the int8 route and the probes in bf16)
   warpgroup products (HGMMA) and TMA loads (UTMALDG) and no mma.sync
   (HMMA), the GEMM's three int8 instances IGMMA and UTMALDG and no IMMA,
   the probe attention (``probe_attention_wgmma.cu``) HGMMA and UTMALDG in
   its 14 bf16 instances and IGMMA and UTMALDG in its int8 one;
   the f32 attention kernels (forward at both head dims and both layouts,
   the saved-P forward in its one- and two-pass instances, dk/dv and dq on
   both backward routes) and the f32 MLP kernels (the forward in every
   instance the launcher builds, the backward's dx and weight kernels) FFMA
   and cp.async (LDGSTS) and no tensor-core instruction (no TF32); the
   histogram bulk copies (UBLKCP) and shared-memory atomics (ATOMS); and
   that ptxas honoured every setmaxnreg of those kernels (no warning C7508);
1. holds each kernel against its plain PyTorch twin on the card at the
   shapes its main path gives it, in float32 and bfloat16 (outputs within
   1e-5 / 1e-2 of max|twin|, gradients within 1e-4 / 2e-2), and times the
   kernel, the twin and, where one PyTorch call computes the same function,
   that call (CUDA events, median of 10 after warm-up; for the saved-P
   forward the math attention, which returns O and P, with SDPA beside it as
   a control that returns no P), and the MLP block's products alone through
   cuBLAS (a GEMM-only reference: fc1 and fc2 at the
   mosaic's and the MIM step's rows, the backward's four products at the MIM
   step's); the mosaic kernels
   at the 49-tile mosaic's shapes, the training kernels at the MIM step's
   and, in f32, at the finetune step's (phase 12: attention at head dim 64,
   (18, 2305, 64), the MLP block at 6915 rows),
   the DINOv2 block's gate and LayerScale residual (``csrc/swiglu.cu``) at
   the g14 mosaic's 63749 rows (widths 2 x 4096 and 1536; the residual's
   sum bit-equal, and in bf16 99 % of the outputs equal to the twin's),
   beside ``F.silu(a) * b`` and ``x + y * gamma`` with ``F.layer_norm``;
   the histogram on a 32768^2 uint8 image, a view of it 3 bytes in, 2^24 +
   67 pixels of two values and two skewed buffers (2^30 zeros, ~90 % bin 0;
   counts exactly equal to the twin's; timed on the first and the skewed
   two); the opt-in training routes'
   kernels (saved-P attention forward and backward, the MLP block's gp
   forward and backward, LN -> qkv forward and backward) at the MIM step's
   shapes, the saved-P forward and backward and the LN -> qkv forward and
   backward bit-equal across two calls, the gp
   forward's out bit-equal to the h1 forward's; the tools/
   probes' kernels: the tiled matmul at 2048^3 in bf16 and int8 (int8
   stores bit-equal, wrapped), int8_dot at the mosaic's four projection
   shapes (112945 rows; bit-equal) and its row quantizer alone at both row
   widths (values and scales bit-equal), these and the 2048^3 matmul also
   with calls queued back to back (their host set-up rivals their device
   time), probe attention in int8 (each output
   within one bf16 ulp) and bf16, the four attention modes and the nine
   attention functions of the probes at (49 x 6, 2305 of 2432 keys, 64)
   (within 1e-2 of max|twin|);
2. runs ``segment_mosaic`` on a 1152^2 uint8 mosaic (window 384, stride 128,
   49 tiles) with ViT-S/8 at full width and random weights from a seed, in
   float32 and bfloat16: bf16-vs-f32 mask Dice > 0.99, kernel route vs plain
   route Dice >= 0.99 in both dtypes, and the launch counts of one call
   (11 attention, 10 LN-out MLP, 1 plain fused MLP);
2b. runs ``segment_mosaic`` with DINOv2 ViT-g/14 with registers at full
   width (random weights from a seed) on a 1512^2 mosaic (window 504,
   stride 168, 49 tiles) in bf16: the launches of one call (39 attention,
   39 gates, 78 LayerScale residuals), ms per mosaic and peak memory;
3. serves three mosaics from a directory through the port's
   ``sw_processing.main`` and checks the written masks;
4. trains the SimMIM ViT (width 384, depth 4, 3 heads of 128, patch 8) at
   full width on 16 synthetic 384^2 images, in float32 and in AMP bf16: the
   first step's loss, grad norm and gradients against the plain route, the
   launches of one step (4 of each training kernel), ms/step, images/s and
   peak device memory;
4b. the same step on each opt-in kernel route (TRAIN.LN_QKV kernel,
   TRAIN.ATTN_SAVE_P on, TRAIN.MLP_REMAT kernel+gp, and all three at once),
   f32 and AMP bf16: the first step's loss and grad norm against the plain
   route, the loss against phase 4's default route, 4 launches of each of
   the route's kernels, ms/step, images/s, peak memory, the loss after 14
   steps; then the same on the MLP remat routes (TRAIN.MLP_REMAT none, gelu
   and gelu+ln: the plain MLP around the attention kernels, which launch 4
   times each), and their peak memories side by side;
5. runs the MIM CLI ``mim.main`` on 32 synthetic PNGs for 2 epochs, then
   for 3 into the same output, which must resume at epoch 2 with the
   optimizer state; then one epoch with the three opt-in routes in
   ``--opts``, on their kernels; one epoch with ``--eval_dataset_path`` (phase
   10's labeled set), ``--wandb 1`` and ``--roi_masking True`` (the eval
   metrics in the log, the W&B scalars and six mask panels on disk); one
   epoch with ``DATA.DEVICE_AUG True``; and the seconds a batch of the host
   loader and of the device loader;
6. runs ``segment_mosaic_streamed`` (the gigapixel path) with ViT-S/8 at
   full width: (a) on an 8192^2 synthetic OCM-like mosaic in bf16 (3844
   tiles in 62 bands) against ``segment_mosaic``, mask agreement >= 0.999,
   the launch counts of one streamed call (11 attention, 10 LN-out MLP and
   1 plain MLP a band, 1 histogram), ms per mosaic, MP/s and ms/tile by
   CUDA events and peak device memory; (b) on phase 2's noise mosaic at
   2048^2 (196 tiles in 14 bands) in f32 and bf16: band_chunk 1 and 4
   bit-equal; kernel route vs plain route mask Dice >= 0.99 (f32: weight
   seed 0; bf16: the masks of weight seeds 0-3 pooled) and bf16 vs f32
   Dice > 0.99 (seeds 0-3 pooled);
7. serves three 1152^2 mosaics through ``sw_processing.main --streamed 1
   --save all --writers 2``: each artifact equals the pipeline's output for
   the decoded image, byte for byte; then one 8192^2 mosaic in single-image
   mode with ``--streamed auto``, which must take the streamed route;
8. runs the int8 serving route (``--quant int8``) on phase 2's mosaic,
   f32 and bf16, ``--infer_mlp auto`` and ``none``: the launches of one call
   (22 or 44 int8_dot and as many of its row quantizer, 11 attention, 10
   LN-out MLP with auto), int8 vs the
   unquantized f32 mask (weight seeds 0-3 pooled) and int8 kernel vs plain
   route (f32: seed 0; bf16: seeds 0-3 pooled), Dice > 0.99 and >= 0.99 in
   f32, 0.98 in bf16, where the route sits on bf16's own noise floor
   against f32 (printed beside it), ms per
   mosaic beside the unquantized route, a 2048^2 streamed int8 mosaic
   against the fused one (>= 0.999 of pixels), and three mosaics served with
   ``--quant int8 --infer_mlp none``, masks equal to the pipeline's;
9. runs each probe CLI once through ``python -m`` (3 timing iterations):
   probe_dot in its four modes, bench_attention_variants and bench_attn_opt
   with every mode and variant; each exits 0 and its lines parse;
10. runs the labeled eval path with ViT-S/8 at full width: (a) the analysis
   API (``forward_features``, ``get_intermediate_layers(n=4)``,
   ``get_last_selfattention``, ``last_block_key_features``) on a seeded
   384^2 image, kernel route against the plain route within 1e-5 of
   max|plain| in f32; in bf16 each route against the f32 plain route, the
   kernel route's error at most 1.5 times the plain bf16 route's; the
   launches of one
   ``get_intermediate_layers(n=4)`` call (12 attention, 7 LN-out MLP, 5
   plain MLP); (b) the eval CLI ``eval.main`` on 16 labeled 384^2 PNGs cut
   from the synthetic OCM mosaic: every method at crop 1, ours at crop 4
   and 16, ``--median_filter 3``, ``--batch_size 8`` (metrics within 1e-5 of
   batch 1), ``--bf16 1`` and ``--quant int8``; every metric finite and in
   [0, 1], each kernel of the path launched, kernel vs plain route per-image
   mask Dice >= 0.99 on the threshold methods in f32, bf16 vs f32 pooled
   Dice on ours at most 0.01 below the plain route's own; images/s of a batch of 8 through the batched step
   in bf16 and f32 (CUDA events), its launches and peak device memory;
11. runs the attention-analysis CLI ``analyse_attention.main`` with ViT-S/8
   at full width on a seeded 384^2 PNG of the synthetic OCM mosaic, in f32
   and bf16: ``--save_feature --region_query True --query_analysis True
   --save_query True`` (every output file, the launches of its four ViT
   calls), ``--crop 4`` (one call on 4 tiles), ``--quant int8`` (the int8
   GEMM and its quantizer 22 times each); the kernel route's masks against
   the plain route's (Dice >= 0.99 in f32); seconds an image by the host
   clock and by CUDA events;
12. runs the supervised flows at their CLIs' defaults: the finetune step
   (ViT-S/8 at depth 12, 384^2, batch 3, the 2-layer decoder, f32), its
   first loss on the kernel route against the plain route (rtol 1e-5) and
   its gradients against a float64 plain route, tensor by tensor at each
   one's own scale: the encoder's from the float64 step's gradient at the
   encoder's output (at most 1e-5 or FT_GRAD_RATIO times the f32 plain
   route's distance), the decoder's from the whole step (1e-4 or
   FT_GRAD_RATIO times), with the decoder's ReLU gates that rounding flips
   against float64 counted; the launches of a step (12 of rows 5,
   6, 3h and 8), of an eval forward (12 / 11 / 1 of rows 1-3) and of a PGT
   teacher batch (11 / 10 / 1), the teacher's masks against the plain
   route's (Dice >= 0.99), ms a step by CUDA events and peak memory of the
   finetune, UNet (512^2, batch 8) and PGT steps; then ``finetune``,
   ``unet`` and ``pgt`` through ``python -m`` at once on 202 synthetic
   labeled 512^2 PNGs for one or two epochs (every split non-empty): each
   exits 0, saves its best model, writes a triptych a test image and prints
   metrics in [0, 1];
13. trains Swin-Tiny (224^2, batch 8, gradient accumulation 4) in f32 and
   AMP bf16: ms an optimizer step by CUDA events, peak memory, AMP logits
   against f32; runs ``allen_train --amp`` through ``python -m`` on a
   synthetic imagefolder (checkpoint, history.json); holds a DINO head over
   multi-crop ViT-S/8 CLS features and three LARS steps on the card against
   the CPU (within 1e-5);
14. runs the multi-device paths (parallel/): (a) ``torch.cuda.device_count()``
   ranks spawned on NCCL, one a card: the collectives on card tensors
   (all-reduce, all-gather, reduce-scatter, broadcast, and a ring of sends
   with two or more cards), then ``sw_processing --mesh 1`` on phase 3's
   three bf16 1152^2 mosaics, masks equal to phase 3's; (b) 2 ranks on
   cuda:0 over gloo, the collectives staged through host memory (NCCL
   refuses two ranks on one card): ``parallel.dryrun.dryrun_multichip`` at
   full width, ViT-S/8 on the 1152^2 mosaic in f32 and bf16 and the
   streamed 2048^2 mosaic, masks bit-equal to one rank's and attention
   within 5e-3, and the MIM step at phase 4's geometry with the dry run's
   ``> 0.5`` mask in f32 and AMP bf16 on DP, FSDP, PP (2 stages, 4
   microbatches) and data 1 x model 2 (the MIM ViT with 6 heads of 64 there;
   in f32 also with every masked L1 residual's sign taken from the one-rank
   step), each against the single-rank step on the card; each rank's launches of
   rows 1-3, 3h, 5, 6, 8 and 4 on each path (exact counts), the FSDP bytes at
   rest against one rank's. Two ranks on one card measure correctness, not
   scaling;
15. prints the per-kernel JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero, with no result line, when no CUDA device is available or
the port's package is missing.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

SIZE, WINDOW, STRIDE = 1152, 384, 128
TILES, TOKENS = 49, 2305  # (1152-384)/128+1 = 7 per axis; 48*48 patches + CLS
MIM_BATCH, MIM_SIZE = 16, 384  # mim.py defaults; 48*48 patches + CLS = TOKENS
# DINOv2 ViT-g/14 with registers on the g14reg_fused_1512 cell's mosaic: 7 x 7
# tiles of 504^2, 36*36 patches + CLS + 4 registers, width 1536, SwiGLU 4096
G14_SIZE, G14_WINDOW, G14_STRIDE, G14_TOKENS = 1512, 504, 168, 1301
G14_DIM, G14_HIDDEN = 1536, 4096
F32_TOL, BF16_TOL = 1e-5, 1e-2  # outputs: max|kernel - plain| / max|plain|
GRAD_TOL = {"f32": 1e-4, "bf16": 2e-2}  # gradients
LSE_TOL = {"f32": 1e-5, "bf16": 1e-3}  # f32 lse; in bf16 a one-ulp flip of a rounded P moves it
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them; HBM3.
# The histogram's one integer add a byte is counted at the f32 CUDA-core rate.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "u8": 67e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
CSRC = "vit_ocm_wmsegmentation_tpu_torch/csrc/"
FA = "vit_ocm_wmsegmentation_tpu/ops/flash_attention.py"
FM = "vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py"
TH = "vit_ocm_wmsegmentation_tpu/ops/threshold.py"
LN = "vit_ocm_wmsegmentation_tpu/ops/ln_linear.py"
PD, BAV, BAO = "tools/probe_dot.py", "tools/bench_attention_variants.py", "tools/bench_attn_opt.py"
QZ = "vit_ocm_wmsegmentation_tpu/ops/quant.py"
# wrapper -> (module, source file per storage dtype, TPU kernel it replaces)
KERNELS = {
    "attention_qkv": ("fa", {"f32": "attention_qkv.cu", "bf16": "attention_qkv_wgmma.cu"},
                      FA + ":468"),
    "fused_mlp_block_lnout": ("fm", {"f32": "fused_mlp.cu", "bf16": "fused_mlp_serve_wgmma.cu"},
                              FM + ":154"),
    "fused_mlp_block": ("fm", {"f32": "fused_mlp.cu", "bf16": "fused_mlp_serve_wgmma.cu"},
                        FM + ":123"),
    "flash_attention": ("fa", {"f32": "attention_qkv.cu", "bf16": "attention_qkv_wgmma.cu"},
                        FA + ":74"),
    "flash_attention_bwd": ("fa", {"f32": "attention_bwd.cu", "bf16": "attention_bwd_wgmma.cu"},
                            FA + ":297"),
    "fused_mlp_block_h1": ("fm", {"f32": "fused_mlp.cu", "bf16": "fused_mlp_wgmma.cu"},
                           FM + ":123"),
    "fused_mlp_bwd": ("fm", {"f32": "fused_mlp_bwd.cu", "bf16": "fused_mlp_bwd_wgmma.cu"},
                      FM + ":243"),
    "histogram_u8_kernel": ("th", {"u8": "histogram_u8.cu"}, TH + ":71"),
    "flash_attention_savep": ("fa", {"f32": "attention_savep.cu",
                                     "bf16": "attention_savep_wgmma.cu"}, FA + ":74"),
    "flash_attention_bwd_savep": ("fa", {"f32": "attention_savep.cu",
                                         "bf16": "attention_savep_bwd_wgmma.cu"}, FA + ":211"),
    "fused_mlp_block_gp": ("fm", {"f32": "fused_mlp.cu", "bf16": "fused_mlp_wgmma.cu"},
                           FM + ":123"),
    "fused_mlp_bwd_gp": ("fm", {"f32": "fused_mlp_bwd.cu", "bf16": "fused_mlp_bwd_wgmma.cu"},
                         FM + ":243"),
    "ln_linear": ("ln", {"f32": "ln_linear.cu", "bf16": "ln_linear_wgmma.cu"}, LN + ":30"),
    "ln_linear_bwd": ("ln", {"f32": "ln_linear.cu", "bf16": "ln_linear_bwd_wgmma.cu"}, LN + ":44"),
    "int8_dot": ("qz", {"int8": "matmul_wgmma.cu"}, PD + ":38"),
    "quantize_rows": ("qz", {"bf16": "quantize_rows.cu"}, QZ + ":54"),
    "probe_matmul": ("pr", {"bf16": "matmul_wgmma.cu", "int8": "matmul_wgmma.cu"}, PD + ":38"),
    "probe_attention": ("pr", {"bf16": "probe_attention_wgmma.cu",
                               "int8": "probe_attention_wgmma.cu"}, PD + ":72"),
    # the DINOv2 block's kernels: new in the port, no TPU kernel to replace
    "swiglu_gate": ("sw", {"f32": "swiglu.cu", "bf16": "swiglu.cu"}, None),
    "layerscale_norm": ("sw", {"f32": "swiglu.cu", "bf16": "swiglu.cu"}, None),
}
# the probe attention's functions -> the TPU kernel body each replaces
PROBE_REPLACES = {"dot": PD + ":72", "full": BAV + ":31", "bf16exp": BAV + ":31",
                  "noexp": BAV + ":31", "dotsonly": BAV + ":31", "v0": BAO + ":107",
                  "exp2": BAO + ":107", "nomax": BAO + ":120", "normbound": BAO + ":189",
                  "bf16sm": BAO + ":425", "combo": BAO + ":210", "qkvflat": BAO + ":269",
                  "qkvflat_pipe2": BAO + ":333", "qkvflat_pipe2b": BAO + ":333"}
PROJ_SHAPES = ((384, 1152), (384, 384), (384, 1536), (1536, 384))  # (K, N): qkv, proj, fc1, fc2
# --quant int8 on the 1152^2 mosaic: launches of one segment_mosaic call
INT8_LAUNCHES = {"auto": {"int8_dot": 22, "quantize_rows": 22, "attention_qkv": 11,
                          "fused_mlp_block_lnout": 10, "fused_mlp_block": 1},
                 "none": {"int8_dot": 44, "quantize_rows": 44, "attention_qkv": 11}}
PROBE_N, PROBE_NP, PROBE_GROUPS = 2305, 2432, 49 * 6  # tools/ probes' attention shape
MOSAIC_LAUNCHES = {"attention_qkv": 11, "fused_mlp_block_lnout": 10, "fused_mlp_block": 1}
# one 1512^2 g14 mosaic (49 tiles, one ViT call of 40 blocks): the first 39
# full (the last runs the CLS row alone, on no kernel), each with a gate and
# two LayerScale residuals
G14_LAUNCHES = {"attention_qkv": 39, "swiglu_gate": 39, "layerscale_norm": 78}
MIM_LAUNCHES = {"flash_attention": 4, "flash_attention_bwd": 4, "fused_mlp_block_h1": 4,
                "fused_mlp_bwd": 4}
# opt-in training route -> (models.vit.TrainRoutes fields, the kernels one
# step launches 4 times each, one a block)
_ATTN, _SAVEP = ("flash_attention", "flash_attention_bwd"), ("flash_attention_savep",
                                                              "flash_attention_bwd_savep")
_H1, _GP = ("fused_mlp_block_h1", "fused_mlp_bwd"), ("fused_mlp_block_gp", "fused_mlp_bwd_gp")
_LNQKV = ("ln_linear", "ln_linear_bwd")
MIM_ROUTES = {
    "LN_QKV kernel": ({"ln_qkv": True}, _LNQKV + _ATTN + _H1),
    "ATTN_SAVE_P on": ({"attn_save_p": True}, _SAVEP + _H1),
    "MLP_REMAT kernel+gp": ({"mlp_save_gp": True}, _ATTN + _GP),
    "all three": ({"ln_qkv": True, "attn_save_p": True, "mlp_save_gp": True}, _LNQKV + _SAVEP + _GP),
}
# the MLP remat routes: the plain MLP (cuBLAS products) around the default
# attention kernels, which launch 4 times each a step
REMAT_ROUTES = {f"MLP_REMAT {m}": ({"mlp": m}, _ATTN) for m in ("none", "gelu", "gelu+ln")}
ROUTE_OPTS = ["TRAIN.LN_QKV", "kernel", "TRAIN.ATTN_SAVE_P", "on", "TRAIN.MLP_REMAT", "kernel+gp"]
STREAM_SIZE, STREAM_BANDS = 8192, 62  # (8192-384)/128+1 = 62 tiles per axis: 3844 tiles
STREAM_LAUNCHES = {**{k: v * STREAM_BANDS for k, v in MOSAIC_LAUNCHES.items()},
                   "histogram_u8_kernel": 1}
BAND_SIZE = 2048  # 14 tiles per axis: 196 tiles in 14 bands
# phase 14 (b): each rank's launches on the dry run's paths (2 ranks): the
# mosaic's 49 tiles pad to 25 a rank, one chunk; each of the 14 bands of the
# 2048^2 mosaic gives a rank 7 tiles; the step's 4 blocks run on every rank
# (dp, FSDP) or 2 a stage for each of 4 microbatches (pp); tp takes the
# stock routes
MD_LAUNCHES = {"fused mosaic [f32]": MOSAIC_LAUNCHES, "fused mosaic [bf16]": MOSAIC_LAUNCHES,
               "streamed mosaic [f32]": {**{k: v * 14 for k, v in MOSAIC_LAUNCHES.items()},
                                         "histogram_u8_kernel": 1},
               **{f"{mode} [{tag}]": want for tag in ("f32", "bf16") for mode, want in (
                   ("dp", MIM_LAUNCHES), ("fsdp", MIM_LAUNCHES), ("dp x tp", {}),
                   ("pp", {k: 2 * v for k, v in MIM_LAUNCHES.items()}))}}
EVAL_N, EVAL_SIZE = 16, 384  # phase 10's labeled set: 48*48 patches + CLS = TOKENS
# one get_intermediate_layers(n=4) call: blocks 0-7 as one LN-out span, then
# each of the last 4 alone (LN1, attention, plain fused MLP)
INTERMEDIATE_LAUNCHES = {"attention_qkv": 12, "fused_mlp_block_lnout": 7, "fused_mlp_block": 5}
# bf16 analysis API: the kernel route's error against the f32 plain route
# over the plain bf16 route's (phase 10)
BF16_ROUTE_RATIO = 1.5
# bf16 vs f32 eval masks: the kernel route may lose this much Dice more than
# the plain route (bf16 routes that differ in summation order alone move
# masks by about 1 % with random weights)
EVAL_BF16_MARGIN = 0.01
# the kernels of the eval path (--quant int8 adds the int8 GEMM and its quantizer)
EVAL_PATH = ("attention_qkv", "fused_mlp_block_lnout", "fused_mlp_block", "int8_dot",
             "quantize_rows")
# phase 11: one analyse_single call with --save_feature, --region_query,
# --query_analysis runs the ViT 4 times (the CLS attention, the key features,
# the region queries, the query grid), each a mosaic call's launches on one
# image; --crop 4 once on 4 tiles; --quant int8 once, the int8 GEMM and its
# quantizer on each block's qkv and proj products
ANALYSIS_LAUNCHES = {"all": {k: 4 * v for k, v in MOSAIC_LAUNCHES.items()},
                     "crop 4": MOSAIC_LAUNCHES,
                     "int8": INT8_LAUNCHES["auto"]}
# (wrapper, dtype tag) -> (what, call): a PyTorch call timed beside a kernel
# as a control, not the same function (phase 1)
CONTROLS = {}
# phase 0: kernel (a part of its mangled name) -> (instances at least, SASS
# opcodes it must hold, opcodes it must not). The wgmma kernels
# (csrc/*_wgmma.cu) run warpgroup products (HGMMA) fed by TMA (UTMALDG) and
# no mma.sync (HMMA), the MLP's inference forward in its 4 instances (2
# widths x LN-out and plain) and its training forward in 4 (2 widths x h1
# and gp), the MLP backward's dx kernel in 4 (2 widths x 2 routes)
# and its weight kernel in 2, the saved-P forward in 2 (d 64 and 128), the
# LN -> qkv forward and the backward's dx and weight kernels in 2 each (D 192
# and 384), the GEMM of matmul_wgmma.cu in bf16 (HGMMA) and in its three int8 instances
# (IGMMA, and no IMMA: no mma.sync), the probe attention in its 14 bf16
# instances (HGMMA) and its int8 one (IGMMA), all with TMA loads; the f32
# attention kernels (attention_qkv.cu, both head dims and both layouts; the
# saved-P forward at both head dims, one pass or two; the dk/dv and dq
# kernels of attention_bwd.cu and attention_savep.cu) and the f32 MLP
# kernels (fused_mlp.cu: 2 widths x 4 modes; fused_mlp_bwd.cu: the dx kernel,
# 2 widths x 2 routes, and the weight kernel) and the f32 LN -> qkv kernels
# (ln_linear.cu: the forward and the dx kernel at both widths, the weight
# kernel) run exact f32 FFMA fed by cp.async (LDGSTS) and no tensor-core
# instruction, so no TF32. The histogram (histogram_u8.cu) loads by bulk
# copies (UBLKCP) and counts by shared-memory atomics (ATOMS).
_WGMMA = (1, ("HGMMA", "UTMALDG"), ("HMMA",))
_IGMMA = (3, ("IGMMA", "UTMALDG"), ("IMMA", "HMMA", "HGMMA"))
_FFMA = ("FFMA", "LDGSTS"), ("HMMA", "HGMMA", "IMMA", "IGMMA", "QGMMA", "BMMA", "DMMA")
SASS_CHECKS = {
    "attention_wgmma_kernel": _WGMMA, "fused_mlp_wgmma_kernel": (4, *_WGMMA[1:]),
    "fused_mlp_serve_wgmma_kernel": (4, *_WGMMA[1:]),
    "mlp_bwd_dx_wgmma_kernel": (4, *_WGMMA[1:]), "mlp_bwd_w_wgmma_kernel": (2, *_WGMMA[1:]),
    "attn_bwd_dkdv_wgmma_kernel": _WGMMA, "attn_bwd_dq_wgmma_kernel": _WGMMA,
    "attn_bwd_savep_dkdv_wgmma_kernel": _WGMMA, "attn_bwd_savep_dq_wgmma_kernel": _WGMMA,
    "attn_fwd_savep_wgmma_kernel": (2, *_WGMMA[1:]), "ln_bwd_dx_wgmma_kernel": (2, *_WGMMA[1:]),
    "ln_bwd_w_wgmma_kernel": (2, *_WGMMA[1:]), "ln_linear_fwd_wgmma_kernel": (2, *_WGMMA[1:]),
    "histogram_u8_kernel": (1, ("UBLKCP", "ATOMS"), ()),
    "attention_f32_kernel": (4, *_FFMA), "attn_bwd_dkdv_f32_kernel": (2, *_FFMA),
    "attn_bwd_dq_f32_kernel": (2, *_FFMA), "attn_bwd_savep_dkdv_kernel": (2, *_FFMA),
    "attn_bwd_savep_dq_kernel": (2, *_FFMA), "fused_mlp_kernel": (8, *_FFMA),
    "mlp_bwd_dx_kernel": (4, *_FFMA), "mlp_bwd_w_kernel": (1, *_FFMA),
    "attn_fwd_savep_kernel": (4, *_FFMA), "ln_linear_fwd_kernel": (2, *_FFMA),
    "ln_linear_bwd_dx_kernel": (2, *_FFMA), "ln_linear_bwd_w_kernel": (1, *_FFMA),
    "matmul_wgmma_kernelIa": _IGMMA,
    "matmul_wgmma_kernelI13__nv_bfloat16": (1, ("HGMMA", "UTMALDG"), ("HMMA", "IMMA", "IGMMA")),
    "probe_attention_wgmma_kernelI13__nv_bfloat16": (14, ("HGMMA", "UTMALDG"),
                                                     ("HMMA", "IMMA", "IGMMA")),
    "probe_attention_wgmma_kernelIa": (1, *_IGMMA[1:]),
}


def _names_kernel(key, fn):
    """Whether the mangled name fn is of the kernel `key` (a prefix of its
    name and template arguments): the key starts right after the name's
    length digits, so "attention_wgmma_kernel" is not found in
    "probe_attention_wgmma_kernel"."""
    return re.search(rf"(?<![A-Za-z_]){re.escape(key)}", fn) is not None


def _modules():
    from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as fa
    from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as fm
    from vit_ocm_wmsegmentation_tpu_torch.ops import ln_linear as ln
    from vit_ocm_wmsegmentation_tpu_torch.ops import probes as pr
    from vit_ocm_wmsegmentation_tpu_torch.ops import quant as qz
    from vit_ocm_wmsegmentation_tpu_torch.ops import swiglu as sw
    from vit_ocm_wmsegmentation_tpu_torch.ops import threshold as th

    return {"fa": fa, "fm": fm, "ln": ln, "th": th, "qz": qz, "pr": pr, "sw": sw}


def launch_counts():
    mods = _modules()
    return {name: getattr(mods[m], name).launches for name, (m, _, _) in KERNELS.items()}


def reset_counts():
    mods = _modules()
    for name, (m, _, _) in KERNELS.items():
        getattr(mods[m], name).launches = 0
    for wrapper in (mods["qz"].quantize_rows, mods["qz"].int8_dot):
        wrapper.launches_by_shape.clear()


def dice(a, b):
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    return 2.0 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1)


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
    cases.update(_route_cases(tag, dtype, isz, tol, (q, k, v, do), (xm, dom, mlp), randn))
    return cases


def _close_twin(name, tag, got, want):
    """Within F32_TOL | BF16_TOL of max|twin|, and in bf16 at least 99 % of
    the outputs equal to the twin's: the kernel rounds once, as the twin
    does, so only a last-bit tie of f32 arithmetic may part them."""
    err = _compare(name, tag, got, want, F32_TOL if tag == "f32" else BF16_TOL)
    if tag == "bf16":
        same = float((got == want).float().mean())
        print(f"  {name}[{tag}]: {same:.5f} of the outputs equal to the twin's (gate 0.99)")
        if not same >= 0.99:
            raise AssertionError(f"{name}[{tag}]: {same:.5f} of the outputs equal to the twin's")
    return err


def _dinov2_cases(tag, dtype, gen):
    """The DINOv2 block's two kernels (csrc/swiglu.cu) at the g14 mosaic's
    49 * 1301 rows, as _kernel_cases: the gate on (rows, 2 * 4096), with
    the --infer_mlp none route's ``F.silu(a) * b`` as the library; the
    LayerScale residual with the next LayerNorm on rows x 1536, its sum
    bit-equal to the twin's, with ``x + y * gamma`` and ``F.layer_norm`` as
    the library. Bytes: the gate reads 2H and writes H a row, the residual
    reads x and y and writes the sum and the norm."""
    import torch
    import torch.nn.functional as F

    sw = _modules()["sw"]
    dev = torch.device("cuda")
    isz = torch.finfo(dtype).bits // 8
    rows, d, h = TILES * G14_TOKENS, G14_DIM, G14_HIDDEN

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x12 = (randn(rows, 2 * h) * 3).to(dtype)
    a, b = x12.chunk(2, dim=-1)
    x, y = randn(rows, d).to(dtype), (randn(rows, d) * 4).to(dtype)
    gamma = (torch.rand(d, generator=gen, device=dev) * 0.9 + 0.1).to(dtype)
    scale, bias = 1 + 0.1 * randn(d), 0.1 * randn(d)
    lib_ln = (scale.to(dtype), bias.to(dtype))

    def lsnorm_library():
        out = x + y * gamma
        return out, F.layer_norm(out, (d,), *lib_ln, 1e-6)

    def check_lsnorm(g, w):
        _equal(f"layerscale_norm[{tag}] sum", g[0], w[0])
        return _close_twin("layerscale_norm", tag, g[1], w[1])

    return {
        "swiglu_gate": (
            lambda: sw.swiglu_gate(x12), lambda: sw.swiglu_gate_plain(x12),
            lambda g, w: _close_twin("swiglu_gate", tag, g, w), lambda: F.silu(a) * b,
            5 * rows * h, 3 * rows * h * isz),
        "layerscale_norm": (
            lambda: sw.layerscale_norm(x, y, gamma, scale, bias, 1e-6),
            lambda: sw.layerscale_norm_plain(x, y, gamma, scale, bias, 1e-6), check_lsnorm,
            lsnorm_library, 10 * rows * d, 4 * rows * d * isz + 3 * d * 4),
    }


def phase_finetune_kernels(gen):
    """The finetune step's training kernels (phase 12) against their plain
    twins at that step's own shapes, f32: the attention forward and backward
    at (3 images x 6 heads, 2305 tokens, head dim 64), the head-dim-64
    template instances the MIM step (head dim 128) does not run, and the MLP
    block's h1 forward and backward at 3 x 2305 rows. Rows of the kernels
    line without their launches, which phase 12 counts."""
    import torch
    import torch.nn.functional as F

    fa, fm = _modules()["fa"], _modules()["fm"]
    dev = torch.device("cuda")

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * std + mean

    b, heads, n, hd, dm, hid = FT_BATCH, 6, TOKENS, 64, 384, 1536
    bh, rows, isz = b * heads, b * TOKENS, 4
    q, k, v, do = (randn(bh, n, hd) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()

    def check_fwd(g, w):
        err = _compare("flash_attention (finetune)", "f32", g[0], w[0], F32_TOL)
        _compare("flash_attention lse (finetune)", "f32", g[1], w[1], LSE_TOL["f32"])
        return err

    sdpa_in = [t.unflatten(0, (b, heads)).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in)
    x, dx = randn(rows, dm), randn(rows, dm)
    mlp = (randn(dm, std=0.1, mean=1.0), randn(dm, std=0.1), randn(hid, dm, std=dm ** -0.5),
           randn(hid, std=0.1), randn(dm, hid, std=hid ** -0.5), randn(dm, std=0.1))
    _, h1 = fm.fused_mlp_block_h1(x, *mlp)
    s, bb, w1, _, w2, _ = mlp
    w_bytes = 2 * dm * hid * isz
    cases = {
        "flash_attention": (
            lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
            check_fwd, lambda: F.scaled_dot_product_attention(*sdpa_in),
            4 * bh * n * n * hd, 4 * bh * n * hd * isz + bh * n * 4),
        "flash_attention_bwd": (
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do),
            lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do),
            lambda g, w: _compare("flash_attention_bwd (finetune)", "f32", g, w, GRAD_TOL["f32"]),
            lambda: torch.autograd.grad(sdpa_out, sdpa_in, do.unflatten(0, (b, heads)),
                                        retain_graph=True),
            10 * bh * n * n * hd, 8 * bh * n * hd * isz + bh * n * 4),
        "fused_mlp_block_h1": (
            lambda: fm.fused_mlp_block_h1(x, *mlp),
            lambda: fm.fused_mlp_block_plain(x, *mlp, want_h1=True),
            lambda g, w: _compare("fused_mlp_block_h1 (finetune)", "f32", g, w, F32_TOL), None,
            4 * rows * dm * hid, (2 * rows * dm + rows * hid) * isz + w_bytes),
        "fused_mlp_bwd": (
            lambda: fm.fused_mlp_bwd(x, dx, h1, s, bb, w1, w2),
            lambda: fm.fused_mlp_bwd_plain(x, dx, h1, s, bb, w1, w2),
            lambda g, w: _compare("fused_mlp_bwd (finetune)", "f32", g, w, GRAD_TOL["f32"]), None,
            8 * rows * dm * hid, (3 * rows * dm + rows * hid) * isz + w_bytes + 2 * dm * hid * 4),
    }
    result = []
    for name, case in cases.items():
        _, sources, replaces = KERNELS[name]
        result.append(_timed_row(f"{name}[f32 finetune]", sources["f32"], replaces, "f32", *case))
    torch.cuda.empty_cache()
    return result


def _route_cases(tag, dtype, isz, tol, attn, mlp_in, randn):
    """_kernel_cases' entries for the opt-in training routes' kernels, at
    the MIM step's shapes: the saved-P attention (P (48, 2305, 2368)), the
    MLP block's gp mode, LN -> qkv (36880 x 384 -> 1152)."""
    import torch
    import torch.nn.functional as F

    fa, fm, ln = (_modules()[m] for m in ("fa", "fm", "ln"))
    cases = {}
    q, k, v, do = attn
    bh, n, hd = q.shape
    out, p, inv = fa.flash_attention_savep(q, k, v)
    torch.cuda.synchronize()
    p_bytes = p.numel() * isz

    def check_savep(g, w):
        if bool(g[1][..., n:].any()):
            raise AssertionError("flash_attention_savep: P's padded columns are not 0")
        err = _compare("flash_attention_savep", tag, g[0], w[0], tol)
        _compare("flash_attention_savep P", tag, g[1], w[1], tol)
        _compare("flash_attention_savep inv", tag, g[2], w[2], LSE_TOL[tag])
        if not all(torch.equal(a, b) for a, b in zip(g, fa.flash_attention_savep(q, k, v))):
            raise AssertionError("flash_attention_savep: two calls give different bits")
        print(f"  flash_attention_savep[{tag}]: out, P, inv bit-equal across two calls")
        return err

    sdpa_in = [t.unflatten(0, (MIM_BATCH, 3)).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in)
    heads = [t.unflatten(0, (MIM_BATCH, 3)) for t in (q, k, v)]
    # the same function, O and P, in one call; SDPA (O alone) is a control
    math_attention = torch.ops.aten._scaled_dot_product_attention_math
    cases["flash_attention_savep"] = (
        lambda: fa.flash_attention_savep(q, k, v), lambda: fa.flash_attention_savep_plain(q, k, v),
        check_savep, lambda: math_attention(*heads, scale=hd ** -0.5),
        4 * bh * n * n * hd, 4 * bh * n * hd * isz + p_bytes + bh * n * 4)
    CONTROLS[("flash_attention_savep", tag)] = (
        "SDPA, a control (returns no P)", lambda: F.scaled_dot_product_attention(*heads))
    def check_bwd_savep(g, w):
        err = _compare("flash_attention_bwd_savep", tag, g, w, GRAD_TOL[tag])
        again = fa.flash_attention_bwd_savep(q, k, v, out, p, inv, do)
        if not all(torch.equal(a, b) for a, b in zip(g, again)):
            raise AssertionError("flash_attention_bwd_savep: two calls give different bits")
        print(f"  flash_attention_bwd_savep[{tag}]: dq, dk, dv bit-equal across two calls")
        return err

    cases["flash_attention_bwd_savep"] = (
        lambda: fa.flash_attention_bwd_savep(q, k, v, out, p, inv, do),
        lambda: fa.flash_attention_bwd_savep_plain(q, k, v, out, p, inv, do), check_bwd_savep,
        lambda: torch.autograd.grad(sdpa_out, sdpa_in, do.unflatten(0, (MIM_BATCH, 3)),
                                    retain_graph=True),
        8 * bh * n * n * hd, 8 * bh * n * hd * isz + p_bytes + bh * n * 4)

    xm, dom, mlp = mlp_in
    rows, dm = xm.shape
    hid = mlp[2].shape[0]
    s, bb, w1, _, w2, _ = mlp
    w_bytes = 2 * dm * hid * isz
    out_h1 = fm.fused_mlp_block_h1(xm, *mlp)[0]
    _, g, gp = fm.fused_mlp_block_gp(xm, *mlp)
    torch.cuda.synchronize()

    def check_gp(got, want):
        if not torch.equal(got[0], out_h1):
            raise AssertionError("fused_mlp_block_gp: out is not bit-equal to the h1 route's")
        print(f"  fused_mlp_block_gp[{tag}]: out bit-equal to fused_mlp_block_h1's")
        return _compare("fused_mlp_block_gp", tag, got, want, tol)

    cases["fused_mlp_block_gp"] = (
        lambda: fm.fused_mlp_block_gp(xm, *mlp), lambda: fm.fused_mlp_block_gp_plain(xm, *mlp),
        check_gp, None, 4 * rows * dm * hid, (2 * rows * dm + 2 * rows * hid) * isz + w_bytes)
    cases["fused_mlp_bwd_gp"] = (
        lambda: fm.fused_mlp_bwd_gp(xm, dom, g, gp, s, bb, w1, w2),
        lambda: fm.fused_mlp_bwd_gp_plain(xm, dom, g, gp, s, bb, w1, w2),
        lambda got, want: _compare("fused_mlp_bwd_gp", tag, got, want, GRAD_TOL[tag]), None,
        8 * rows * dm * hid,
        (3 * rows * dm + 2 * rows * hid) * isz + w_bytes + 2 * dm * hid * 4)

    kq = 3 * dm  # the qkv projection
    wq = randn(kq, dm, std=dm ** -0.5).to(dtype)
    bq = randn(kq, std=0.1)
    dy = randn(rows, kq).to(dtype)

    def check_ln_fwd(got, want):
        err = _compare("ln_linear", tag, got, want, tol)
        if not torch.equal(got, ln.ln_linear(xm, s, bb, wq, bq)):
            raise AssertionError("ln_linear: two calls give different bits")
        print(f"  ln_linear[{tag}]: y bit-equal across two calls")
        return err

    cases["ln_linear"] = (
        lambda: ln.ln_linear(xm, s, bb, wq, bq), lambda: ln.ln_linear_plain(xm, s, bb, wq, bq),
        check_ln_fwd, None,
        2 * rows * dm * kq, (rows * dm + rows * kq + kq * dm) * isz + (2 * dm + kq) * 4)

    def check_ln_bwd(got, want):
        err = _compare("ln_linear_bwd", tag, got, want, GRAD_TOL[tag])
        if not all(torch.equal(a, b) for a, b in zip(got, ln.ln_linear_bwd(xm, dy, s, bb, wq))):
            raise AssertionError("ln_linear_bwd: two calls give different bits")
        print(f"  ln_linear_bwd[{tag}]: dx, ds, dbb, dw, db bit-equal across two calls")
        return err

    cases["ln_linear_bwd"] = (
        lambda: ln.ln_linear_bwd(xm, dy, s, bb, wq),
        lambda: ln.ln_linear_bwd_plain(xm, dy, s, bb, wq), check_ln_bwd, None,
        4 * rows * dm * kq,
        (2 * rows * dm + rows * kq + kq * dm) * isz + (kq * dm + kq + 4 * dm) * 4)
    # cuBLAS on the products alone, from a precomputed LN(x): controls
    xn = F.layer_norm(xm.float(), (dm,), s, bb, 1e-6).to(dtype)
    bqc = bq.to(dtype)
    CONTROLS[("ln_linear", tag)] = ("cuBLAS F.linear(xn, w, b) alone, a control (not the same "
                                    "function)", lambda: F.linear(xn, wq, bqc))
    CONTROLS[("ln_linear_bwd", tag)] = ("cuBLAS dy @ w + dy.T @ xn alone, a control (not the "
                                        "same function)", lambda: (dy @ wq, dy.T @ xn))
    return cases


def check_kernel_builds():
    """Phase 0's report on the kernels of SASS_CHECKS: ptxas' registers,
    spills and shared memory, which must show no spill and no setmaxnreg
    that ptxas ignored (C7508: the warpgroups would keep the launch's
    registers), and their SASS (cuobjdump of the built library), which must
    hold the wanted opcodes and none of the forbidden ones, in as many
    instances as listed."""
    from vit_ocm_wmsegmentation_tpu_torch import build

    def kernel_of(fn):
        return next((k for k in SASS_CHECKS if _names_kernel(k, fn)), None)

    entry, reported = None, set()
    for line in build.build_info["ptxas"].splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?( |$)", line)
        if "C7508" in line:  # names its function, or falls in the entry's report
            named = re.search(r"function '(\S+?)'", line)
            fn = named.group(1) if named else entry
            if fn is None or kernel_of(fn):
                raise AssertionError(f"ptxas ignored a setmaxnreg of {fn or 'a kernel'}: "
                                     f"{line.strip()}")
        if m:
            entry = m.group(1) if kernel_of(m.group(1)) else None
        elif entry and ("Used" in line or "spill" in line):
            reported.add(entry)
            print(f"  ptxas {entry}: {line.strip().removeprefix('ptxas info    : ')}")
            if re.search(r"\b[1-9]\d* bytes spill", line):
                raise AssertionError(f"{entry} spills: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", build.build_info["path"]],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kern = kernel_of(name)
            fn = name if kern else None
            if fn:
                _, want, forbid = SASS_CHECKS[kern]
                counts[fn] = dict.fromkeys(want + forbid, 0)
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += bool(re.search(rf"\b{op}\b", line))
    for name, (instances, want, forbid) in SASS_CHECKS.items():
        found = {fn: c for fn, c in counts.items() if _names_kernel(name, fn)}
        in_ptxas = {fn for fn in reported if _names_kernel(name, fn)}
        if len(found) < instances or len(in_ptxas) < instances:
            raise AssertionError(f"{name}: {len(found)} instances in the SASS and {len(in_ptxas)} "
                                 f"in ptxas' report, want {instances}")
        for fn, c in found.items():
            print(f"  SASS {fn}: {c}")
            if not all(c[op] for op in want) or any(c[op] for op in forbid):
                raise AssertionError(f"{fn}: want {want} and none of {forbid} in its SASS, got {c}")


def _mlp_gemm_reference(tag, dtype, gen):
    """The MLP block's products alone through cuBLAS: F.linear fc1 and fc2 at
    the mosaic's rows and at the MIM step's, then the backward's four
    products at the MIM step's (dg = do W2, dxn = dh1 W1, dW1 = dh1^T xn,
    dW2 = do^T g): a GEMM-only reference for the fused kernels (not the same
    functions, so not their library_ms)."""
    import torch
    import torch.nn.functional as F

    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    dm, hid = 384, 1536
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    w1, w2 = rnd(hid, dm), rnd(dm, hid)
    for what, rows in (("mosaic", TILES * TOKENS), ("MIM step", MIM_BATCH * TOKENS)):
        x, g = rnd(rows, dm), rnd(rows, hid)  # also do and dh1 of the backward's products
        fc1, fc2 = cuda_ms(lambda: F.linear(x, w1)), cuda_ms(lambda: F.linear(g, w2))
        print(f"  MLP GEMMs alone [{tag}], {what}, {rows} x {dm} x {hid}: F.linear fc1 "
              f"{fc1:.3f} ms + fc2 {fc2:.3f} ms = {fc1 + fc2:.3f} ms (a reference, not the "
              f"fused function)")
    bwd = {"dg": lambda: x @ w2, "dxn": lambda: g @ w1, "dW1": lambda: g.T @ x,
           "dW2": lambda: x.T @ g}
    ms = {name: cuda_ms(fn) for name, fn in bwd.items()}
    print(f"  MLP backward GEMMs alone [{tag}], MIM step, {rows} rows: "
          + ", ".join(f"{name} {t:.3f}" for name, t in ms.items())
          + f" = {sum(ms.values()):.3f} ms (a reference, not the fused function)")


def phase_kernels():
    """Each kernel against its plain twin at its main path's shapes."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        _mlp_gemm_reference(tag, dtype, gen)
        for name, (kern, plain, check, library, flops, nbytes) in (
                (name, case) for cases in (_kernel_cases, _dinov2_cases)
                for name, case in cases(tag, dtype, gen).items()):
            got = kern()
            torch.cuda.synchronize()
            err = check(got, plain())
            del got
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain, iters=5, warmup=1)
            lib_ms = cuda_ms(library) if library is not None else None
            bound_ms, bound_by = bound(flops, nbytes, tag)
            lib = f", library {lib_ms:.3f} ms" if lib_ms is not None else ""
            if (name, tag) in CONTROLS:
                what, control = CONTROLS[(name, tag)]
                lib += f", {what} {cuda_ms(control):.3f} ms"
            print(f"  {name}[{tag}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, "
                  f"bound {bound_ms:.3f} ms ({bound_by})")
            results[(name, tag)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound_ms, "bound_by": bound_by,
                                    "library_ms": lib_ms}
        torch.cuda.empty_cache()
    results[("histogram_u8_kernel", "u8")] = _histogram_row(gen)
    torch.cuda.empty_cache()
    return results


def _histogram_row(gen):
    """The histogram kernel against its chunked twin, exactly: a 32768^2
    uint8 image (the 1.07 G-pixel blend image of the streamed path's size),
    a view of it 3 bytes in (not 16-byte aligned), 2^24 + 67 pixels of one
    value and five of another (past an f32 accumulator's 2^24), and two
    skewed buffers, 2^30 zeros and a 32768^2 image of ~90 % bin 0; timed on
    the first beside torch.bincount, and on the skewed two."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    th = _modules()["th"]
    dev = torch.device("cuda")
    n = 32768 * 32768
    x = torch.randint(0, 256, (32768, 32768), generator=gen, device=dev, dtype=torch.uint8)
    tail = torch.full(((1 << 24) + 67,), 7, dtype=torch.uint8, device=dev)
    tail[-5:] = 9
    # ~90 % bin 0: a 2^24-byte block 64 times, so that every count is a
    # multiple of 64 and exact in the f32 counts the wrapper returns
    tenth = torch.randint(0, 10, (1 << 24,), generator=gen, device=dev, dtype=torch.uint8)
    block = torch.where(tenth == 0, x.reshape(-1)[: 1 << 24], torch.zeros_like(tenth))
    skewed = {"zeros 2^30": torch.zeros(1 << 30, dtype=torch.uint8, device=dev),
              "90 % zeros 32768^2": block.repeat(64).reshape(32768, 32768)}
    del tenth, block
    for what, img in (("32768^2", x), ("32768^2 [3:]", x.reshape(-1)[3:]),
                      ("2^24 + 67", tail), *skewed.items()):
        got, want = th.histogram_u8_kernel(img), th.histogram_u8_chunked(img)
        torch.cuda.synchronize()
        print(f"  histogram_u8_kernel[u8] {what}: counts equal to the twin's: "
              f"{bool(torch.equal(got, want))}")
        if not torch.equal(got, want) or float(got.double().sum()) != img.numel():
            raise AssertionError(f"histogram_u8_kernel {what} differs from its plain twin")
    del tail
    flat = x.reshape(-1)
    ms = cuda_ms(lambda: th.histogram_u8_kernel(x))
    plain_ms = cuda_ms(lambda: th.histogram_u8_chunked(x), iters=5, warmup=1)
    lib_ms = cuda_ms(lambda: torch.bincount(flat, minlength=256))
    bound_ms, bound_by = bound(n, n + 256 * 8, "u8")
    print(f"  histogram_u8_kernel[u8]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.bincount "
          f"(uint8) {lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
    print("  histogram_u8_kernel[u8] skewed: " + ", ".join(
        f"{what} {cuda_ms(lambda: th.histogram_u8_kernel(img)):.3f} ms"
        for what, img in skewed.items()))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def phase_slice():
    """segment_mosaic at full width: dtype gate, route envelope, launches."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_route
    from vit_ocm_wmsegmentation_tpu_torch.sw_processing import load_model
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

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
    return launches, models


def phase_dinov2_mosaic():
    """segment_mosaic with DINOv2 ViT-g/14 with registers at full width (the
    port's init, drawn on the card) on a 1512^2 uint8 mosaic (window 504,
    stride 168, 49 tiles) in bf16 on the auto route: the launches of one
    call, counted from 0 just before it, the outputs' shapes and values, ms
    a mosaic and peak device memory. Returns the launches."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.models import vit
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    dev = torch.device("cuda")
    with torch.device(dev):
        model = vit.init(vit.ARCHS["dinov2_vitg14_reg"](), torch.Generator(dev).manual_seed(0))
    model = pl.cast_params(model, torch.bfloat16)
    routes = vit.infer_routes("auto", cfg=model.cfg)
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((G14_SIZE, G14_SIZE)) * 255).astype(np.uint8)).to(dev)

    def run():
        return pl.segment_mosaic(model, img, G14_WINDOW, G14_STRIDE, dtype=torch.bfloat16,
                                 routes=routes)

    run()  # warm-up (allocator, cuBLAS handles)
    torch.cuda.synchronize()
    reset_counts()
    mask, attn = run()
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"  g14 mosaic [bf16] launches: { {k: v for k, v in launches.items() if v} }")
    want = {name: G14_LAUNCHES.get(name, 0) for name in KERNELS}
    if launches != want:
        raise AssertionError(f"g14 launch counts {launches} != {want}")
    m, a = mask.cpu().numpy(), attn.float().cpu().numpy()
    if m.shape != (G14_SIZE, G14_SIZE) or a.shape != m.shape or not np.isfinite(a).all():
        raise AssertionError(f"g14: bad outputs {m.shape} {a.shape}")
    if not set(np.unique(m).tolist()) <= {0, 255}:
        raise AssertionError("g14: mask values outside {0, 255}")
    ms = cuda_ms(run, iters=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  g14 segment_mosaic [bf16]: {ms:.2f} ms/mosaic, "
          f"{G14_SIZE ** 2 / 1e6 / (ms / 1e3):.3f} MP/s, peak device memory {peak / 2**30:.3f} GiB")
    del model, mask, attn
    torch.cuda.empty_cache()
    return launches


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
        served = {}
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
            served[name] = mask
    print("  served masks equal segment_mosaic's")
    return served


def _write_served_mosaics(src):
    """Phase 3's three mosaics, as PNGs in ``src``."""
    from PIL import Image

    os.makedirs(src)
    for i in range(3):
        rng = np.random.default_rng(i + 1)
        Image.fromarray((rng.random((SIZE, SIZE)) * 255).astype(np.uint8)).save(
            os.path.join(src, f"mosaic{i}.png"))


def _nccl_rank(src, dst):
    """Phase 14 (a), on each NCCL rank: the collectives on card tensors,
    then the serving CLI with --mesh 1. Returns (collective results, masks,
    launches of the serving run)."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import sw_processing as sw
    from vit_ocm_wmsegmentation_tpu_torch.parallel import mesh as pm

    rank, world = pm.process_rank(), pm.world_size()
    dev = pm.rank_device()
    mesh = pm.make_mesh()
    res = {"device": str(dev), "backend": pm.backend(), "world": world}
    t = torch.full((4,), float(rank + 1), device=dev)
    res["all_reduce"] = pm.all_reduce(t.clone(), mesh, "data").cpu()
    res["all_gather"] = pm.all_gather(torch.full((2, 3), float(rank), device=dev), mesh,
                                      "data").cpu()
    res["reduce_scatter"] = pm.reduce_scatter(
        torch.arange(2.0 * world, device=dev) * (rank + 1), mesh, "data").cpu()
    res["broadcast"] = pm.broadcast(torch.full((3,), float(rank), device=dev), mesh, "data",
                                    world - 1).cpu()
    if world > 1:
        h = pm.send(torch.full((2,), float(rank), device=dev), mesh, "data", (rank + 1) % world)
        res["ring"] = pm.recv(torch.empty(2, device=dev), mesh, "data", (rank - 1) % world).cpu()
        h.wait()
    torch.cuda.synchronize()
    reset_counts()
    masks = sw.main(["--image_path", src, "--output_dir", dst, "--bf16", "1", "--save", "mask",
                     "--device", "cuda", "--mesh", "1"])
    torch.cuda.synchronize()
    return res, masks, {k: v for k, v in launch_counts().items() if v}


def phase_multi_device(served):
    """Phase 14: (a) NCCL, one rank a card; (b) the dry run on 2 gloo ranks
    sharing cuda:0."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.parallel import dryrun

    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        _write_served_mosaics(src)
        t0 = time.perf_counter()
        ranks = dryrun.spawn(_nccl_rank, n, src, dst, backend="nccl", threads=None,
                             timeout_s=600)
        print(f"  (a) {n} NCCL rank(s), one a card: {time.perf_counter() - t0:.1f} s "
              f"(host clock, process start included)")
        for rank, (res, masks, launches) in enumerate(ranks):
            w = res["world"]
            want = {"all_reduce": torch.full((4,), w * (w + 1) / 2),
                    "all_gather": torch.arange(float(w)).repeat_interleave(2)[:, None].expand(
                        2 * w, 3),
                    "reduce_scatter": torch.arange(2.0 * w)[2 * rank: 2 * rank + 2] * w * (w + 1)
                    / 2, "broadcast": torch.full((3,), float(w - 1))}
            if w > 1:
                want["ring"] = torch.full((2,), float((rank - 1) % w))
            for k, v in want.items():
                if not torch.equal(res[k], v):
                    raise AssertionError(f"NCCL rank {rank} {k}: {res[k]} != {v}")
            print(f"  rank {rank} on {res['device']}, backend {res['backend']}, world {w}: "
                  f"collectives on card tensors equal their sums; serving launches {launches}")
            want_launches = {k: 3 * v for k, v in MOSAIC_LAUNCHES.items()}
            if launches != want_launches:
                raise AssertionError(f"NCCL rank {rank} serving launches {launches} != "
                                     f"{want_launches}")
            if sorted(masks) != sorted(served):
                raise AssertionError(f"NCCL rank {rank} served {sorted(masks)}")
            for name, mask in masks.items():
                if not np.array_equal(mask, served[name]):
                    raise AssertionError(f"NCCL rank {rank}: {name}'s mask differs from phase 3's")
        print(f"  sw_processing --mesh 1 on {n} NCCL rank(s): the 3 masks equal phase 3's")
    t0 = time.perf_counter()
    reports = dryrun.dryrun_multichip(2, "gloo", "cuda:0", full=True, threads=None,
                                      timeout_s=900)
    print(f"  (b) dryrun_multichip on 2 gloo ranks sharing cuda:0: "
          f"{time.perf_counter() - t0:.1f} s (host clock, process start included)")
    for r in reports:
        for what, want in MD_LAUNCHES.items():
            got = {k: v for k, v in r["launches"][what].items() if v}
            if got != want:
                raise AssertionError(f"rank {r['rank']} {what}: launches {got} != {want}")
    single = reports[0]["bytes"]["single [f32]"]
    for what in ("fsdp [f32]", "fsdp [bf16]"):
        frac = reports[0]["bytes"][what] / single
        print(f"  FSDP bytes at rest on rank 0, {what}: {reports[0]['bytes'][what]} of one "
              f"rank's {single} ({frac:.4f})")
        if not frac < 0.55:
            raise AssertionError(f"FSDP {what}: rank 0 holds {frac:.4f} of one rank's bytes")
    print("  every rank launched each kernel of its paths the expected number of times")


def _streamed_call(model, img, dtype, **kw):
    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl

    return pl.segment_mosaic_streamed(model, img, WINDOW, STRIDE, dtype=dtype, **kw)


def phase_streamed(models):
    """segment_mosaic_streamed at full width: (a) 8192^2 bf16 against the
    fused path, with the launches of one call; (b) 2048^2 in f32 and bf16:
    band_chunk, kernel vs plain route, bf16 vs f32."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.data.synthetic import make_mosaic
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    dev = torch.device("cuda")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    img = torch.from_numpy(make_mosaic(STREAM_SIZE)).to(dev)
    tiles = STREAM_BANDS ** 2
    mp = STREAM_SIZE ** 2 / 1e6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    mask, attn = _streamed_call(models["bf16"], img, torch.bfloat16)
    end.record()
    end.synchronize()
    launches = launch_counts()
    first_ms, peak = start.elapsed_time(end), torch.cuda.max_memory_allocated()
    print(f"  streamed [bf16] {STREAM_SIZE}^2 launches: {launches}")
    want = {name: STREAM_LAUNCHES.get(name, 0) for name in KERNELS}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if (mask.shape != (STREAM_SIZE, STREAM_SIZE) or not bool(attn.isfinite().all())
            or not set(mask.unique().tolist()) <= {0, 255}):
        raise AssertionError("bad streamed outputs")
    torch.cuda.reset_peak_memory_stats()
    start.record()
    fmask, fattn = pl.segment_mosaic(models["bf16"], img, WINDOW, STRIDE, dtype=torch.bfloat16)
    end.record()
    end.synchronize()
    print(f"  segment_mosaic (fused) [bf16] {STREAM_SIZE}^2, for comparison: "
          f"{start.elapsed_time(end):.1f} ms, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    agree = float((fmask == mask).float().mean())
    print(f"  streamed vs fused [bf16] {STREAM_SIZE}^2: mask agreement {agree:.6f} (gate >= 0.999), "
          f"attention max|d| {float((fattn - attn).abs().max()):.3e} on the 0-255 scale")
    if not agree >= 0.999:
        raise AssertionError(f"streamed vs fused mask agreement {agree:.6f} < 0.999")
    del fmask, fattn
    ms = cuda_ms(lambda: _streamed_call(models["bf16"], img, torch.bfloat16), iters=1, warmup=0)
    for what, t in (("first call", first_ms), ("second call", ms)):
        print(f"  segment_mosaic_streamed [bf16] {STREAM_SIZE}^2, {what}: {t:.1f} ms/mosaic, "
              f"{mp / (t / 1e3):.3f} MP/s, {t / tiles:.4f} ms/tile (CUDA events)")
    print(f"  peak device memory, one streamed {STREAM_SIZE}^2 mosaic: {peak / 2**30:.3f} GiB")
    streamed_mask = mask.cpu().numpy()
    del img, mask, attn
    torch.cuda.empty_cache()

    # (b) on phase 2's noise mosaic, at 2048^2
    img = torch.from_numpy((np.random.default_rng(0).random((BAND_SIZE, BAND_SIZE)) * 255)
                           .astype(np.uint8)).to(dev)
    for tag, dtype in dtypes.items():
        m1, a1 = _streamed_call(models[tag], img, dtype, band_chunk=1)
        m4, a4 = _streamed_call(models[tag], img, dtype, band_chunk=4)
        equal = bool(torch.equal(m1, m4) and torch.equal(a1, a4))
        print(f"  {BAND_SIZE}^2 [{tag}] band_chunk 1 vs 4: canvas and mask bit-equal {equal}")
        if not equal:
            raise AssertionError(f"[{tag}] band_chunk changed the canvas or the mask")
    gates = _streamed_gates(models, img)
    for (tag, what), d in gates.items():
        print(f"  {BAND_SIZE}^2 {what} [{tag}]: mask Dice {d:.5f}")
    if not gates[("f32", "kernel vs plain route")] >= 0.99:
        raise AssertionError("f32 streamed kernel vs plain route Dice below 0.99")
    if not gates[("bf16, pooled", "kernel vs plain route")] >= 0.99:
        raise AssertionError("bf16 streamed kernel vs plain route Dice below 0.99")
    if not gates[("pooled", "bf16 vs f32")] > 0.99:
        raise AssertionError("streamed bf16 vs f32 Dice below the 0.99 gate")
    return launches, streamed_mask


def _streamed_gates(models, img, seeds=(0, 1, 2, 3)):
    """Mask Dice of the streamed path, kernel route vs plain route (every
    kernel wrapper and the histogram swapped for their twins) and bf16 vs
    f32, for random weights from each seed. With random weights the
    per-tile attention maps are nearly flat, so the bf16 readings of one
    seed scatter by about +-0.002 around 0.991 (PERF.md); the bf16 gates
    read the masks of all seeds pooled, f32 reads seed 0."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_route
    from vit_ocm_wmsegmentation_tpu_torch.sw_processing import load_model

    th = _modules()["th"]
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    def plain(model, dtype):
        reset_counts()
        with plain_route(), mock.patch.object(th, "histogram_u8_kernel", th.histogram_u8_chunked):
            mask = _streamed_call(model, img, dtype)[0].cpu().numpy()
        if any(launch_counts().values()):
            raise AssertionError("the plain route launched a kernel")
        return mask

    out, pooled = {}, {"k32": [], "k16": [], "p16": []}
    for seed in seeds:
        if seed:
            m32 = load_model("vit_small", 8, seed=seed, device=img.device)
            ms = {"f32": m32, "bf16": pl.cast_params(copy.deepcopy(m32), torch.bfloat16)}
        else:
            ms = models
        k = {tag: _streamed_call(ms[tag], img, dt)[0].cpu().numpy() for tag, dt in dtypes.items()}
        p16 = plain(ms["bf16"], torch.bfloat16)
        if not seed:
            out[("f32", "kernel vs plain route")] = dice(k["f32"], plain(ms["f32"], torch.float32))
        out[(f"bf16, weight seed {seed}", "kernel vs plain route")] = dice(k["bf16"], p16)
        out[(f"weight seed {seed}", "bf16 vs f32")] = dice(k["bf16"], k["f32"])
        for key, m in (("k32", k["f32"]), ("k16", k["bf16"]), ("p16", p16)):
            pooled[key].append(m)
    cat = {key: np.concatenate(v) for key, v in pooled.items()}
    out[("bf16, pooled", "kernel vs plain route")] = dice(cat["k16"], cat["p16"])
    out[("pooled", "bf16 vs f32")] = dice(cat["k16"], cat["k32"])
    return out


def phase_serving_streamed(model_bf16, streamed_mask):
    """The serving CLI on the streamed route with every artifact, and the
    8192^2 mosaic in single-image mode taking the streamed route by size."""
    import torch
    from PIL import Image

    from vit_ocm_wmsegmentation_tpu_torch import sw_processing as sw
    from vit_ocm_wmsegmentation_tpu_torch.data.synthetic import make_mosaic
    from vit_ocm_wmsegmentation_tpu_torch.utils.imageio import VIRIDIS, attention_lut_index

    th = _modules()["th"]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        for i in range(3):
            rng = np.random.default_rng(i + 11)
            Image.fromarray((rng.random((SIZE, SIZE)) * 255).astype(np.uint8)).save(
                os.path.join(src, f"mosaic{i}.png"))
        t0 = time.perf_counter()
        masks = sw.main(["--image_path", src, "--output_dir", dst, "--bf16", "1", "--streamed", "1",
                         "--save", "all", "--writers", "2", "--device", "cuda"])
        print(f"  served 3 mosaics, streamed, every artifact, in {time.perf_counter() - t0:.2f} s "
              f"(host clock)")
        if sorted(masks) != [f"mosaic{i}" for i in range(3)]:
            raise AssertionError(f"served {sorted(masks)}")
        for name, mask in masks.items():
            read = lambda f: np.asarray(Image.open(os.path.join(dst, name, f)))  # noqa: E731
            gray = torch.from_numpy(sw.decode(os.path.join(src, name + ".png"), (SIZE, SIZE))).cuda()
            want, attn = _streamed_call(model_bf16, gray, torch.bfloat16)
            _, _, heat = th.threshold_multiplicative(gray, attn)
            idx = attention_lut_index(attn).cpu().numpy()
            checks = {"otsu_sw.jpg": want.cpu().numpy(), "otsu_sw_heatmap.jpg": heat.cpu().numpy(),
                      "attention_map_sw.jpg": VIRIDIS[idx]}
            for fname, arr in checks.items():
                if not np.array_equal(read(fname), arr):
                    raise AssertionError(f"{name}/{fname} differs from the pipeline's output")
            if not np.array_equal(mask, checks["otsu_sw.jpg"]):
                raise AssertionError(f"{name}: returned mask differs from the pipeline's")
        print("  served artifacts equal the pipeline's outputs byte for byte")

        big = os.path.join(tmp, "big.png")
        Image.fromarray(make_mosaic(STREAM_SIZE)).save(big, compress_level=1)
        reset_counts()
        t0 = time.perf_counter()
        mask = sw.main(["--image_path", big, "--output_dir", os.path.join(tmp, "big"),
                        "--image_size", str(STREAM_SIZE), "--bf16", "1", "--streamed", "auto",
                        "--device", "cuda"])[""]
        hist = th.histogram_u8_kernel.launches
        print(f"  single {STREAM_SIZE}^2 mosaic, --streamed auto: {time.perf_counter() - t0:.2f} s "
              f"(host clock, decode and three PNGs included), histogram launches {hist}")
        if hist != 1:
            raise AssertionError(f"--streamed auto at {STREAM_SIZE}^2 did not take the streamed route")
        if not np.array_equal(mask, streamed_mask):
            raise AssertionError("the served 8192^2 mask differs from segment_mosaic_streamed's")
        if len(os.listdir(os.path.join(tmp, "big"))) != 3:
            raise AssertionError("single-image mode did not write the three artifacts")
    print(f"  the single-image {STREAM_SIZE}^2 mask equals phase 6's streamed mask")


def _mim_cfg(amp):
    from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

    cfg = default_config()
    cfg.DATA.IMG_SIZE = MIM_SIZE
    cfg.AMP_OPT_LEVEL = "O1" if amp else ""
    return cfg


def _mim_grads(model, x, mask, amp, routes):
    """(loss, grad norm, gradients) of one MIM step's loss, no update."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.train.optim import global_norm

    if amp:
        live = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        loss, _, _ = torch.func.functional_call(model, live,
                                                (x.to(torch.bfloat16), mask, False, routes))
    else:
        loss, _, _ = model(x, mask, False, routes)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), float(global_norm(grads)), grads


def _mim_inputs():
    """16 synthetic 384^2 images, their masks and the seeded SimMIM model."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.data.synthetic import mim_batch
    from vit_ocm_wmsegmentation_tpu_torch.models import simmim

    dev = torch.device("cuda")
    x, mask = mim_batch(dev)
    vit_cfg = simmim.mim_vit_config(MIM_SIZE, 8)
    return x, mask, simmim.init(vit_cfg, torch.Generator().manual_seed(0), dev)


def _mim_route_run(what, tag, model0, x, mask, routes, launched, default_loss=None):
    """One route in one dtype: the first step against the plain route (and
    against the default route's loss), the launches of one step, then 13
    more steps timed. Returns (first loss, launch counts, ms/step, peak
    device memory in bytes)."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_training_route
    from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step
    from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    amp = tag == "bf16"
    loss, gnorm, grads = _mim_grads(model0, x, mask, amp, routes)
    with plain_training_route():
        ploss, pgnorm, pgrads = _mim_grads(model0, x, mask, amp, routes)
    rel = max(float((g - p).abs().max()) / max(float(p.abs().max()), 1e-30)
              for g, p in zip(grads, pgrads))
    del grads, pgrads
    tol = 1e-5 if tag == "f32" else 1e-2
    vs_default = "" if default_loss is None else f", default route {default_loss:.6f}"
    print(f"  {what} [{tag}] first step: loss {loss:.6f} (plain {ploss:.6f}{vs_default}), grad "
          f"norm {gnorm:.6f} (plain {pgnorm:.6f}), max relative gradient difference {rel:.3e}")
    if not (np.isfinite(loss) and abs(loss - ploss) <= tol * abs(ploss)
            and abs(gnorm - pgnorm) <= 10 * tol * abs(pgnorm)):
        raise AssertionError(f"{what} [{tag}] disagrees with the plain route")
    if default_loss is not None and not abs(loss - default_loss) <= tol * abs(default_loss):
        raise AssertionError(f"{what} [{tag}] loss {loss} disagrees with the default route's "
                             f"{default_loss}")

    model = copy.deepcopy(model0)
    step = make_train_step(model, Optimizer(_mim_cfg(amp), model, lambda t: 1e-4), amp=amp,
                           routes=routes)
    torch.cuda.synchronize()
    reset_counts()
    step(x, mask)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {name: 4 if name in launched else 0 for name in KERNELS}
    print(f"  {what} [{tag}] launches: { {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise AssertionError(f"{what} [{tag}] launch counts {counts} != {want}")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(x, mask), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    lsum = float(step(x, mask)[0])
    if not np.isfinite(lsum):
        raise AssertionError(f"{what} [{tag}] loss {lsum} after 14 steps")
    print(f"  {what} [{tag}]: {ms:.2f} ms/step, {MIM_BATCH / (ms / 1e3):.1f} images/s, "
          f"peak device memory {peak / 2**30:.3f} GiB, loss after 14 steps {lsum:.6f}")
    del model, step
    torch.cuda.empty_cache()
    return loss, counts, ms, peak


def phase_mim():
    """The MIM train step at full width, f32 and AMP bf16, default routes.
    Returns {tag: (first loss, launch counts, ms/step, peak bytes)}."""
    from vit_ocm_wmsegmentation_tpu_torch.models.vit import TrainRoutes

    x, mask, model0 = _mim_inputs()
    return {tag: _mim_route_run("MIM step", tag, model0, x, mask, TrainRoutes(), MIM_LAUNCHES)
            for tag in ("f32", "bf16")}


def phase_mim_routes(default):
    """The MIM train step on each opt-in kernel route and each MLP remat
    route, against the plain route and phase 4's default route; the remat
    routes' peak memories side by side. Returns {(route, tag): counts}."""
    from vit_ocm_wmsegmentation_tpu_torch.models.vit import TrainRoutes

    x, mask, model0 = _mim_inputs()
    launches, peaks = {}, {}
    for route, (fields, launched) in {**MIM_ROUTES, **REMAT_ROUTES}.items():
        for tag in ("f32", "bf16"):
            loss, launches[(route, tag)], ms, peaks[(route, tag)] = _mim_route_run(
                f"MIM step, {route}", tag, model0, x, mask, TrainRoutes(**fields), launched,
                default[tag][0])
            print(f"  MIM step, {route} [{tag}]: {ms / default[tag][2]:.3f}x the default route's "
                  f"{default[tag][2]:.2f} ms/step")
    for tag in ("f32", "bf16"):
        gib = [peaks[(r, tag)] / 2**30 for r in REMAT_ROUTES]
        order = "holds" if gib[0] >= gib[1] >= gib[2] else "does not hold"
        print(f"  MLP remat routes [{tag}] peak device memory, none / gelu / gelu+ln: "
              f"{gib[0]:.3f} / {gib[1]:.3f} / {gib[2]:.3f} GiB (default route "
              f"{default[tag][3] / 2**30:.3f}); none >= gelu >= gelu+ln {order}")
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

        reset_counts()
        t0 = time.perf_counter()
        _, hist = mim.main(args[:-4] + ["--output", os.path.join(tmp, "routes"), "--output_dir",
                                        os.path.join(tmp, "routes_log"), "--epochs", "1",
                                        "--opts", *ROUTE_OPTS])
        counts = {k: v for k, v in launch_counts().items() if v}
        print(f"  1 epoch with --opts {' '.join(ROUTE_OPTS)} in {time.perf_counter() - t0:.2f} s "
              f"(host clock), losses {hist}, launches {counts}")
        want = {name: 8 for name in MIM_ROUTES["all three"][1]}  # 4 blocks x 2 steps
        if len(hist) != 1 or not np.isfinite(hist).all() or counts != want:
            raise AssertionError(f"the routes' epoch: losses {hist}, launches {counts} != {want}")
        _mim_cli_remainders(src, args[:-4], tmp)


def _mim_cli_remainders(src, args, tmp):
    """One epoch with --eval_dataset_path (phase 10's labeled set), --wandb 1
    and --roi_masking True; one with DATA.DEVICE_AUG; the seconds a batch
    of the host loader and of the device loader."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import mim
    from vit_ocm_wmsegmentation_tpu_torch.data.datasets import (build_simmim_device_loader,
                                                                build_simmim_loader)

    ev_root, log_dir = os.path.join(tmp, "evalset"), os.path.join(tmp, "ev_log")
    _write_eval_set(ev_root)
    t0 = time.perf_counter()
    _, hist = mim.main(args + ["--output", os.path.join(tmp, "ev_out"), "--output_dir", log_dir,
                               "--epochs", "1", "--eval_dataset_path", ev_root, "--wandb", "1",
                               "--roi_masking", "True"])
    log = "".join(open(f).read() for f in glob.glob(os.path.join(log_dir, "*.txt")))
    scalars = [json.loads(line) for line in open(os.path.join(log_dir, "wandb_offline.jsonl"))]
    panels = sorted(f for f in os.listdir(os.path.join(log_dir, "wandb_images", "step0"))
                    if f.startswith("Masks_"))
    # the eval's scalars: a line an image (running averages), then the epoch's
    dice = [x["Dice"] for x in scalars if "Dice" in x]
    print(f"  1 epoch with --eval_dataset_path ({EVAL_N} labeled {EVAL_SIZE}^2 images), --wandb 1, "
          f"--roi_masking True in {time.perf_counter() - t0:.2f} s (host clock): losses {hist}, "
          f"eval Dice {dice[-1]:.5f}, {len(scalars)} W&B scalar lines, mask panels {panels}")
    if not (len(hist) == 1 and np.isfinite(hist).all() and log.count("Acc_average") == 1
            and len(dice) == EVAL_N + 1 and 0.0 <= dice[-1] <= 1.0 and len(panels) == 6
            and any("train_loss" in x for x in scalars)):
        raise AssertionError("the MIM CLI's eval / W&B / ROI run wrote the wrong outputs")

    reset_counts()
    t0 = time.perf_counter()
    _, hist = mim.main(args + ["--output", os.path.join(tmp, "da_out"), "--output_dir",
                               os.path.join(tmp, "da_log"), "--epochs", "1",
                               "--opts", "DATA.DEVICE_AUG", "True"])
    counts = {k: v for k, v in launch_counts().items() if v}
    print(f"  1 epoch with DATA.DEVICE_AUG True in {time.perf_counter() - t0:.2f} s (host "
          f"clock), losses {hist}, launches {counts}")
    want = {name: 2 * n for name, n in MIM_LAUNCHES.items()}  # 2 steps
    if len(hist) != 1 or not np.isfinite(hist).all() or counts != want:
        raise AssertionError(f"the DEVICE_AUG epoch: losses {hist}, launches {counts} != {want}")

    loaders = {"host": build_simmim_loader(src, MIM_BATCH, MIM_SIZE, 16, 8, 0.5, seed=0),
               "device": build_simmim_device_loader(src, MIM_BATCH, MIM_SIZE, 16, 8, 0.5, seed=0,
                                                    device="cuda")}
    for name, loader in loaders.items():
        for _ in loader.epoch(0):  # decode, cache and (device) upload once
            pass
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 0
        for epoch in (1, 2):
            for img, mask in loader.epoch(epoch):
                torch.as_tensor(img).to("cuda")
                torch.as_tensor(mask).to("cuda")
                n += 1
        torch.cuda.synchronize()
        print(f"  {name} loader: {(time.perf_counter() - t0) / n * 1e3:.2f} ms a batch of "
              f"{MIM_BATCH} {MIM_SIZE}^2 images on the card (host clock, {n} batches)")


def phase_analysis():
    """The attention-analysis CLI at full width (ViT-S/8, 384^2) in f32 and
    bf16: every mode's files and launches, the kernel route's masks against
    the plain route's, seconds an image."""
    import contextlib
    import io

    import torch
    from PIL import Image

    from vit_ocm_wmsegmentation_tpu_torch import analyse_attention as an
    from vit_ocm_wmsegmentation_tpu_torch.data.synthetic import eval_pieces
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_route

    gh = EVAL_SIZE // 8
    rate = 10  # --query_rate's default: a 4 x 4 grid of queries on 48 x 48 patches
    want_files = {"img.png", "attn-average.png", "result.png", "OTSU_th_average.png",
                  "OTSU_th_original.png", "weighted_iamge_attention.png",
                  "heatmap_otsu_attention.png", "temp.png", "YEN_th.png",
                  "attn-average-queried.png", "attn-average-queried-median.png",
                  "attn-average-queried-threshold/OTSU_th_average.png"}
    want_files |= {f"attn-head{j}.png" for j in range(6)}
    want_files |= {f"features/{f}.png" for f in range(1, 384)}
    want_files |= {f"analysis/attn-average-{i * gh * rate + j * rate}.png"
                   for i in range(gh // rate) for j in range(gh // rate)}
    masks = ("OTSU_th_average.png", "OTSU_th_original.png", "heatmap_otsu_attention.png",
             "attn-average-queried-threshold/OTSU_th_average.png")

    def files(root):
        return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs}

    def read(path):
        return np.asarray(Image.open(path).convert("L"))

    with tempfile.TemporaryDirectory() as tmp:
        img = os.path.join(tmp, "tile.png")
        Image.fromarray(eval_pieces(1, EVAL_SIZE, seed=1)[0][0]).save(img)
        base = ["--image_path", img, "--device", "cuda"]
        runs = {"all": ["--save_feature", "1", "--region_query", "True", "--query_analysis",
                        "True", "--save_query", "True"],
                "crop 4": ["--crop", "4"], "int8": ["--quant", "int8"]}
        failed = []
        for tag, flags in (("f32", []), ("bf16", ["--bf16", "1"])):
            for name, extra in runs.items():
                out = os.path.join(tmp, f"{tag}_{name.replace(' ', '')}")
                torch.cuda.synchronize()
                reset_counts()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                with contextlib.redirect_stdout(io.StringIO()):  # a line a file written
                    an.main(base + ["--output_dir", out] + flags + extra)
                end.record()
                end.synchronize()
                wall, ev_s = time.perf_counter() - t0, start.elapsed_time(end) / 1e3
                counts = {k: v for k, v in launch_counts().items() if v}
                got = files(os.path.join(out, "tile"))
                queries = sum(f.startswith("queries/") for f in got)
                print(f"  analyse_attention [{tag}] {' '.join(extra)}: {wall:.2f} s an image "
                      f"(host clock), {ev_s:.2f} s (CUDA events), {len(got)} files, "
                      f"{queries} region queries, launches {counts}")
                if counts != ANALYSIS_LAUNCHES[name]:
                    failed.append(f"launches [{tag}, {name}] {counts} != {ANALYSIS_LAUNCHES[name]}")
                if name == "all" and not (want_files <= got and queries >= 1):
                    failed.append(f"files [{tag}, all]: missing {sorted(want_files - got)[:5]}, "
                                  f"{queries} region queries")
                if name == "crop 4" and "croped_4/OTSU_th_average.png" not in got:
                    failed.append(f"files [{tag}, crop 4]")
        # the kernel route's masks against the plain route's, f32; bf16 against f32
        reset_counts()
        with plain_route(), contextlib.redirect_stdout(io.StringIO()):
            an.main(base + ["--output_dir", os.path.join(tmp, "plain")] + runs["all"][2:])
        if any(launch_counts().values()):
            failed.append("the plain route launched a kernel")
        for m in masks:
            d_plain = dice(read(os.path.join(tmp, "f32_all", "tile", m)),
                           read(os.path.join(tmp, "plain", "tile", m)))
            d_bf16 = dice(read(os.path.join(tmp, "bf16_all", "tile", m)),
                          read(os.path.join(tmp, "f32_all", "tile", m)))
            print(f"  {m}: kernel vs plain route [f32] Dice {d_plain:.5f} (gate >= 0.99), "
                  f"bf16 vs f32 Dice {d_bf16:.5f}")
            if not d_plain >= 0.99:
                failed.append(f"{m}: kernel vs plain Dice {d_plain:.5f}")
        if failed:
            raise AssertionError(f"analysis CLI gates failed: {failed}")


def _timed_row(name, source, replaces, tag, kern, plain, check, library, flops, nbytes,
               queued=False):
    """One kernel row: kernel against its twin, then kernel, twin and library
    times (CUDA events) beside the bound; with queued, also the kernel's time
    with calls queued back to back (for kernels short beside their call's
    host set-up)."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms, queued_ms

    got = kern()
    torch.cuda.synchronize()
    err = check(got, plain())
    del got
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain, iters=5, warmup=1)
    lib_ms = None
    if library is not None:
        try:  # a yardstick only: a library call that refuses these inputs reports null
            lib_ms = cuda_ms(library)
        except RuntimeError as e:
            print(f"  {name}: the library call failed ({str(e).splitlines()[0]}); library_ms null")
    bound_ms, bound_by = bound(flops, nbytes, tag)
    lib = f", library {lib_ms:.3f} ms" if lib_ms is not None else ""
    if queued:
        lib += f", kernel queued back to back {queued_ms(kern):.3f} ms"
    print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound {bound_ms:.3f} ms "
          f"({bound_by})")
    return {"name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def _equal(name, got, want):
    import torch

    if not (got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)):
        err = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"{name} is not bit-equal to its plain twin (max|d| {err:.3e})")
    print(f"  {name}: bit-equal to its plain twin")
    return 0.0


def _within_one_ulp(name, got, want):
    """Each bf16 output within one bf16 ulp of the twin's (int32 products
    are exact; only the last conversion may round apart)."""
    import torch

    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    err = float((g - w).abs().max())
    if not bool(((g - w).abs() <= ulp).all()):
        raise AssertionError(f"{name}: an output differs from its twin's by more than one bf16 ulp")
    print(f"  {name}: within one bf16 ulp of its plain twin (max|d| {err:.3e})")
    return err


def _matmul_rows(gen):
    """Row 11a: the tiled matmul at 2048^3 (bf16, int8); row 11a': int8_dot
    at the mosaic's four projection shapes (112945 rows, bf16 in and out)
    and its row quantizer alone at both widths it takes there (values and
    scales bit-equal to rowwise_int8's)."""
    import torch

    pr, qz = _modules()["pr"], _modules()["qz"]
    dev = torch.device("cuda")
    rows, m = {}, 2048
    for tag, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        if dtype == torch.int8:
            a = torch.randint(-3, 3, (m, m), generator=gen, device=dev, dtype=dtype)
            bt = torch.randint(-3, 3, (m, m), generator=gen, device=dev, dtype=dtype)
            check = lambda g, w: _equal("probe_matmul[int8]", g, w)  # noqa: E731
            b_km = bt.t()  # (K, N) column-major, cuBLAS's int8 layout
            library = lambda: torch._int_mm(a, b_km)  # noqa: E731
        else:
            a = (torch.randn(m, m, generator=gen, device=dev) * 0.1).to(dtype)
            bt = (torch.randn(m, m, generator=gen, device=dev) * 0.1).to(dtype)
            check = lambda g, w: _compare("probe_matmul", "bf16", g, w, BF16_TOL)  # noqa: E731
            library = lambda: torch.matmul(a, bt.t())  # noqa: E731
        isz = a.element_size()
        rows[f"probe_matmul[{tag}]"] = _timed_row(
            f"probe_matmul[{tag}]", "matmul_wgmma.cu", PD + ":38", tag,
            lambda: pr.probe_matmul(a, bt), lambda: pr.probe_matmul_plain(a, bt), check, library,
            2 * m ** 3, 3 * m * m * isz, queued=True)
    n_rows = TILES * TOKENS
    for k, n in PROJ_SHAPES:
        x = torch.randn(n_rows, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(n, k, generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        wq = qz.colwise_int8(w)
        name = f"int8_dot[{k}->{n}]"

        def library(x=x, wq=wq, bias=bias):
            xq, sx = qz.rowwise_int8(x)
            acc = torch._int_mm(xq, wq[0].t())
            return ((acc.float() * sx) * wq[1] + bias).to(torch.bfloat16)

        if f"quantize_rows[{k}]" not in rows:
            qname = f"quantize_rows[{k}]"
            rows[qname] = _timed_row(
                qname, "quantize_rows.cu", QZ + ":54", "f32", lambda x=x: qz.quantize_rows(x),
                lambda x=x: qz.rowwise_int8(x),
                lambda g, wnt, q=qname: max(_equal(q, g[0], wnt[0]),
                                            _equal(q + " scales", g[1], wnt[1])),
                None, n_rows * k, n_rows * k * 3 + n_rows * 4, queued=True)
        rows[name] = _timed_row(
            name, "matmul_wgmma.cu", PD + ":38", "int8",
            lambda x=x, wq=wq, bias=bias: qz.int8_dot(x, wq, bias, torch.bfloat16),
            lambda x=x, wq=wq, bias=bias: qz.int8_dot_plain(x, wq, bias, torch.bfloat16),
            lambda g, wnt, name=name: _equal(name, g, wnt), library,
            2 * n_rows * k * n, n_rows * k * 2 + n * k + n * 8 + n_rows * n * 2, queued=True)
        del x
    return rows


def _probe_inputs(function, gen, dtype=None):
    """probe_attention's keyword arguments at the tools/ probes' shapes, drawn
    on the card (the CLIs of phase 9 draw the originals' numpy inputs)."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.ops.probes import VARIANTS

    dev = torch.device("cuda")
    g, n, np_, d = PROBE_GROUPS, PROBE_N, PROBE_NP, 64

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    bias = torch.where(torch.arange(np_, device=dev) < n, 0.0, -1e30).float()
    if function == "dot":
        if dtype == torch.int8:
            ri = lambda *s: torch.randint(-100, 100, s, generator=gen, device=dev,  # noqa: E731
                                          dtype=torch.int8)
            q, kt, v = ri(g, np_, d), ri(g, d, np_), ri(g, np_, 2 * d)
        else:
            q, kt, v = rnd(g, np_, d), rnd(g, d, np_), rnd(g, np_, 2 * d)
        return {"q": q, "k": kt, "v": v, "bias": torch.zeros(np_, device=dev), "scale": 1 / 16}
    if function in ("full", "bf16exp", "noexp", "dotsonly"):  # folded as the original folds
        kt, v = rnd(g, d, np_), rnd(g, np_, d)
        kt[..., n:] = 0
        v[:, n:] = 0
        return {"q": rnd(g, n, d), "k": kt, "v": v, "bias": bias, "scale": d ** -0.5}
    scale = d ** -0.5 * (1.4426950408889634 if "exp2" in VARIANTS[function].exp else 1.0)
    layout = VARIANTS[function].layout
    if layout == "qkvflat":
        qkv = torch.randn(g // 6, np_, 3 * 6 * d, generator=gen, device=dev)
        qkv[..., :6 * d] *= scale
        return {"q": qkv.to(torch.bfloat16), "bias": bias, "heads": 6}
    q = rnd(g, 2312, d, scale=scale)
    if layout == "folded":
        return {"q": q, "k": rnd(g, np_, d), "v": rnd(g, np_, d), "bias": bias}
    ve = torch.zeros(g, np_, 2 * d, device=dev, dtype=torch.bfloat16)
    ve[..., :d] = rnd(g, np_, d)
    ve[..., d] = 1
    return {"q": q, "k": rnd(g, d, np_), "v": ve, "bias": bias}


def _probe_attention_rows(gen):
    """Rows 11b, 12, 13: probe attention, int8 and bf16 (probe_dot.attn),
    the four modes of row 12 and the nine functions of row 13, at
    (49 x 6, 2305 of 2432 keys, 64); SDPA on the 2305 valid keys is the
    library call of the softmax-normalized functions."""
    import torch
    import torch.nn.functional as F

    from vit_ocm_wmsegmentation_tpu_torch.ops.probes import VARIANTS

    pr = _modules()["pr"]
    g, n, d = PROBE_GROUPS, PROBE_N, 64
    sdpa_in = [torch.randn(g // 6, 6, n, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3)]
    sdpa = lambda: F.scaled_dot_product_attention(*sdpa_in, scale=d ** -0.5)  # noqa: E731
    flops = 4 * g * n * n * d
    rows = {}
    cases = [("dot", torch.int8), ("dot", torch.bfloat16)] + [(f, None) for f in VARIANTS
                                                              if f != "dot"]
    for function, dtype in cases:
        kw = _probe_inputs(function, gen, dtype)
        tag = "int8" if dtype == torch.int8 else "bf16"
        name = f"probe_attention[{function} {tag}]" if function == "dot" else \
            f"probe_attention[{function}]"
        if dtype == torch.int8:
            check = lambda got, want, name=name: _within_one_ulp(name, got, want)  # noqa: E731
        else:
            check = lambda got, want, name=name: _compare(name, "bf16", got, want,  # noqa: E731
                                                          BF16_TOL)
        normalized = VARIANTS[function].den in ("ones", "sum") and function != "dot"
        nbytes = sum(t.numel() * t.element_size() for t in kw.values()
                     if isinstance(t, torch.Tensor))
        nbytes += (kw["q"].numel() if function.startswith("qkvflat") else
                   kw["q"].shape[0] * kw["q"].shape[1] * d) * 2
        rows[name] = _timed_row(
            name, "probe_attention_wgmma.cu", PROBE_REPLACES[function], tag,
            lambda function=function, kw=kw: pr.probe_attention(function, **kw),
            lambda function=function, kw=kw: pr.probe_attention_plain(function, **kw), check,
            sdpa if normalized else None, flops, nbytes)
        del kw
        torch.cuda.empty_cache()
    return rows


def phase_probe_kernels():
    """The probe kernels against their twins at the tools/ probes' shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = _matmul_rows(gen)
    torch.cuda.empty_cache()
    rows.update(_probe_attention_rows(gen))
    return rows


def phase_int8_route(models):
    """The int8 serving route (--quant int8) at full width on phase 2's
    1152^2 mosaic: launches, mask gates over weight seeds 0-3, ms per mosaic
    beside the unquantized routes, the streamed path, the serving CLI.
    Returns the launches of int8_dot and its quantizer in one bf16
    --infer_mlp none call, by projection shape and row width."""
    import torch
    from PIL import Image

    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch import sw_processing as sw
    from vit_ocm_wmsegmentation_tpu_torch.models.vit import InferRoutes
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_route
    from vit_ocm_wmsegmentation_tpu_torch.sw_processing import load_model
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    qz = _modules()["qz"]
    dev = torch.device("cuda")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    int8 = {"auto": InferRoutes("lnout", "int8"), "none": InferRoutes("none", "int8")}
    full = {"auto": InferRoutes(), "none": InferRoutes("none")}
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((SIZE, SIZE)) * 255).astype(np.uint8)).to(dev)

    def run(model, tag, routes, im=img):
        return pl.segment_mosaic(model, im, WINDOW, STRIDE, dtype=dtypes[tag], routes=routes)

    for tag in dtypes:  # warm-up: the weights are quantized once per model here
        run(models[tag], tag, int8["none"])
    torch.cuda.synchronize()
    shapes = {}
    for tag in dtypes:
        for mlp, routes in int8.items():
            reset_counts()
            mask, attn = run(models[tag], tag, routes)
            torch.cuda.synchronize()
            counts = launch_counts()
            if (tag, mlp) == ("bf16", "none"):  # the wrappers' own counts by shape
                shapes = {f"{w.__name__}[{key}]": n for w in (qz.int8_dot, qz.quantize_rows)
                          for key, n in w.launches_by_shape.items()}
            want = {name: INT8_LAUNCHES[mlp].get(name, 0) for name in KERNELS}
            print(f"  int8 route [{tag}, --infer_mlp {mlp}] launches: "
                  f"{ {k: v for k, v in counts.items() if v} }")
            if counts != want:
                raise AssertionError(f"int8 route launch counts {counts} != {want}")
            if not bool(attn.isfinite().all()) or not set(mask.unique().tolist()) <= {0, 255}:
                raise AssertionError(f"int8 route [{tag}, {mlp}]: bad outputs")
    # each layer runs each projection once, one quantizer launch on its rows
    per = INT8_LAUNCHES["none"]["int8_dot"] // len(PROJ_SHAPES)
    want = {}
    for k, n in PROJ_SHAPES:
        want[f"int8_dot[{k}->{n}]"] = per
        want[f"quantize_rows[{k}]"] = want.get(f"quantize_rows[{k}]", 0) + per
    print(f"  int8 route [bf16, --infer_mlp none] launches by shape: {shapes}")
    if shapes != want:
        raise AssertionError(f"int8_dot and quantize_rows launches by shape {shapes} != {want}")

    # mask gates over weight seeds 0-3 (random weights sit at a noise floor)
    pooled = {}

    def keep(key, mask):
        pooled.setdefault(key, []).append(mask)
        return mask

    for seed in range(4):
        if seed:
            m32 = load_model("vit_small", 8, seed=seed, device=dev)
            ms_ = {"f32": m32, "bf16": pl.cast_params(copy.deepcopy(m32), torch.bfloat16)}
        else:
            ms_ = models
        ref = keep("f32", run(ms_["f32"], "f32", full["auto"])[0].cpu().numpy())
        keep("bf16", run(ms_["bf16"], "bf16", full["auto"])[0].cpu().numpy())
        for tag in dtypes:
            for mlp in int8:
                k = keep(("int8", tag, mlp), run(ms_[tag], tag, int8[mlp])[0].cpu().numpy())
                if tag == "bf16" or seed == 0:
                    reset_counts()
                    with plain_route():
                        p = keep(("plain", tag, mlp), run(ms_[tag], tag, int8[mlp])[0].cpu().numpy())
                    keep(("kernel", tag, mlp), k)
                    if any(launch_counts().values()):
                        raise AssertionError("the plain route launched a kernel")
                    print(f"  weight seed {seed} [{tag}, {mlp}]: int8 vs f32 mask Dice "
                          f"{dice(k, ref):.5f}, int8 kernel vs plain route {dice(k, p):.5f}")
        del ms_
    cat = {key: np.concatenate(v) for key, v in pooled.items()}
    floor = dice(cat["bf16"], cat["f32"])
    print(f"  unquantized bf16 vs f32 mask Dice {floor:.5f} (seeds 0-3 pooled): the bf16 noise "
          f"floor of random weights at this size")
    # the f32 readings isolate the int8 rounding and hold the 0.99 gates; in
    # bf16 the int8 route sits on the bf16 noise floor above (PERF.md), so
    # its readings are held to 0.98, which a broken route falls far below
    for tag in dtypes:
        for mlp in int8:
            d_ref = dice(cat[("int8", tag, mlp)], cat["f32"])
            d_plain = dice(cat[("kernel", tag, mlp)], cat[("plain", tag, mlp)])
            gate = 0.99 if tag == "f32" else 0.98
            what = "seeds 0-3 pooled" if tag == "bf16" else "seed 0"
            print(f"  int8 [{tag}, --infer_mlp {mlp}]: vs unquantized f32 mask Dice {d_ref:.5f} "
                  f"(seeds 0-3 pooled, gate > {gate}); kernel vs plain route {d_plain:.5f} "
                  f"({what}, gate >= {gate})")
            if not (d_ref > gate and d_plain >= gate):
                raise AssertionError(f"int8 [{tag}, {mlp}] mask gate failed")

    for tag in dtypes:
        for mlp in int8:
            t8 = cuda_ms(lambda: run(models[tag], tag, int8[mlp]), iters=5, warmup=1)
            tf = cuda_ms(lambda: run(models[tag], tag, full[mlp]), iters=5, warmup=1)
            print(f"  segment_mosaic [{tag}, --infer_mlp {mlp}]: --quant int8 {t8:.2f} ms/mosaic, "
                  f"unquantized {tf:.2f} ms/mosaic ({t8 / tf:.3f}x), CUDA events")

    big = torch.from_numpy((np.random.default_rng(0).random((BAND_SIZE, BAND_SIZE)) * 255)
                           .astype(np.uint8)).to(dev)
    smask, _ = _streamed_call(models["bf16"], big, torch.bfloat16, routes=int8["auto"])
    fmask, _ = run(models["bf16"], "bf16", int8["auto"], big)
    agree = float((smask == fmask).float().mean())
    print(f"  streamed vs fused int8 [bf16] {BAND_SIZE}^2: mask agreement {agree:.6f} "
          f"(gate >= 0.999)")
    if not agree >= 0.999:
        raise AssertionError(f"streamed vs fused int8 mask agreement {agree:.6f} < 0.999")

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        for i in range(3):
            Image.fromarray((np.random.default_rng(i + 21).random((SIZE, SIZE)) * 255)
                            .astype(np.uint8)).save(os.path.join(src, f"mosaic{i}.png"))
        t0 = time.perf_counter()
        masks = sw.main(["--image_path", src, "--output_dir", dst, "--bf16", "1", "--quant",
                         "int8", "--infer_mlp", "none", "--save", "mask", "--device", "cuda"])
        print(f"  served 3 mosaics with --quant int8 --infer_mlp none in "
              f"{time.perf_counter() - t0:.2f} s (host clock)")
        for name, mask in masks.items():
            gray = torch.from_numpy(sw.decode(os.path.join(src, name + ".png"),
                                              (SIZE, SIZE))).cuda()
            want, _ = run(models["bf16"], "bf16", int8["none"], gray)
            if not np.array_equal(want.cpu().numpy(), mask):
                raise AssertionError(f"{name}: served int8 mask differs from segment_mosaic's")
        if sorted(masks) != [f"mosaic{i}" for i in range(3)]:
            raise AssertionError(f"served {sorted(masks)}")
    print("  served int8 masks equal segment_mosaic's")
    return shapes


def _write_eval_set(root):
    """EVAL_N labeled EVAL_SIZE^2 PNGs: seeded pieces of the synthetic OCM
    mosaic of data.synthetic.make_mosaic, each across a corner of its grid
    of bright blobs, labeled by the rule that placed the blobs
    (data.synthetic.eval_pieces)."""
    from PIL import Image

    from vit_ocm_wmsegmentation_tpu_torch.data.synthetic import eval_pieces

    pieces, labels = eval_pieces(EVAL_N, EVAL_SIZE)
    for sub, arrays in (("images", pieces), ("labels", labels)):
        os.makedirs(os.path.join(root, sub))
        for i, a in enumerate(arrays):
            Image.fromarray(a).save(os.path.join(root, sub, f"{i:02d}.png"))


def _analysis_api(models):
    """(a) the ViT analysis API at full width on one seeded 384^2 image,
    kernel route against the plain route, and the launches of one
    get_intermediate_layers(n=4) call. f32: within F32_TOL of max|plain|.
    bf16: the two routes round differently in each of 12 blocks, so each is
    held against the f32 plain route, and the kernel route's error there may
    be at most BF16_ROUTE_RATIO times the plain bf16 route's own. Prints
    every reading before it fails."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.models import vit
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_route

    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.random((1, EVAL_SIZE, EVAL_SIZE, 3), dtype=np.float32)).cuda()
    funcs = {"forward_features": vit.forward_features,
             "get_intermediate_layers(n=4)": lambda m, x: vit.get_intermediate_layers(m, x, 4),
             "get_last_selfattention": vit.get_last_selfattention,
             "last_block_key_features": vit.last_block_key_features}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    failed = []
    with pl.exact_matmuls():
        for name, fn in funcs.items():
            got = {tag: fn(models[tag], x32.to(dtype)) for tag, dtype in dtypes.items()}
            with plain_route():
                want = {tag: fn(models[tag], x32.to(dtype)) for tag, dtype in dtypes.items()}
            err, rel, finite = _rel_err(got["f32"], want["f32"])
            print(f"  {name}[f32]: kernel vs plain route max|d| {err:.3e}, rel {rel:.3e} "
                  f"(tol {F32_TOL:g})")
            if not (finite and rel <= F32_TOL):
                failed.append(f"{name}[f32]")
            kp = _rel_err(got["bf16"], want["bf16"])[1]
            k32, kfin = _rel_err(got["bf16"], want["f32"])[1:]
            p32 = _rel_err(want["bf16"], want["f32"])[1]
            print(f"  {name}[bf16]: kernel vs plain route rel {kp:.3e}; against the f32 plain "
                  f"route: kernel rel {k32:.3e}, plain rel {p32:.3e} (gate: kernel <= "
                  f"{BF16_ROUTE_RATIO:g} x plain)")
            if not (kfin and k32 <= BF16_ROUTE_RATIO * p32):
                failed.append(f"{name}[bf16]")
        for tag, dtype in dtypes.items():
            vit.get_intermediate_layers(models[tag], x32.to(dtype), 4)
            torch.cuda.synchronize()
            reset_counts()
            vit.get_intermediate_layers(models[tag], x32.to(dtype), 4)
            torch.cuda.synchronize()
            launched = {k: v for k, v in launch_counts().items() if v}
            print(f"  get_intermediate_layers(n=4) [{tag}] launches: {launched}")
            if launched != INTERMEDIATE_LAUNCHES:
                failed.append(f"launches[{tag}]")
    if failed:
        raise AssertionError(f"analysis API gates failed: {failed}")


def phase_eval(models):
    """The labeled eval path at full width: (a) the analysis API; (b) the
    eval CLI on EVAL_N synthetic labeled 384^2 PNGs with every method at
    crop 1, ours at crop 4 and 16, --median_filter 3, --batch_size 8,
    --bf16 1 and --quant int8; the mask gates; images/s of batched ours."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch import eval as ev_cli
    from vit_ocm_wmsegmentation_tpu_torch import evaluation as ev
    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.data.datasets import build_eval_samples
    from vit_ocm_wmsegmentation_tpu_torch.models import vit
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_route
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    _analysis_api(models)
    validate = ev.validate
    record = {}

    def recording(*args, **kw):
        meters, masks = {}, []
        out = validate(*args, meters_out=meters, masks_out=masks, **kw)
        record["meters"], record["masks"] = {k: m.avg for k, m in meters.items()}, masks
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "set")
        _write_eval_set(root)

        def cli(*flags):
            t0 = time.perf_counter()
            with mock.patch.object(ev, "validate", recording):
                acc, f1, loss = ev_cli.main(["--eval_dataset_path", root, "--output_dir",
                                             os.path.join(tmp, "out"), *flags])
            m = record["meters"]
            print(f"  eval {' '.join(flags) or '--method ours'}: acc {acc:.5f} f1 {f1:.5f} "
                  f"Dice {1 - loss:.5f} jaccard {m['jaccard']:.5f} precision "
                  f"{m['precision']:.5f} recall {m['recall']:.5f}, "
                  f"{time.perf_counter() - t0:.1f} s (host clock)")
            vals = [m[k] for k in ("loss", "acc", "f1", "precision", "recall", "jaccard")]
            if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
                raise AssertionError(f"eval {flags}: a metric outside [0, 1]: {m}")
            if len(record["masks"]) != EVAL_N:
                raise AssertionError(f"eval {flags}: {len(record['masks'])} masks")
            return dict(m), record["masks"]

        reset_counts()
        runs = {meth: cli("--method", meth) for meth in ev.METHODS}
        for crop in ("4", "16"):
            cli("--crop", crop)
        cli("--median_filter", "3")
        batched = cli("--batch_size", "8")
        bf16 = cli("--bf16", "1")
        cli("--quant", "int8", "--batch_size", "8")
        torch.cuda.synchronize()
        launches = launch_counts()
        print(f"  eval runs' launches: { {k: v for k, v in launches.items() if v} }")
        for name in EVAL_PATH:
            if not launches[name]:
                raise AssertionError(f"{name} was not launched on the eval path")

        diff = max(abs(batched[0][k] - runs["ours"][0][k]) for k in batched[0] if k != "time")
        print(f"  --batch_size 8 vs 1 [ours]: max metric difference {diff:.3e} (gate <= 1e-5)")
        if not diff <= 1e-5:
            raise AssertionError(f"batched eval differs from per-image eval by {diff:.3e}")
        plain = {}
        for meth in ("ours", "otsu", "heatmap_threshold"):
            reset_counts()
            with plain_route():
                plain[meth] = cli("--method", meth)[1]
                if meth == "ours":
                    plain["bf16"] = cli("--bf16", "1")[1]
            if any(launch_counts().values()):
                raise AssertionError("the plain route launched a kernel")
            worst = min(dice(k, p) for k, p in zip(runs[meth][1], plain[meth]))
            print(f"  kernel vs plain route [{meth}, f32]: least per-image mask Dice {worst:.5f} "
                  f"(gate >= 0.99)")
            if not worst >= 0.99:
                raise AssertionError(f"[{meth}] kernel vs plain route Dice {worst:.5f} < 0.99")
        # bf16 against f32 on ours, pooled over the images, beside the plain
        # route's own bf16 against f32: the noise floor of bf16 with random
        # weights (the attention grid leaves the ViT rounded to bf16)
        cat = lambda masks: np.concatenate(masks)  # noqa: E731
        d16 = dice(cat(bf16[1]), cat(runs["ours"][1]))
        floor = dice(cat(plain["bf16"]), cat(plain["ours"]))
        print(f"  bf16 vs f32 [ours]: pooled mask Dice {d16:.5f} on the kernel route, {floor:.5f} "
              f"on the plain route (gate: kernel >= plain - {EVAL_BF16_MARGIN:g}); the fixed "
              f"0.98 reads {'met' if d16 >= 0.98 else 'not met'}")
        if not d16 >= floor - EVAL_BF16_MARGIN:
            raise AssertionError(f"bf16 vs f32 eval mask Dice {d16:.5f} below the plain route's "
                                 f"{floor:.5f} - {EVAL_BF16_MARGIN:g}")

        # images/s of the batched step (ViT, smoothing, thresholds, metrics)
        samples = build_eval_samples(root, EVAL_SIZE)[:8]
        grays = torch.from_numpy(np.stack([s.gray for s in samples])).cuda()
        targets = torch.from_numpy(np.stack([s.label for s in samples])).cuda()
        routes = vit.InferRoutes()
        for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            model = models[tag]

            def step():
                with torch.inference_mode(), pl.exact_matmuls():
                    return ev._batched_eval_step(model, grays, targets, "ours", 1, dtype, routes)

            step()
            torch.cuda.synchronize()
            reset_counts()
            step()
            torch.cuda.synchronize()
            one = {k: v for k, v in launch_counts().items() if v}
            if one != MOSAIC_LAUNCHES:  # one ViT call a batch, as one mosaic's
                raise AssertionError(f"one batch's launches {one} != {MOSAIC_LAUNCHES}")
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, iters=10, warmup=2)
            peak = torch.cuda.max_memory_allocated()
            print(f"  batched ours [{tag}], batch 8 of {EVAL_SIZE}^2: {ms:.2f} ms/batch, "
                  f"{8 / (ms / 1e3):.1f} images/s (CUDA events), launches of one batch {one}, "
                  f"peak device memory {peak / 2**30:.3f} GiB")


_PD_LINE = re.compile(r"^\s*([\d.]+) ms\s+.*?max\|d\| (\S+).*launches (\d+)")
_BAV_LINE = re.compile(r"^(\w+)\s+bq=\s*(\d+)\s+([\d.]+) ms .*max\|d\| (\S+)\s+launches (\d+)")


def phase_probe_clis():
    """Each probe CLI once through ``python -m`` (3 timing iterations):
    probe_dot in its four modes, the other two with every mode or variant.
    Returns their kernel launches by kernel-table row."""
    launches = {}
    runs = [("probe_dot", [m]) for m in ("mm_bf16", "mm_int8", "attn_int8", "attn_bf16")]
    runs += [("bench_attention_variants", []), ("bench_attn_opt", ["all"])]
    for mod, argv in runs:
        cmd = [sys.executable, "-m", f"vit_ocm_wmsegmentation_tpu_torch.tools.{mod}", *argv,
               "--iters", "3"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        print(f"  {' '.join(cmd[2:])}: exit {r.returncode}, {len(lines)} lines, "
              f"{time.perf_counter() - t0:.1f} s")
        for ln in lines:
            print(f"    {ln}")
        if r.returncode != 0:
            raise AssertionError(f"{mod} failed:\n{r.stderr[-3000:]}")
        if mod == "probe_dot":
            m = _PD_LINE.match(lines[-1])
            if m is None or len(lines) != 1:
                raise AssertionError(f"probe_dot {argv[0]}: unparsed output {lines}")
            kind, dt = argv[0].split("_")
            key = f"probe_matmul[{dt}]" if kind == "mm" else f"probe_attention[dot {dt}]"
            launches[key] = int(m.group(3))
        elif mod == "bench_attention_variants":
            parsed = [_BAV_LINE.match(ln) for ln in lines]
            if len(lines) != 12 or not all(parsed):
                raise AssertionError(f"bench_attention_variants: unparsed output {lines}")
            for m in parsed[::3]:
                launches[f"probe_attention[{m.group(1)}]"] = int(m.group(5))
        else:
            rows = [json.loads(ln) for ln in lines]
            if len(rows) != 16 or any(r_["ms"] is None for r_ in rows):
                raise AssertionError(f"bench_attn_opt: unparsed output {lines}")
            for r_ in rows:
                key = f"probe_attention[{r_['function']}]"
                launches[key] = launches.get(key, 0) + r_["launches"]
    return launches


# phase 12: the supervised flows at their CLIs' defaults. The finetune step
# runs the training kernels once a block (12 blocks); its eval forward and
# the PGT teacher the inference routes (the teacher's last block is the CLS
# row). The UNet runs cuDNN convolutions and no kernel of the port.
FT_SIZE, FT_BATCH, UNET_SIZE, UNET_BATCH = 384, 3, 512, 8
SUP_N = 202  # PGT's validation and test sets start at image 200 (PGT.py:161-165)
FT_TRAIN_LAUNCHES = {"flash_attention": 12, "flash_attention_bwd": 12, "fused_mlp_block_h1": 12,
                     "fused_mlp_bwd": 12}
FT_EVAL_LAUNCHES = {"attention_qkv": 12, "fused_mlp_block_lnout": 11, "fused_mlp_block": 1}
# the finetune step's f32 gradients, each tensor at its own scale (its
# largest float64 gradient): the kernel route's distance from the float64
# plain route may be at most this many times the f32 plain route's, or
# F32_TOL (the encoder, from one upstream gradient) / GRAD_TOL["f32"] (the
# decoder, whole step). BatchNorm cancels the gradient of the conv bias
# before it (0 up to rounding), so that tensor is held at the largest
# gradient's scale
FT_GRAD_RATIO = 2.0
FT_BN_CANCELLED = ("two_layer_decoder.0.bias",)
# phase 13: Swin-Tiny at 224^2, batch 8, gradient accumulation 4
SWIN_SIZE, SWIN_BATCH, SWIN_ACCUM, ALLEN_CLASSES, ALLEN_PER_CLASS = 224, 8, 4, 4, 12
_METRICS_LINE = re.compile(r"Jaccard: ([\d.]+) - F1: ([\d.]+) - Recall: ([\d.]+) - "
                           r"Precision: ([\d.]+) - Acc: ([\d.]+) - ROC-AUC : ([\d.]+)")


def _launched_once(what, fn, want):
    """Launch counts of one fn() call, which must equal ``want`` (every
    other kernel 0)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    print(f"  {what} launches: {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} != {want}")
    return counts


def _write_sup_sets(root):
    """SUP_N labeled 512^2 PNGs (pieces of the synthetic OCM mosaic with
    their blob labels) in <root>/pgt; <root>/ft and <root>/unet link the
    first 72 and 32, so that every split of finetune (50/20/2), unet (25/5/2)
    and PGT (200/2/2) holds images."""
    from PIL import Image

    from vit_ocm_wmsegmentation_tpu_torch.data.synthetic import eval_pieces

    pieces, labels = eval_pieces(SUP_N, UNET_SIZE, seed=2)
    for sub, arrays in (("images", pieces), ("labels", labels)):
        os.makedirs(os.path.join(root, "pgt", sub))
        for i, a in enumerate(arrays):
            Image.fromarray(a).save(os.path.join(root, "pgt", sub, f"{i:03d}.png"))
    for name, n in (("ft", 72), ("unet", 32)):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(root, name, sub))
            for i in range(n):
                os.symlink(os.path.join(root, "pgt", sub, f"{i:03d}.png"),
                           os.path.join(root, name, sub, f"{i:03d}.png"))


def _start_cli(module, argv, cwd):
    """Start python -m vit_ocm_wmsegmentation_tpu_torch.<module> argv in cwd."""
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", f"vit_ocm_wmsegmentation_tpu_torch.{module}", *argv]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=cwd, env=env)
    return proc, time.perf_counter(), module, argv, cwd


def _finish_cli(started, want_files=()):
    """Wait for a :func:`_start_cli` process: it exits 0 and writes
    want_files (relative to its cwd). Returns its stdout."""
    proc, t0, module, argv, cwd = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    print(f"  python -m ...{module} {' '.join(argv)}: exit {proc.returncode}, "
          f"{time.perf_counter() - t0:.1f} s")
    for ln in out.strip().splitlines()[-6:]:
        print(f"    {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"{module} failed:\n{err[-3000:]}")
    missing = [f for f in want_files if not os.path.exists(os.path.join(cwd, f))]
    if missing:
        raise AssertionError(f"{module}: missing {missing}")
    return out


def _check_metrics(module, out, n_results, results_dir):
    """The printed test metrics are finite and in [0, 1]; the results
    folder holds one triptych per test image."""
    m = _METRICS_LINE.findall(out)
    vals = [float(v) for v in m[-1]] if m else []
    if len(vals) != 6 or not all(0.0 <= v <= 1.0 for v in vals):
        raise AssertionError(f"{module}: test metrics {m}")
    losses = [float(v) for v in re.findall(r"Train Loss: ([-\d.naif]+)", out)]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"{module}: train losses {losses}")
    got = len(os.listdir(results_dir))
    if got != n_results:
        raise AssertionError(f"{module}: {got} triptychs in {results_dir}, want {n_results}")
    print(f"  {module}: test metrics {vals}, train losses {losses}")


def _finetune_grad_check(model0, x, y):
    """The finetune step's first loss and gradients on the kernel route
    against the plain route and a float64 plain route (ops.twins'
    float64_twins: the twins sum in float64), each gradient tensor at its
    own scale, its largest float64 gradient (FT_BN_CANCELLED at the largest
    of all). The whole step's f32 gradients carry, on either route, the
    decoder's ReLU gates that rounding flips against float64: a flipped gate
    moves a gradient by an amount of its own size, not of the rounding's, so
    the whole step is held by its loss (rtol 1e-5), its gradient norm (rtol
    1e-4) and the decoder's tensors. The encoder, where the port's kernels
    run, is held by its backward from one upstream gradient, the float64
    step's at the encoder's output, on all three routes: there the kernel
    route's distance from float64 may be at most FT_GRAD_RATIO times the
    plain route's or F32_TOL, tensor by tensor."""
    import torch
    import torch.nn.functional as F

    from vit_ocm_wmsegmentation_tpu_torch import nn as tnn
    from vit_ocm_wmsegmentation_tpu_torch.models import probing
    from vit_ocm_wmsegmentation_tpu_torch.ops.metrics import dice_loss
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import float64_twins, plain_training_route

    names = [n for n, _ in model0.named_parameters()]
    n_enc = len(list(model0.encoder.parameters()))
    assert names[:n_enc] == [f"encoder.{n}" for n, _ in model0.encoder.named_parameters()]

    def step(model, x, y):
        z = probing.encode(model.encoder, x, True)
        loss = dice_loss(probing.decode(model, z, True), y)
        dz, *grads = torch.autograd.grad(loss, [z] + list(model.parameters()))
        return float(loss.detach()), z.detach(), dz, grads

    def pre_relu(model, z):  # the decoder's BatchNorm output, running statistics untouched
        conv, bn = model.two_layer_decoder[0], copy.deepcopy(model.two_layer_decoder[1])
        return tnn.batch_norm(F.conv2d(tnn.nchw(z), conv.weight, conv.bias, padding=1), bn, True)

    def encoder_grads(model, x, dz):
        z = probing.encode(model.encoder, x, True)
        return torch.autograd.grad(z, list(model.encoder.parameters()), dz)

    loss, z, _, grads = step(model0, x, y)
    with plain_training_route():
        ploss, pz, _, pgrads = step(model0, x, y)
    with plain_training_route(), float64_twins():
        m64 = copy.deepcopy(model0).double()
        loss64, z64, dz64, g64 = step(m64, x.double(), y.double())
        gates64 = pre_relu(m64, z64) > 0
        flips = [int(((pre_relu(m64, zz.double()) > 0) != gates64).sum()) for zz in (z, pz)]
        del m64
    enc = encoder_grads(model0, x, dz64.float())
    with plain_training_route():
        penc = encoder_grads(model0, x, dz64.float())

    top = max(float(g.abs().max()) for g in g64)
    scales = [top if n in FT_BN_CANCELLED else float(w.abs().max()) for n, w in zip(names, g64)]

    def dist(gs, ws, sc):
        return [float((g.double() - w.double()).abs().max()) / max(c, 1e-300)
                for g, w, c in zip(gs, ws, sc)]

    # the whole step, every tensor; the encoder from the float64 upstream gradient
    ek, ep, ekp = dist(grads, g64, scales), dist(pgrads, g64, scales), dist(grads, pgrads, scales)
    fk, fp = dist(enc, g64[:n_enc], scales), dist(penc, g64[:n_enc], scales)
    gn = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))
    pgn = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in pgrads])))
    print(f"  finetune first step [f32]: loss {loss:.7f} (plain {ploss:.7f}, float64 "
          f"{loss64:.7f}), grad norm {gn:.6f} (plain {pgn:.6f}); {len(names)} gradient "
          f"tensors, each at its own scale ({', '.join(FT_BN_CANCELLED)} at the largest "
          f"gradient's, {top:.4e}); decoder ReLU gates that differ from float64's: kernel "
          f"route {flips[0]}, plain route {flips[1]} of {gates64.numel()}")
    wk = max(range(n_enc), key=lambda i: ek[i])
    wp = max(range(n_enc), key=lambda i: ep[i])
    wkp = max(range(n_enc), key=lambda i: ekp[i])
    print(f"    whole step, encoder (not gated): |kernel - float64| up to {ek[wk]:.3e} "
          f"({names[wk]}), |plain - float64| up to {ep[wp]:.3e} ({names[wp]}); kernel vs plain "
          f"beyond {GRAD_TOL['f32']:g}: {sum(e > GRAD_TOL['f32'] for e in ekp[:n_enc])} of "
          f"{n_enc} tensors, up to {ekp[wkp]:.3e} ({names[wkp]})")
    allowed = [max(FT_GRAD_RATIO * p, GRAD_TOL["f32"]) for p in ep]
    failed = [names[i] for i in range(n_enc, len(names)) if not ek[i] <= allowed[i]]
    for i in range(n_enc, len(names)):
        print(f"    whole step, {names[i]}: |kernel - float64| {ek[i]:.3e}, |plain - float64| "
              f"{ep[i]:.3e} (gate: max({FT_GRAD_RATIO:g} x plain, {GRAD_TOL['f32']:g}))")
    allowed = [max(FT_GRAD_RATIO * p, F32_TOL) for p in fp]
    failed += [names[i] for i in range(n_enc) if not fk[i] <= allowed[i]]
    print(f"    encoder backward from the float64 upstream gradient, gate |kernel - float64| <= "
          f"max({FT_GRAD_RATIO:g} x |plain - float64|, {F32_TOL:g}); |kernel - float64| up to "
          f"{max(fk):.3e}, |plain - float64| up to {max(fp):.3e}; the closest to the gate "
          "(|kernel - float64| / allowed, kernel, plain):")
    for i in sorted(range(n_enc), key=lambda i: -fk[i] / allowed[i])[:6]:
        print(f"      {names[i]}: {fk[i] / allowed[i]:.3f}; {fk[i]:.3e} {fp[i]:.3e}")
    if not (np.isfinite(loss) and abs(loss - ploss) <= 1e-5 * abs(ploss)
            and abs(gn - pgn) <= 1e-4 * abs(pgn) and not failed):
        raise AssertionError(f"finetune step disagrees with the plain route: {failed}")


def phase_supervised():
    """The finetune, PGT and UNet flows at their CLIs' defaults (finetune:
    ViT-S/8 at depth 12, 384^2, batch 3, the 2-layer decoder, f32; UNet
    512^2, batch 8; PGT 384^2, batch 3): the first finetune step's loss on
    the kernel route against the plain route (rtol 1e-5) and its gradients
    against float64 per tensor (FT_GRAD_RATIO), the launches of
    a training step, an eval forward and a teacher batch, ms a step by CUDA
    events and peak memory, the teacher's masks against the plain route's
    (Dice >= 0.99); then the three CLIs through python -m at once on SUP_N
    synthetic labeled images for one or two epochs. Returns the launches of
    one finetune training step."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.data.synthetic import seg_batch
    from vit_ocm_wmsegmentation_tpu_torch.models import probing, unet, vit
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_route
    from vit_ocm_wmsegmentation_tpu_torch.pipeline import exact_matmuls
    from vit_ocm_wmsegmentation_tpu_torch.train import supervised as sup
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    x, y = seg_batch(FT_BATCH, FT_SIZE, 1, "cuda")
    cfg = probing.finetune_vit_config(FT_SIZE, 8)
    with exact_matmuls():
        # (a) finetune: the first step's loss and gradients, kernel vs plain route
        model0 = probing.init(cfg, torch.Generator().manual_seed(0), layer_num=2, device="cuda")
        _finetune_grad_check(model0, x, y)
        model = copy.deepcopy(model0)
        del model0
        train_step, eval_step = sup.make_seg_step(probing.apply, model,
                                                  sup.make_adam(model, 1e-4))
        ft_launches = _launched_once("finetune train step [f32]",
                                     lambda: train_step(x, y, 1e-4), FT_TRAIN_LAUNCHES)
        _launched_once("finetune eval forward [f32]", lambda: eval_step(x, y), FT_EVAL_LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: train_step(x, y, 1e-4), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        ems = cuda_ms(lambda: eval_step(x, y), iters=5, warmup=1)
        print(f"  finetune [f32, batch {FT_BATCH}, {FT_SIZE}^2]: {ms:.2f} ms/step, eval "
              f"{ems:.2f} ms/batch, peak device memory {peak / 2**30:.3f} GiB")
        del model, train_step, eval_step
        torch.cuda.empty_cache()

        # (b) the PGT teacher: masks against the plain route's, launches, ms
        teacher = vit.init(cfg, torch.Generator().manual_seed(0), device="cuda")
        masks = sup.teacher_pseudo_labels(teacher, x)
        with plain_route():
            pmasks = sup.teacher_pseudo_labels(teacher, x)
        d = dice(masks.cpu().numpy(), pmasks.cpu().numpy())
        fg = float(masks.mean())
        print(f"  PGT teacher [f32]: kernel vs plain masks Dice {d:.5f} (gate 0.99), "
              f"foreground {fg:.3f}")
        if d < 0.99 or not 0.0 < fg < 1.0:
            raise AssertionError(f"teacher masks: Dice {d}, foreground {fg}")
        _launched_once("PGT teacher batch [f32]", lambda: sup.teacher_pseudo_labels(teacher, x),
                       MOSAIC_LAUNCHES)
        tms = cuda_ms(lambda: sup.teacher_pseudo_labels(teacher, x), iters=5, warmup=1)

        # (c) the UNet student: the UNet CLI's step (512^2, batch 8) and PGT's
        student = unet.init(torch.Generator().manual_seed(0), "cuda")
        ustep, _ = sup.make_seg_step(unet.apply, student, sup.make_adam(student, 1e-4))
        ux, uy = seg_batch(UNET_BATCH, UNET_SIZE, 3, "cuda")
        _launched_once("UNet train step [f32]", lambda: ustep(ux, uy, 1e-4), {})
        torch.cuda.reset_peak_memory_stats()
        ums = cuda_ms(lambda: ustep(ux, uy, 1e-4), iters=5, warmup=1)
        upeak = torch.cuda.max_memory_allocated()
        pms = cuda_ms(lambda: ustep(x, sup.teacher_pseudo_labels(teacher, x), 1e-4), iters=5,
                      warmup=1)
        print(f"  UNet [f32, batch {UNET_BATCH}, {UNET_SIZE}^2]: {ums:.2f} ms/step, peak device "
              f"memory {upeak / 2**30:.3f} GiB; PGT [batch {FT_BATCH}, {FT_SIZE}^2]: teacher "
              f"{tms:.2f} ms/batch, teacher + student step {pms:.2f} ms")
        del teacher, student, ustep, ux, uy
        torch.cuda.empty_cache()

    # (d) the three CLIs through python -m
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _write_sup_sets(os.path.join(tmp, "sets"))
        print(f"  wrote {SUP_N} labeled {UNET_SIZE}^2 PNGs: {time.perf_counter() - t0:.1f} s")
        runs = [("finetune", ["--image_path", os.path.join(tmp, "sets", "ft"), "--epochs", "2",
                              "--ratio", "0.12", "--name", "ft"], "ft", 2),
                ("unet", ["--image_path", os.path.join(tmp, "sets", "unet"), "--epochs", "1",
                          "--ratio", "0.32", "--name", "un"], "un", 2),
                ("pgt", ["--image_path", os.path.join(tmp, "sets", "pgt"), "--epochs", "1",
                         "--ratio", "0.015", "--name", "pg"], "pg", 2)]
        # the three at once on the card (each holds a few GiB of its 80 GB)
        started = [_start_cli(module, argv, tmp) for module, argv, _, _ in runs]
        for st, (module, _, name, n_test) in zip(started, runs):
            out = _finish_cli(st, [f"files/{name}/ckpt_epoch_0"])
            _check_metrics(module, out, n_test, os.path.join(tmp, "results", name))
    return ft_launches


def _write_imagefolder(root):
    """ALLEN_CLASSES classes of ALLEN_PER_CLASS 256^2 RGB PNGs each: noise
    around a class-specific brightness and tint."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(ALLEN_CLASSES):
        os.makedirs(os.path.join(root, f"class{c}"))
        base = np.array([40 + 50 * c, 200 - 40 * c, 120], np.float64)
        for i in range(ALLEN_PER_CLASS):
            a = np.clip(base + rng.normal(0, 25, (256, 256, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(a).save(os.path.join(root, f"class{c}", f"{i:02d}.png"))


def phase_allen_dino():
    """The Allen classifier: Swin-Tiny at 224^2, batch 8, gradient
    accumulation 4, in f32 and AMP bf16 (ms a micro-step by CUDA events,
    peak memory, AMP logits against f32), then the CLI through python -m on
    a synthetic imagefolder with --amp; then a DINO head over multi-crop
    ViT-S/8 CLS features (2 x 224^2 and 4 x 96^2 crops) and three LARS steps
    on the card against the CPU (within 1e-5 of max|CPU|)."""
    import torch

    from vit_ocm_wmsegmentation_tpu_torch.models import swin, vit
    from vit_ocm_wmsegmentation_tpu_torch.pipeline import exact_matmuls
    from vit_ocm_wmsegmentation_tpu_torch.train import classifier as cls
    from vit_ocm_wmsegmentation_tpu_torch.train import dino
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import cuda_ms

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((SWIN_BATCH, SWIN_SIZE, SWIN_SIZE, 3), dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, ALLEN_CLASSES, SWIN_BATCH)).cuda()
    cfg = swin.SwinConfig(num_classes=ALLEN_CLASSES)
    with exact_matmuls():
        logits = {}
        for amp in (False, True):
            tag = "bf16" if amp else "f32"
            model = swin.init(cfg, torch.Generator().manual_seed(0), "cuda")
            opt = cls.AccumulatedAdamW(list(model.parameters()),
                                       cls.hf_linear_schedule(5e-5, 100), SWIN_ACCUM)
            step, _ = cls.make_classifier_step(model, opt, amp=amp)
            with torch.no_grad():
                logits[tag] = (swin.apply(model, x) if not amp else torch.func.functional_call(
                    model, {n: p.bfloat16() for n, p in model.named_parameters()},
                    (x.bfloat16(),))).float()
            _launched_once(f"Swin micro-step [{tag}]", lambda: step(x, y), {})
            torch.cuda.reset_peak_memory_stats()
            # one optimizer step: SWIN_ACCUM micro-steps, the last applying AdamW
            ms = cuda_ms(lambda: [step(x, y) for _ in range(SWIN_ACCUM)], iters=2, warmup=1)
            peak = torch.cuda.max_memory_allocated()
            loss = float(step(x, y))
            print(f"  Swin-Tiny [{tag}, batch {SWIN_BATCH}, {SWIN_SIZE}^2]: {ms:.2f} ms an "
                  f"optimizer step of {SWIN_ACCUM} micro-steps "
                  f"({SWIN_ACCUM * SWIN_BATCH / (ms / 1e3):.1f} images/s), peak device memory "
                  f"{peak / 2**30:.3f} GiB, loss {loss:.4f}, updates {opt.updates}")
            if not np.isfinite(loss) or opt.updates != 3:
                raise AssertionError(f"Swin step [{tag}]: loss {loss}, updates {opt.updates}")
            del model, opt, step
            torch.cuda.empty_cache()
        err, rel, finite = _rel_err(logits["bf16"], logits["f32"])
        print(f"  Swin-Tiny logits, AMP vs f32: max|d| {err:.3e}, rel {rel:.3e}")
        if not finite or rel > 5e-2:
            raise AssertionError(f"Swin AMP logits: rel {rel}")

    with tempfile.TemporaryDirectory() as tmp:
        _write_imagefolder(os.path.join(tmp, "data"))
        stdout = _finish_cli(_start_cli("allen_train", ["--data_path", os.path.join(tmp, "data"),
                                                        "--epochs", "2", "--amp"], tmp),
                             ["swin_allen_output/ckpt_epoch_0", "swin_allen_output/history.json"])
        hist = json.load(open(os.path.join(tmp, "swin_allen_output", "history.json")))["history"]
        if len(hist) != 2 or not all(np.isfinite(h["train_loss"]) for h in hist):
            raise AssertionError(f"allen_train --amp: history {hist}")
        if "training from scratch" not in stdout:
            raise AssertionError("allen_train: expected the from-scratch fallback")

    # DINO: the head over multi-crop CLS features, and LARS, card vs CPU
    backbone = vit.init(vit.VIT_SMALL(patch_size=8), torch.Generator().manual_seed(0), "cuda")
    head = dino.dino_head_init(384, 65536, generator=torch.Generator().manual_seed(1))
    crops = [torch.from_numpy(rng.random((2, s, s, 3), dtype=np.float32)) for s in (224, 224)]
    crops += [torch.from_numpy(rng.random((4, 96, 96, 3), dtype=np.float32))]
    with exact_matmuls(), torch.no_grad():
        feats = dino.multi_crop_forward(lambda c: vit.forward_cls(backbone, c), lambda h: h,
                                        [c.cuda() for c in crops])
        out = dino.dino_head_apply(head.cuda(), feats)
        want = dino.dino_head_apply(head.cpu(), feats.cpu())
        _compare("DINO head", "f32", out.cpu(), want, F32_TOL)
        ps = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((1536, 384), (1536,))]
        gs = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)) for p in ps]
              for _ in range(3)]
        lrs = dino.cosine_scheduler(0.3, 0.01, 1, 3)
        results = []
        for device in ("cuda", "cpu"):
            params = [torch.nn.Parameter(p.clone().to(device)) for p in ps]
            opt = dino.LARS(params, weight_decay=0.04)
            for lr, g in zip(lrs, gs):
                opt.param_groups[0]["lr"] = float(lr)
                for p, gi in zip(params, g):
                    p.grad = gi.to(device)
                opt.step()
            results.append([p.detach().cpu() for p in params])
        _compare("DINO LARS, 3 steps", "f32", results[0], results[1], F32_TOL)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from vit_ocm_wmsegmentation_tpu_torch import build, pipeline
    from vit_ocm_wmsegmentation_tpu_torch.utils.profiling import card_line

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({build.build_info['seconds']:.1f} s "
          f"in nvcc)")
    for line in build.build_info["ptxas"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    check_kernel_builds()

    phases = time.perf_counter()
    t = [phases]

    def took(label):
        now = time.perf_counter()
        print(f"  {label}: {now - t[0]:.1f} s (host clock)")
        t[0] = now

    with pipeline.exact_matmuls():  # the plain twins' f32 matmuls too
        print("phase 1: kernels against their plain twins")
        kernels = phase_kernels()
        ft_rows = phase_finetune_kernels(torch.Generator(device="cuda").manual_seed(1))
        probe_rows = phase_probe_kernels()
        took("phase 1")
        print("phase 2: segment_mosaic at full width")
        launches, models = phase_slice()
        took("phase 2")
        print("phase 2b: segment_mosaic with DINOv2 ViT-g/14 at full width")
        g14_launches = phase_dinov2_mosaic()
        took("phase 2b")
        print("phase 3: directory serving")
        served = phase_serving(models["bf16"])
        took("phase 3")
        print("phase 4: the MIM step at full width")
        mim = phase_mim()
        took("phase 4")
        print("phase 4b: the MIM step on the opt-in kernel routes")
        route_launches = phase_mim_routes(mim)
        took("phase 4b")
    print("phase 5: the MIM CLI, with auto-resume")
    phase_mim_cli()
    took("phase 5")
    print("phase 6: segment_mosaic_streamed at full width")
    stream_launches, streamed_mask = phase_streamed(models)
    took("phase 6")
    print("phase 7: streamed serving with every artifact")
    phase_serving_streamed(models["bf16"], streamed_mask)
    took("phase 7")
    print("phase 8: the int8 serving route at full width")
    int8_launches = phase_int8_route(models)
    took("phase 8")
    print("phase 9: the probe CLIs")
    probe_launches = {**phase_probe_clis(), **int8_launches}
    took("phase 9")
    print("phase 10: the labeled eval path at full width")
    phase_eval(models)
    took("phase 10")
    print("phase 11: the attention-analysis CLI at full width")
    phase_analysis()
    took("phase 11")
    print("phase 12: the finetune, UNet and PGT flows at their CLIs' defaults")
    ft_launches = phase_supervised()
    took("phase 12")
    print("phase 13: the Allen Swin classifier and the DINO components")
    phase_allen_dino()
    took("phase 13")
    print("phase 14: the multi-device paths")
    phase_multi_device(served)
    took("phase 14")
    print(f"phases 1-14: {time.perf_counter() - phases:.1f} s (host clock)")

    rows = []
    for (name, tag), r in kernels.items():
        _, sources, replaces = KERNELS[name]
        if name == "histogram_u8_kernel":
            path_launches = stream_launches[name]
        elif name in ("swiglu_gate", "layerscale_norm"):
            path_launches = g14_launches[name]
        elif name in MOSAIC_LAUNCHES:
            path_launches = launches[tag][name]
        elif name in MIM_LAUNCHES:
            path_launches = mim[tag][1][name]
        else:  # an opt-in route's kernel: the step with all three routes on
            path_launches = route_launches[("all three", tag)][name]
        rows.append({"name": f"{name}[{tag}]", "route": "cuda", "source": CSRC + sources[tag],
                     "replaces": replaces, "launches": path_launches, **r})
    for r in ft_rows:  # the finetune step's instances of the training kernels
        rows.append({**r, "launches": ft_launches[r["name"].split("[")[0]]})
    for name, r in probe_rows.items():  # the int8 route's GEMM and the tools/ probes
        if not probe_launches.get(name):
            raise AssertionError(f"{name} was not launched on its path (phases 8-9)")
        rows.append({**r, "launches": probe_launches[name]})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fixtures of the benchmark's tests: a benchmark of tiny cells written into a
temporary directory, as a later change would add its files, and the card
fixture that decides at run time whether a test marked ``cuda`` runs."""

from __future__ import annotations

import copy
import json
import os
import shutil

import pytest
import torch

from benchmark import spec

TINY_VIT = {"name": "tiny_vit", "source": "test fixture", "patch_size": 8, "embed_dim": 64,
            "depth": 2, "num_heads": 2, "mlp_ratio": 4, "qkv_bias": True, "ln_eps": 1e-6,
            "img_size": 32, "precision": "float32", "infer_mlp": "auto", "quant": "none",
            "weights": {"dtype": "float32", "std": 0.02, "bias_std": 0.02}}
TINY_MIM = {"name": "tiny_mim", "source": "test fixture", "patch_size": 8, "embed_dim": 64,
            "depth": 1, "num_heads": 2, "mlp_ratio": 4, "qkv_bias": True, "ln_eps": 1e-6,
            "img_size": 32, "decoder": "1x1 conv, pixel shuffle", "precision": "float32",
            "optimizer": {"name": "adamw", "base_lr": 5e-4, "warmup_lr": 5e-7, "min_lr": 5e-6,
                          "weight_decay": 0.05, "clip_grad": 5.0, "betas": [0.9, 0.999],
                          "eps": 1e-8},
            "weights": {"dtype": "float32", "std": 0.02, "bias_std": 0.0}}
TRAFFIC = {
    "tiny_fused": {"kind": "serve", "route": "fused", "size": 96, "window": 64, "stride": 32,
                   "blob": 32, "pool": 3, "prefetch_depth": 2, "warmup": 1, "trace_mosaics": 2},
    "tiny_streamed": {"kind": "serve", "route": "streamed", "size": 128, "window": 64,
                      "stride": 32, "blob": 48, "pool": 2, "prefetch_depth": 2, "warmup": 1,
                      "trace_mosaics": 1},
    "tiny_mim": {"kind": "train", "precision": "float32", "amp_opt_level": "", "batch": 4,
                 "img_size": 32, "mask_patch": 16, "mask_ratio": 0.5, "epochs": 30,
                 "warmup_epochs": 20, "source_rows": 2, "source_cols": 4, "blob": 24,
                 "trace_steps": 2},
}
# the CPU runs the port's plain twins in float32: the gaps to the reference are
# rounding (canvas ~1e-6, losses ~1e-7); the limits sit well above them and far
# below what the faults read
LIMITS = {
    "tiny_fused_cell": {"sample": 2, "judge_within": 2,
                        "limits": {"canvas_rel": 1e-4, "tile_rel": 1e-4,
                                   "mask_ref_px": 0.0, "mask_own_px": 0.0}},
    "tiny_streamed_cell": {"sample": 1, "judge_within": 1, "strips": 2, "strip_rows": 2,
                           "limits": {"canvas_rel": 1e-4, "tile_rel": 1e-4,
                                      "mask_own_px": 0.0}},
    "tiny_mim_cell": {"limits": {"loss_rel": 1e-5, "grad1_leaf": 1e-3, "delta3_leaf": 1e-3}},
}
# the real cell each tiny cell stands in for: it reports that cell's metrics
STANDS_IN = {"vits8_fused_1152": "tiny_fused_cell", "vits8_streamed_8192": "tiny_streamed_cell",
             "simmim_amp_b16": "tiny_mim_cell", "simmim_f32_b16": "tiny_mim_cell"}
CELLS = [("tiny_fused_cell", "tiny_vit", "tiny_fused"),
         ("tiny_streamed_cell", "tiny_vit", "tiny_streamed"),
         ("tiny_mim_cell", "tiny_mim", "tiny_mim")]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def write_tiny_root(root):
    """A checkout-like ``root`` (a pathlib.Path) with BENCHMARK.json and a
    ``bench`` folder of tiny cells; the per-layer metrics are the
    benchmark's own files."""
    bench = root / "bench"
    for cfg in (TINY_VIT, TINY_MIM):
        _dump(str(bench / "configs" / f"{cfg['name']}.json"), cfg)
    for name, t in TRAFFIC.items():
        _dump(str(bench / "traffic" / f"{name}.json"), t)
    for name, lim in LIMITS.items():
        _dump(str(bench / "workloads" / f"{name}.json"), lim)
    shutil.copytree(os.path.join(spec.HERE, "metrics"), str(bench / "metrics"))
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    doc = copy.deepcopy(real)
    doc["configs"] = [{"name": c["name"], "source": "test", "reduced": [], "why": "test",
                       "file": f"bench/configs/{c['name']}.json"} for c in (TINY_VIT, TINY_MIM)]
    doc["workloads"] = [{"name": w, "config": c, "traffic": t, "chips": 1, "why": "test"}
                        for w, c, t in CELLS]
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({STANDS_IN[w] for w in m["workloads"]})
    _dump(str(root / "BENCHMARK.json"), doc)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_root(tmp_path / "root")


@pytest.fixture
def cell_of(tiny_root):
    """cell_of(workload) -> the tiny benchmark's spec.Cell."""
    return lambda w: spec.load_cell(w, root=str(tiny_root), bench_dir=str(tiny_root / "bench"))

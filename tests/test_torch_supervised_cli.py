"""The port's finetune, UNet and PGT entry points against the repository's
root finetune.py, unet.py and PGT.py, at a tiny size on the CPU.

Each pair runs on the same labeled set from the same initial weights (the
JAX package's init, carried into the port's model by train/checkpoint's
converters) and the same shuffles. Compared: the per-epoch train and
validation losses (rtol 1e-4: Adam's eps of 1e-8 turns gradients that are
0 up to rounding, such as a conv bias before BatchNorm, into steps of
either sign, which BatchNorm mostly cancels), the printed test metrics
(within 2e-3: one 32^2 prediction pixel that f32 rounding moves across 0.5
shifts a metric by up to ~1e-3), the best-model checkpoint's presence and
the triptych files' names.
"""

import importlib.util
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu import cli
from vit_ocm_wmsegmentation_tpu.models import probing as jprobing
from vit_ocm_wmsegmentation_tpu.models import unet as junet
from vit_ocm_wmsegmentation_tpu.models import vit as jvit
from vit_ocm_wmsegmentation_tpu.train import supervised as jsup
from vit_ocm_wmsegmentation_tpu_torch import finetune, pgt
from vit_ocm_wmsegmentation_tpu_torch import unet as unet_cli
from vit_ocm_wmsegmentation_tpu_torch.models import probing, unet
from vit_ocm_wmsegmentation_tpu_torch.models import vit as tvit
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as ckpt

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
METRICS = re.compile(r"Jaccard: ([\d.]+) - F1: ([\d.]+) - Recall: ([\d.]+) - "
                     r"Precision: ([\d.]+) - Acc: ([\d.]+) - ROC-AUC : ([\d.]+)")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _write_set(root, n, size=40, labels=True):
    """n RGB images of a bright rectangle on a dark noisy ground and its
    mask, in files whose sorted order is their index order."""
    rng = np.random.default_rng(n)
    (root / "images").mkdir(parents=True)
    if labels:
        (root / "labels").mkdir()
    for i in range(n):
        y0, x0 = rng.integers(2, size // 2, 2)
        img = np.full((size, size), 50.0)
        img[y0:y0 + size // 3, x0:x0 + size // 3] = 190
        img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
        rgb = np.stack([img, np.roll(img, 1, 0), img // 2 + 60], -1)
        Image.fromarray(rgb).save(root / "images" / f"{i:03d}.png")
        if labels:
            lab = np.zeros((size, size), np.uint8)
            lab[y0:y0 + size // 3, x0:x0 + size // 3] = 255
            Image.fromarray(lab).save(root / "labels" / f"{i:03d}.png")
    return str(root)


def _root_module(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_root(monkeypatch, capsys, tmp_path, name, path, argv):
    """Run a root CLI in tmp_path/root; returns (losses, printed metrics)."""
    mod = _root_module(name, path)
    seen = {}

    def train(*a, **k):
        out = jsup.train_supervised(*a, **k)
        seen["losses"] = (out[2], out[3])
        return out

    monkeypatch.setattr(mod, "train_supervised", train)
    monkeypatch.setattr(cli, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    os.makedirs(tmp_path / "root")
    monkeypatch.chdir(tmp_path / "root")
    capsys.readouterr()
    mod.main()
    return seen["losses"], _metrics(capsys.readouterr().out)


def _run_port(monkeypatch, capsys, tmp_path, main, argv):
    os.makedirs(tmp_path / "port")
    monkeypatch.chdir(tmp_path / "port")
    capsys.readouterr()
    _, _, tl, vl = main([*argv, "--device", "cpu"])
    return (tl, vl), _metrics(capsys.readouterr().out)


def _metrics(out):
    m = METRICS.findall(out)
    assert len(m) == 1, out
    return np.array([float(v) for v in m[0]])


def _compare(tmp_path, name, got, want):
    (tl, vl), mets = got
    (jtl, jvl), jmets = want
    np.testing.assert_allclose(tl, jtl, rtol=1e-4)
    np.testing.assert_allclose(vl, jvl, rtol=1e-4)
    np.testing.assert_allclose(mets, jmets, atol=2e-3, rtol=0)
    assert os.path.exists(tmp_path / "port" / "files" / name / "ckpt_epoch_0")
    assert os.path.exists(tmp_path / "root" / "files" / name / "ckpt_epoch_0")
    names = sorted(os.listdir(tmp_path / "port" / "results" / name))
    assert names and names == sorted(os.listdir(tmp_path / "root" / "results" / name))


def test_finetune_cli_matches_root(tmp_path, monkeypatch, capsys):
    """finetune on 72 images at 32^2 (train 4 of 50 by --ratio, valid 20,
    test 2), 2 epochs, the 2-layer decoder, the training kernels' twins in
    the steps and the inference routes' twins in valid/test."""
    data = _write_set(tmp_path / "set", 72)
    argv = ["--image_path", data, "--image_size", "32", "--epochs", "2", "--batch_size", "2",
            "--ratio", "0.08", "--name", "ft"]
    want = _run_root(monkeypatch, capsys, tmp_path, "root_finetune", "finetune.py", argv)
    cfg = probing.finetune_vit_config(32, 8)

    def init(c, g=None, layer_num=1, device=None):
        jp = jprobing.init(jprobing.finetune_vit_config(32, 8), jax.random.PRNGKey(0),
                           layer_num=layer_num)
        model = probing.LinearProbing(cfg, layer_num)
        model.load_state_dict(ckpt.probing_state_from_jax_numpy(_np_tree(jp), cfg, layer_num))
        return model

    monkeypatch.setattr(probing, "init", init)
    got = _run_port(monkeypatch, capsys, tmp_path, finetune.main, argv)
    _compare(tmp_path, "ft", got, want)


def test_unet_cli_matches_root(tmp_path, monkeypatch, capsys):
    """unet on 32 images at 32^2 (train 4 of 25, valid 5, test 2), 2 epochs."""
    data = _write_set(tmp_path / "set", 32)
    argv = ["--image_path", data, "--H", "32", "--W", "32", "--epochs", "2", "--batch_size", "2",
            "--ratio", "0.16", "--name", "un"]
    want = _run_root(monkeypatch, capsys, tmp_path, "root_unet", "unet.py", argv)

    def init(g=None, device=None, in_channels=3):
        jp, js = junet.init(jax.random.PRNGKey(0))
        model = unet.UNet()
        model.load_state_dict(ckpt.unet_state_from_jax_numpy(_np_tree(jp), _np_tree(js)))
        return model.to(device) if device is not None else model

    monkeypatch.setattr(unet, "init", init)
    got = _run_port(monkeypatch, capsys, tmp_path, unet_cli.main, argv)
    _compare(tmp_path, "un", got, want)


def test_pgt_cli_matches_root(tmp_path, monkeypatch, capsys):
    """PGT on 202 images at 32^2 (train 4 of 200, valid 2, test 2 scored
    against labels/), 1 epoch: the depth-12 teacher's pseudo-labels and the
    UNet student."""
    data = _write_set(tmp_path / "set", 202, size=32)
    argv = ["--image_path", data, "--H", "32", "--epochs", "1", "--batch_size", "2",
            "--ratio", "0.02", "--name", "pg"]
    want = _run_root(monkeypatch, capsys, tmp_path, "root_pgt", "PGT.py", argv)
    tcfg = probing.finetune_vit_config(32, 8)

    def vit_init(c, g=None, device=None, requires_grad=False):
        model = tvit.ViT(tcfg)
        model.load_state_dict(ckpt.vit_state_from_jax_numpy(
            _np_tree(jvit.init(jprobing.finetune_vit_config(32, 8), jax.random.PRNGKey(0))),
            tcfg))
        return model

    def unet_init(g=None, device=None, in_channels=3):
        jp, js = junet.init(jax.random.PRNGKey(1))
        model = unet.UNet()
        model.load_state_dict(ckpt.unet_state_from_jax_numpy(_np_tree(jp), _np_tree(js)))
        return model.to(device) if device is not None else model

    monkeypatch.setattr(tvit, "init", vit_init)
    monkeypatch.setattr(unet, "init", unet_init)
    got = _run_port(monkeypatch, capsys, tmp_path, pgt.main, argv)
    _compare(tmp_path, "pg", got, want)


def test_pgt_rand_mode_and_pretrained_teacher(tmp_path, monkeypatch, capsys):
    """--rand draws head subsets from a seeded generator and trains; a local
    --pretrained_weights file (a 224^2 positional table) fills the teacher,
    whose table is interpolated at run time."""
    data = _write_set(tmp_path / "set", 4, size=32, labels=False)
    weights = tmp_path / "dino.pth"
    torch.save({"teacher": tvit.init(tvit.VIT_SMALL(patch_size=8),
                                     torch.Generator().manual_seed(3)).state_dict()}, weights)
    monkeypatch.chdir(tmp_path)
    avg, loss, tl, vl = pgt.main(["--image_path", data, "--H", "32", "--epochs", "1",
                                  "--batch_size", "2", "--rand", "--pretrained_weights",
                                  str(weights), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"Teacher weights loaded from {weights}" in out
    assert np.isfinite(tl).all() and "test split is empty" in out


def test_finetune_frozen_encoder_and_pretrained(tmp_path, monkeypatch, capsys):
    """--finetune False keeps the encoder's bits; a local checkpoint loads
    into it; a broken one is reported and the random encoder kept."""
    data = _write_set(tmp_path / "set", 4)
    weights = tmp_path / "vit.pth"
    src = tvit.init(probing.finetune_vit_config(224, 8), torch.Generator().manual_seed(4))
    torch.save({"teacher": src.state_dict()}, weights)
    monkeypatch.chdir(tmp_path)
    seen = {}
    real = finetune.train_supervised

    def spy(apply_fn, model, *a, **k):
        seen["before"] = {n: p.detach().clone() for n, p in model.encoder.named_parameters()}
        out = real(apply_fn, model, *a, **k)
        seen["after"] = {n: p.detach().clone() for n, p in out[0].encoder.named_parameters()}
        return out

    monkeypatch.setattr(finetune, "train_supervised", spy)
    argv = ["--image_path", data, "--image_size", "32", "--epochs", "1", "--batch_size", "2",
            "--device", "cpu", "--layer_num", "1"]
    finetune.main([*argv, "--finetune", "False", "--pretrained_weights", str(weights)])
    assert "and loaded" in capsys.readouterr().out
    for n, p in seen["after"].items():
        assert torch.equal(p, seen["before"][n]), n
    assert torch.equal(seen["before"]["blocks.0.attn.qkv.weight"],
                       src.state_dict()["blocks.0.attn.qkv.weight"])
    torch.save({"teacher": {"nothing": torch.zeros(1)}}, tmp_path / "bad.pth")
    finetune.main([*argv, "--pretrained_weights", str(tmp_path / "bad.pth")])
    assert "could not load pretrained weights" in capsys.readouterr().out


@pytest.mark.parametrize("main,extra", [
    (finetune.main, []), (unet_cli.main, []), (pgt.main, [])], ids=["finetune", "unet", "pgt"])
def test_cli_device_cuda_raises_without_a_card(tmp_path, main, extra):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--image_path", str(tmp_path), *extra])  # --device defaults to cuda


def test_str2bool():
    for v in ("False", "false", "0", "no", "n", "f", ""):
        assert finetune.str2bool(v) is False
    for v in ("True", "1", "yes", True):
        assert finetune.str2bool(v) is True

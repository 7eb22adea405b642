"""The MIM trainer's remainders against the JAX package: the MLP remat routes
(TRAIN.MLP_REMAT none / gelu / gelu+ln), ROI masking, the on-device
augmentation (DATA.DEVICE_AUG), and the MIM CLI's per-epoch evaluation and
W&B files.

Tolerances of the remat steps are test_torch_train.py's
(test_mim_step_matches_jax): f32 loss and grad norm to rtol 1e-4, every
parameter within 1e-5 * max(1, max|p|); AMP 1e-2 and 1e-3. The JAX
package's MLP_REMAT global is set with monkeypatch, its jit caches cleared
around each step. Its native wrappers run on the library the port built
from the same source (nothing is written under ``native/``).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu import native as jnative
from vit_ocm_wmsegmentation_tpu.data import build_simmim_loader as jax_loader
from vit_ocm_wmsegmentation_tpu.data import device_aug as jaug
from vit_ocm_wmsegmentation_tpu.models import vit as jvit
from vit_ocm_wmsegmentation_tpu.train import optim as joptim
from vit_ocm_wmsegmentation_tpu.train import schedule as jschedule
from vit_ocm_wmsegmentation_tpu.train.mim_trainer import make_train_step as jax_step
from vit_ocm_wmsegmentation_tpu_torch import mim
from vit_ocm_wmsegmentation_tpu_torch import native as tnative
from vit_ocm_wmsegmentation_tpu_torch.data import device_aug as taug
from vit_ocm_wmsegmentation_tpu_torch.data.datasets import (
    DeviceAugLoader,
    build_simmim_device_loader,
    build_simmim_loader,
)
from vit_ocm_wmsegmentation_tpu_torch.models.vit import MLP_REMAT_MODES, TrainRoutes, mlp_remat
from vit_ocm_wmsegmentation_tpu_torch.train import optim, schedule
from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step, train_routes

from port_helpers import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import _assert_params_match, _batch, _cfgs, _models, _write_images
from test_torch_train_routes import _routes_cfg

JAX_REMAT = {"none": None, "gelu": "gelu", "gelu+ln": "gelu+ln"}


@pytest.fixture(autouse=True)
def jax_native_on_the_port_library(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", tnative.load())


@pytest.fixture
def jax_remat(monkeypatch):
    def set_mode(mode):
        monkeypatch.setattr(jvit, "MLP_REMAT", JAX_REMAT[mode])
        jax.clear_caches()

    yield set_mode
    jax.clear_caches()


# --- the MLP remat routes ------------------------------------------------------------


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("mode", MLP_REMAT_MODES)
def test_remat_route_step_matches_jax(mode, amp, jax_remat):
    """One train step on the route against the JAX make_train_step with the
    same MLP_REMAT: loss, grad norm and every updated parameter."""
    jax_remat(mode)
    jcfg, jparams, model = _models()
    jc, tc = _cfgs()
    x, mask = _batch()
    sched = jschedule.build_schedule(jc, 1)
    tx = joptim.build_optimizer(jc, jparams, sched)
    jparams, _, jloss, jgnorm = jax_step(jcfg, tx, amp=amp)(
        jparams, tx.init(jparams), jnp.asarray(x), jnp.asarray(mask))
    step = make_train_step(model, optim.Optimizer(tc, model, schedule.build_schedule(tc, 1)),
                           amp=amp, routes=TrainRoutes(mlp=mode))
    loss, gnorm = step(torch.from_numpy(x), torch.from_numpy(mask))
    rtol = 1e-2 if amp else 1e-4
    assert float(loss) == pytest.approx(float(jloss), rel=rtol)
    assert float(gnorm) == pytest.approx(float(jgnorm), rel=rtol)
    _assert_params_match(model, jparams, 1e-3 if amp else 1e-5)


def _loss_grads(model, x, mask, routes, amp=False, remat=False):
    if amp:
        live = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        loss, _, _ = torch.func.functional_call(
            model, live, (torch.from_numpy(x).bfloat16(), torch.from_numpy(mask), remat, routes))
    else:
        loss, _, _ = model(torch.from_numpy(x), torch.from_numpy(mask), remat, routes)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("amp", [False, True])
def test_remat_routes_agree_with_each_other(amp):
    """The three routes compute one function: losses and gradients within
    1e-6 of max|g| of each other (they save different tensors, not other
    values)."""
    _, _, model = _models()
    x, mask = _batch(2)
    ref_loss, ref = _loss_grads(model, x, mask, TrainRoutes(mlp="none"), amp)
    for mode in ("gelu", "gelu+ln"):
        loss, grads = _loss_grads(model, x, mask, TrainRoutes(mlp=mode), amp)
        assert abs(float(loss) - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
        for g, r in zip(grads, ref):
            assert g.dtype == r.dtype
            assert float((g.float() - r.float()).abs().max()) <= 1e-6 * max(
                float(r.float().abs().max()), 1e-30)


@pytest.mark.parametrize("mode", ["gelu", "gelu+ln"])
def test_remat_route_keeps_less(mode):
    """What autograd holds for the backward of one MLP branch: the stock
    route keeps ln2(x), h1 and gelu(h1); "gelu" drops gelu(h1); "gelu+ln"
    drops ln2(x) too (counted as (R, H) and (R, D) activations saved)."""
    rng = np.random.default_rng(0)
    r, d, h = 40, 16, 64
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()  # noqa: E731
    args = (t(r, d), t(d), t(d), t(h, d), t(h), t(d, h), t(d))

    def saved(m):
        shapes = []

        def pack(x):
            shapes.append(tuple(x.shape))
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            out = mlp_remat(*args, 1e-6, m)
        return out, sorted(s for s in shapes if s in ((r, h), (r, d)))

    out0, stock = saved("none")
    out1, kept = saved(mode)
    assert torch.equal(out0, out1)
    assert stock.count((r, h)) == 2 and kept.count((r, h)) == 1
    assert kept.count((r, d)) == stock.count((r, d)) - (1 if mode == "gelu+ln" else 0)


def test_remat_route_under_use_checkpoint_keeps_gradients():
    _, _, model = _models()
    x, mask = _batch(2)
    a = _loss_grads(model, x, mask, TrainRoutes(mlp="gelu+ln"))
    b = _loss_grads(model, x, mask, TrainRoutes(mlp="gelu+ln"), remat=True)
    assert torch.equal(a[0], b[0]) and all(torch.equal(g, h) for g, h in zip(a[1], b[1]))


@pytest.mark.parametrize("mode", MLP_REMAT_MODES)
def test_train_routes_takes_the_remat_routes(mode):
    assert train_routes(_routes_cfg(mode)) == TrainRoutes(mlp=mode)
    assert train_routes(_routes_cfg(mode, "kernel", "on")) == TrainRoutes(
        mlp=mode, ln_qkv=True, attn_save_p=True)


def test_train_routes_rejects_an_unknown_mlp_route():
    with pytest.raises(ValueError, match="TrainRoutes.mlp"):
        TrainRoutes(mlp="gelu+h1")


# --- ROI masking --------------------------------------------------------------------


def _write_ocm_like(path, n, size=48, seed=0):
    """n grayscale tiles: a few bright blobs on a black background (the
    gray > 10 foreground ROI masking restricts the mask to), plus one all
    black tile, whose ROI set is empty."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size + 8]
    for i in range(n):
        img = np.zeros((size, size + 8))
        for _ in range(3):
            cy, cx = rng.integers(0, size, 2)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= rng.integers(4, 12) ** 2] = rng.integers(60, 250)
        if i == n - 1:
            img[:] = 0
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(path, f"t{i}.png"))
    return str(path)


def test_roi_masking_loader_batches_equal_jax(tmp_path):
    src = _write_ocm_like(tmp_path / "imgs", 6)
    args = (src, 2, 32, 8, 8, 0.5)
    jl = jax_loader(*args, roi_masking=True, seed=3)
    tl = build_simmim_loader(*args, roi_masking=True, seed=3)
    plain = build_simmim_loader(*args, seed=3)
    restricted = 0
    for epoch in (0, 1):
        triples = list(zip(jl.epoch(epoch), tl.epoch(epoch), plain.epoch(epoch)))
        assert len(triples) == 3
        for (jx, jm), (tx_, tm), (px, pm) in triples:
            np.testing.assert_array_equal(jx, tx_)
            np.testing.assert_array_equal(jm, tm)
            np.testing.assert_array_equal(tx_, px)  # same draws, same images
            assert (tm <= pm).all()
            restricted += int((tm != pm).any())
    assert restricted > 0


# --- the on-device augmentation -------------------------------------------------------


@pytest.mark.parametrize("box", [(0, 0, 64, 64), (10, 20, 40, 70), (5, 5, 91, 91)])
def test_crop_resize_equals_jax(box):
    """scale_and_translate's antialiased weights, border rows included."""
    src = (np.random.default_rng(0).random((96, 96, 3)) * 255).astype(np.uint8)
    x = src.astype(np.float32) / 255.0
    want = np.asarray(jaug.crop_resize_bilinear(jnp.asarray(x), *(jnp.asarray(v) for v in box),
                                                48))
    got = taug.crop_resize_bilinear(torch.from_numpy(x)[None],
                                    *(torch.tensor([v]) for v in box), 48)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_crop_resize_batches_boxes():
    x = torch.from_numpy(np.random.default_rng(1).random((3, 50, 60, 1), dtype=np.float32))
    boxes = [(0, 0, 50, 60), (3, 7, 33, 41), (10, 2, 40, 40)]
    cols = [torch.tensor(c) for c in zip(*boxes)]
    batched = taug.crop_resize_bilinear(x, *cols, 32)
    for b, box in enumerate(boxes):
        one = taug.crop_resize_bilinear(x[b : b + 1], *(torch.tensor([v]) for v in box), 32)
        np.testing.assert_allclose(batched[b].numpy(), one[0].numpy(), rtol=0, atol=1e-6)


def test_sample_crop_box_bounds_and_distribution():
    h, w = 96, 128
    gen = torch.Generator().manual_seed(0)
    i, j, ch, cw = (v.numpy() for v in taug.sample_crop_box(gen, 400, h, w))
    assert (i >= 0).all() and (j >= 0).all() and ((i + ch) <= h).all() and ((j + cw) <= w).all()
    area = ch * cw / (h * w)
    assert area.min() > 0.6 and area.max() <= 1.0
    assert ((cw / ch > 0.70) & (cw / ch < 1.43)).all()
    assert len(np.unique(ch)) > 10 and len(np.unique(i)) > 5
    # a source the 10 draws never fit: the clamped centre fallback
    i, j, ch, cw = (v.tolist() for v in taug.sample_crop_box(gen, 5, 10, 200))
    assert set(zip(i, j, ch, cw)) == {(0, 93, 10, 13)} == {jaug._fallback_box(10, 200, (0.75, 4 / 3))}


def test_random_mask_reference_semantics():
    # 224 / 32 = 7 coarse grid, ceil(49 * 0.6) = 30 masked, x4 to the token grid
    m = taug.random_mask(torch.Generator().manual_seed(3), 5, 7, 30, 4).numpy()
    assert m.shape == (5, 28, 28) and m.dtype == np.int32
    assert set(np.unique(m)) <= {0, 1}
    coarse = m[:, ::4, ::4]
    assert (coarse.sum((1, 2)) == 30).all()
    assert (m == coarse.repeat(4, 1).repeat(4, 2)).all()
    assert len({c.tobytes() for c in coarse}) == 5  # a permutation per image


def test_simmim_augment_shapes_determinism_and_flips():
    rng = np.random.default_rng(1)
    batch = torch.from_numpy((rng.random((8, 96, 96)) * 255).astype(np.uint8))
    kw = dict(out_size=64, mask_patch_size=16, model_patch_size=8, mask_ratio=0.6)
    x, m = taug.simmim_augment(batch, torch.Generator().manual_seed(7), **kw)
    assert x.shape == (8, 64, 64, 3) and x.dtype == torch.float32
    assert m.shape == (8, 8, 8) and m.dtype == torch.int32
    assert torch.equal(x[..., 0], x[..., 2])  # gray broadcast to RGB
    assert (m[:, ::2, ::2].sum((1, 2)) == math.ceil(16 * 0.6)).all()
    x2, m2 = taug.simmim_augment(batch, torch.Generator().manual_seed(7), **kw)
    assert torch.equal(x, x2) and torch.equal(m, m2)
    x3, _ = taug.simmim_augment(batch, torch.Generator().manual_seed(8), **kw)
    assert float((x - x3).abs().max()) > 1e-3
    assert float(x.min()) >= -1e-6 and float(x.max()) <= 1 + 1e-6
    # flips are live: a full-frame box on a ramp comes out in all 4 orientations
    ramp = torch.arange(64 * 64, dtype=torch.float32).reshape(1, 64, 64).expand(64, 64, 64)
    seen = set()
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        out, _ = taug.simmim_augment(ramp, gen, out_size=32, mask_patch_size=16,
                                     model_patch_size=8, mask_ratio=0.5, scale=(1.0, 1.0),
                                     ratio=(1.0, 1.0))
        for o in out[..., 0]:
            seen.add((bool(o[0, 0] > o[0, -1]), bool(o[0, 0] > o[-1, 0])))
    assert seen == {(False, False), (False, True), (True, False), (True, True)}
    with pytest.raises(ValueError, match="mask_patch_size"):
        taug.simmim_augment(batch, gen, out_size=60, mask_patch_size=16, model_patch_size=8,
                            mask_ratio=0.5)


def test_device_loader_end_to_end(tmp_path):
    rng = np.random.default_rng(0)
    for k in range(5):
        Image.fromarray((rng.random((80, 80)) * 255).astype(np.uint8)).convert("RGB").save(
            tmp_path / f"{k}.png")
    (tmp_path / "broken.png").write_bytes(b"not an image")
    loader = build_simmim_device_loader(str(tmp_path), 2, 64, 16, 8, 0.6, seed=0, device="cpu")
    assert isinstance(loader, DeviceAugLoader) and len(loader) == 2
    b1 = list(loader.epoch(0))
    assert len(b1) == 2 and b1[0][0].shape == (2, 64, 64, 3) and b1[0][1].shape == (2, 8, 8)
    assert loader._src.dtype == torch.uint8 and loader._src.shape == (5, 80, 80)
    b1b = list(loader.epoch(0))
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(b1, b1b))
    b2 = list(loader.epoch(1))
    assert float((b1[0][0] - b2[0][0]).abs().max()) > 1e-3
    host = DeviceAugLoader(loader.paths, 2, 64, 16, 8, 0.6, seed=0, device="cpu",
                           max_resident_bytes=0)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(host.epoch(0), b1))


# --- the MIM CLI ----------------------------------------------------------------------


def _write_eval_set(root, n=2, size=32):
    os.makedirs(root / "images")
    os.makedirs(root / "labels")
    rng = np.random.default_rng(9)
    for i in range(n):
        img = (rng.random((size, size)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"{i}.png")
        Image.fromarray(((img > 128) * 255).astype(np.uint8)).save(root / "labels" / f"{i}.png")
    return str(root)


def _cli_args(tmp_path, src, tag):
    return ["--image_path", src, "--image_size", "32", "--mask_patch_size", "8",
            "--batch_size", "2", "--warmup_epochs", "1", "--epochs", "2", "--device", "cpu",
            "--output", str(tmp_path / f"out_{tag}"), "--output_dir", str(tmp_path / f"log_{tag}")]


def test_mim_cli_eval_wandb_and_roi_masking(tmp_path):
    """--eval_dataset_path scores the encoder after each epoch into the log;
    --wandb 1 writes the shim's JSONL (train scalars, eval scalars) and the
    six mask panels of each epoch; --roi_masking True on the host loader."""
    src = _write_ocm_like(tmp_path / "imgs", 4, size=40)
    ev = _write_eval_set(tmp_path / "ev")
    _, hist = mim.main(_cli_args(tmp_path, src, "a") + [
        "--eval_dataset_path", ev, "--wandb", "1", "--roi_masking", "True"])
    assert len(hist) == 2 and np.isfinite(hist).all()
    log_dir = tmp_path / "log_a"
    log = "".join(p.read_text() for p in log_dir.glob("*.txt"))
    assert log.count("Acc_average") == 2 and log.count("Test: [1/2]") == 2
    lines = [json.loads(x) for x in (log_dir / "wandb_offline.jsonl").read_text().splitlines()]
    assert {ln["step"] for ln in lines if "train_loss" in ln} == {0, 1}
    assert {ln["step"] for ln in lines if "Dice" in ln} == {0, 1}
    panels = {"Input", "Mask", "Masked_Input", "Reconstruction", "Masked_Reconstruction",
              "Complete_Reconstruction"}
    for step in (0, 1):
        names = os.listdir(log_dir / "wandb_images" / f"step{step}")
        assert {n[len("Masks_"):-4] for n in names if n.startswith("Masks_")} == panels


def test_mim_cli_device_aug_trains_two_epochs(tmp_path):
    src = _write_images(tmp_path / "imgs", 6)
    _, hist = mim.main(_cli_args(tmp_path, src, "d") + ["--opts", "DATA.DEVICE_AUG", "True",
                                                       "TRAIN.MLP_REMAT", "gelu"])
    assert len(hist) == 2 and np.isfinite(hist).all()
    log = "".join(p.read_text() for p in (tmp_path / "log_d").glob("*.txt"))
    assert "MLP_REMAT=gelu " in log and "DEVICE_AUG ignored" not in log


def test_mim_cli_device_aug_yields_to_roi_masking(tmp_path):
    """DATA.DEVICE_AUG with --roi_masking: the JAX package's warning, then
    the host loader, which masks ROIs."""
    src = _write_ocm_like(tmp_path / "imgs", 4, size=40)
    args = _cli_args(tmp_path, src, "r")
    args[args.index("--epochs") + 1] = "1"
    _, hist = mim.main(args + ["--roi_masking", "1", "--opts", "DATA.DEVICE_AUG", "True"])
    assert len(hist) == 1
    log = "".join(p.read_text() for p in (tmp_path / "log_r").glob("*.txt"))
    assert "DATA.DEVICE_AUG ignored: roi_masking needs host CC labeling" in log

"""The port's MIM training against the JAX package's, on identical inputs.

The same numpy-made batch and the same initial weights (the JAX package's
init, converted with ``train/checkpoint.mim_state_from_jax_numpy``) go
through one train step of each package. On CPU tensors the port's kernel
wrappers take their plain twins, so this holds the port's whole training
path (model, autograd wiring, loss, clip, AdamW, schedule) against the JAX
step; the twins are held against the CUDA kernels on the card.

AdamW's epsilon is raised to 1e-3 in the parity steps: with the default
1e-8 the first update is lr * sign(g) almost everywhere, so a gradient that
is ~1e-9 in one package and ~-1e-9 in the other moves a parameter by 2 lr;
with 1e-3 the update is smooth in g and an f32 gradient difference stays an
f32-sized parameter difference.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu.data import build_simmim_loader as jax_loader
from vit_ocm_wmsegmentation_tpu.models import simmim as jsim
from vit_ocm_wmsegmentation_tpu.models.vit import ViTConfig as JViTConfig
from vit_ocm_wmsegmentation_tpu.train import optim as joptim
from vit_ocm_wmsegmentation_tpu.train import schedule as jschedule
from vit_ocm_wmsegmentation_tpu.train.mim_trainer import amp_cast
from vit_ocm_wmsegmentation_tpu.train.mim_trainer import make_train_step as jax_step
from vit_ocm_wmsegmentation_tpu.utils.config import default_config as jax_default_config
from vit_ocm_wmsegmentation_tpu_torch import mim
from vit_ocm_wmsegmentation_tpu_torch.data.datasets import build_simmim_loader
from vit_ocm_wmsegmentation_tpu_torch.data.mask_generator import MaskGenerator
from vit_ocm_wmsegmentation_tpu_torch.models import simmim
from vit_ocm_wmsegmentation_tpu_torch.models.vit import ViTConfig
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as ckpt
from vit_ocm_wmsegmentation_tpu_torch.train import optim, schedule
from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step
from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

from port_helpers import check_step_outputs_and_updates
from port_helpers import one_torch_thread  # noqa: F401  (autouse)

GEOM = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2, pretrain_img_size=32)


def _cfgs(**train):
    """The same config tree in both packages (test_train.py::_tiny_cfg)."""
    out = []
    for cfg in (jax_default_config(), default_config()):
        cfg.DATA.IMG_SIZE = 32
        cfg.DATA.MASK_PATCH_SIZE = 8
        cfg.TRAIN.EPOCHS = 2
        cfg.TRAIN.WARMUP_EPOCHS = 0
        cfg.TRAIN.BASE_LR = 1e-3
        cfg.TRAIN.WEIGHT_DECAY = 0.0
        cfg.TRAIN.OPTIMIZER.EPS = 1e-3
        for k, v in train.items():
            cfg.TRAIN[k] = v
        out.append(cfg)
    return out


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 32, 32, 3), dtype=np.float32)
    mask = np.stack([MaskGenerator(32, 8, 8, 0.5)(rng) for _ in range(n)])
    return x, mask


def _models(seed=0):
    jcfg = JViTConfig(**GEOM)
    params = jsim.init(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = simmim.SimMIM(ViTConfig(**GEOM))
    model.load_state_dict(ckpt.mim_state_from_jax_numpy(tree, model.cfg))
    return jcfg, params, model


def _assert_params_match(model, jparams, atol_rel):
    want = ckpt.mim_state_from_jax_numpy(jax.tree.map(np.asarray, jparams), model.cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= atol_rel * max(1.0, float(w.abs().max())), f"{k}: {err:.3e}"


@pytest.mark.parametrize("amp", [False, True])
def test_mim_step_matches_jax(amp):
    """f32: loss and grad norm to rtol 1e-4, every updated parameter within
    1e-5 * max(1, max|p|). AMP (bf16 forward and backward, f32 masters): the
    two packages round at the same points but sum in other orders; where
    bf16 x_rec lands within an ulp of x the L1 gradient's sign flips, so
    gradients differ by up to ~10 % of their scale (1-9 % per tensor
    measured here). Loss and grad norm to 1e-2, every gradient within 15 % of
    its tensor's max|g|, every parameter within one update's size (lr = 1e-3)
    * max(1, max|p|)."""
    jcfg, jparams, model = _models()
    jc, tc = _cfgs()
    x, mask = _batch()
    if amp:
        live = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        loss, _, _ = torch.func.functional_call(
            model, live, (torch.from_numpy(x).bfloat16(), torch.from_numpy(mask)))
        grads = torch.autograd.grad(loss, list(model.parameters()))

        def jloss_fn(p):
            xb = jnp.asarray(x).astype(jnp.bfloat16)
            return jsim.mim_loss(amp_cast(p), jcfg, xb, jnp.asarray(mask), train=True)[0]

        want = ckpt.mim_state_from_jax_numpy(
            jax.tree.map(np.asarray, jax.grad(jloss_fn)(jparams)), model.cfg)
        for (name, _), g in zip(model.named_parameters(), grads):
            err = float((g - want[name]).abs().max())
            assert err <= 0.15 * float(want[name].abs().max()), f"d{name}: {err:.3e}"
    sched = jschedule.build_schedule(jc, 1)
    tx = joptim.build_optimizer(jc, jparams, sched)
    jparams, _, jloss, jgnorm = jax_step(jcfg, tx, amp=amp)(
        jparams, tx.init(jparams), jnp.asarray(x), jnp.asarray(mask))
    step = make_train_step(model, optim.Optimizer(tc, model, schedule.build_schedule(tc, 1)),
                           amp=amp)
    loss, gnorm = step(torch.from_numpy(x), torch.from_numpy(mask))
    rtol = 1e-2 if amp else 1e-4
    assert float(loss) == pytest.approx(float(jloss), rel=rtol)
    assert float(gnorm) == pytest.approx(float(jgnorm), rel=rtol)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _assert_params_match(model, jparams, 1e-3 if amp else 1e-5)


def test_accumulation_matches_jax_multisteps():
    """ACCUMULATION_STEPS=2: the mean of two micro-batch gradients, clipped
    and applied once, the schedule read at t*k + k - 1 (optax.MultiSteps)."""
    jcfg, jparams, model = _models(seed=1)
    jc, tc = _cfgs(ACCUMULATION_STEPS=2, WARMUP_EPOCHS=1)
    sched = jschedule.build_schedule(jc, 4)
    tx = joptim.build_optimizer(jc, jparams, sched)
    jstep = jax_step(jcfg, tx)
    opt = optim.Optimizer(tc, model, schedule.build_schedule(tc, 4))
    step = make_train_step(model, opt)
    state = tx.init(jparams)
    for seed in (1, 2):
        x, mask = _batch(2, seed)
        jparams, state, _, _ = jstep(jparams, state, jnp.asarray(x), jnp.asarray(mask))
        step(torch.from_numpy(x), torch.from_numpy(mask))
    assert opt.updates == 1
    _assert_params_match(model, jparams, 1e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_step_returns_each_calls_own_outputs_and_updates_once(k):
    """Five calls of the step with ACCUMULATION_STEPS k: fresh loss and
    grad-norm tensors a call, each keeping its own step's values, and one
    update at the schedule's rate every k calls (port_helpers; the card
    tests run the same check on CUDA, where k = 1 replays a CUDA graph)."""
    check_step_outputs_and_updates(torch.device("cpu"), k)


def test_optimizer_loads_a_capturable_state_on_the_cpu():
    """An optimizer state as a CUDA run writes it (AdamW's groups capturable,
    the rate a tensor) loads into the CPU's optimizer: its groups stay
    non-capturable, the next update runs at the schedule's float rate, and
    the step count carries on."""
    tc = _cfgs()[1]
    x, mask = (torch.from_numpy(a) for a in _batch(2))
    model = simmim.init(ViTConfig(**GEOM), torch.Generator().manual_seed(5))
    opt = optim.Optimizer(tc, model, lambda t: 1e-3)
    make_train_step(model, opt)(x, mask)
    state = opt.state_dict()
    for g in state["opt"]["param_groups"]:
        g["capturable"], g["lr"] = True, torch.tensor(0.5)
    for st in state["opt"]["state"].values():
        st["step"] = st["step"].float()
    opt2 = optim.Optimizer(tc, model, lambda t: 1e-3)
    opt2.load_state_dict(state)
    assert [g["capturable"] for g in opt2.opt.param_groups] == [False, False]
    make_train_step(model, opt2)(x, mask)
    assert opt2.updates == 2
    assert [g["lr"] for g in opt2.opt.param_groups] == [1e-3, 1e-3]
    assert {float(st["step"]) for st in opt2.opt.state.values()} == {2.0}


def test_decay_groups_follow_the_reference_per_tensor():
    """The port exempts every 1-D tensor and bias from weight decay, per
    tensor (optimizer.py:23-29). The JAX package's decay_mask tests ndim > 1
    on its depth-stacked tree, so its block LayerNorm scales and biases and
    its block linear biases (depth, .) are decayed: a known difference of
    the JAX package (ROADMAP Queue 3). Both agree on the top-level leaves."""
    _, jparams, model = _models()
    jmask = joptim.decay_mask(jparams)
    decay, no_decay = optim.decay_groups(model)
    name = {id(p): n for n, p in model.named_parameters()}
    port_decayed = {name[id(p)] for p in decay}
    assert {name[id(p)] for p in no_decay} == {
        n for n, p in model.named_parameters() if p.ndim == 1}
    for n in ("blocks.0.norm1.weight", "blocks.1.attn.qkv.bias", "blocks.0.mlp.fc2.bias"):
        assert "encoder." + n not in port_decayed
    assert bool(jmask["blocks"]["norm1"]["scale"]) and bool(jmask["blocks"]["attn"]["bqkv"])
    assert bool(jmask["blocks"]["mlp"]["b2"])
    for jleaf, n in ((jmask["pos_embed"], "encoder.pos_embed"),
                     (jmask["mask_token"], "encoder.mask_token"),
                     (jmask["blocks"]["attn"]["wqkv"], "encoder.blocks.0.attn.qkv.weight"),
                     (jmask["decoder"]["kernel"], "decoder.0.weight")):
        assert bool(jleaf) and n in port_decayed
    for jleaf, n in ((jmask["norm"]["scale"], "encoder.norm.weight"),
                     (jmask["patch_embed"]["bias"], "encoder.patch_embed.proj.bias"),
                     (jmask["decoder"]["bias"], "decoder.0.bias")):
        assert not bool(jleaf) and n not in port_decayed


def test_clip_scales_only_at_or_above_max_norm():
    """optax's clip_by_global_norm: g / norm * max_norm when norm >= max_norm,
    g unchanged below, no epsilon."""
    _, tc = _cfgs(CLIP_GRAD=1.0)
    tc.TRAIN.OPTIMIZER.NAME = "sgd"  # first Nesterov step: p -= lr * (1 + momentum) * g
    for g, scale in (([3.0, 4.0], 0.2), ([0.3, 0.4], 1.0), ([0.6, 0.8], 1.0)):
        holder = torch.nn.Module()
        holder.w = torch.nn.Parameter(torch.zeros(2))
        optim.Optimizer(tc, holder, lambda t: 1.0).step([torch.tensor(g)])
        want = -1.9 * scale * np.asarray(g)  # norms 5 (clipped to 1), 0.5, 1.0 (at the limit)
        np.testing.assert_allclose(holder.w.detach().numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["cosine", "linear", "step", "multistep"])
def test_schedules_equal_build_schedule(name):
    jc, tc = _cfgs(EPOCHS=12, WARMUP_EPOCHS=2)
    for cfg in (jc, tc):
        cfg.TRAIN.LR_SCHEDULER.NAME = name
        cfg.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 3
        cfg.TRAIN.LR_SCHEDULER.MULTISTEPS = [4, 7]
    jfn, tfn = jschedule.build_schedule(jc, 5), schedule.build_schedule(tc, 5)
    for t in (0, 1, 4, 9, 10, 11, 20, 34, 35, 36, 59):
        assert tfn(t) == pytest.approx(float(jfn(jnp.asarray(t))), rel=1e-5, abs=1e-12), t


def _write_images(path, n, size=40):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((size, size + 8)) * 255).astype(np.uint8)).save(
            os.path.join(path, f"img{i}.png"))
    return str(path)


def test_mask_generator_and_loader_batches_equal_jax(tmp_path):
    src = _write_images(tmp_path / "imgs", 6)
    args = (src, 2, 32, 8, 8, 0.5)
    jl, tl = jax_loader(*args, seed=3), build_simmim_loader(*args, seed=3)
    assert len(jl) == len(tl) == 3
    for epoch in (0, 1):
        pairs = list(zip(jl.epoch(epoch), tl.epoch(epoch)))
        assert len(pairs) == 3
        for (jx, jm), (tx_, tm) in pairs:
            np.testing.assert_array_equal(jx, tx_)
            np.testing.assert_array_equal(jm, tm)


def test_mim_cli_trains_and_resumes_on_cpu(tmp_path):
    """Two epochs, then a third into the same output: the second call
    resumes at epoch 2 with the optimizer state (AdamW steps continue)."""
    src = _write_images(tmp_path / "imgs", 8)
    args = ["--image_path", src, "--image_size", "32", "--mask_patch_size", "8",
            "--batch_size", "4", "--warmup_epochs", "1", "--device", "cpu",
            "--output", str(tmp_path / "out"), "--output_dir", str(tmp_path / "log")]
    _, hist = mim.main(args + ["--epochs", "2"])
    _, hist2 = mim.main(args + ["--epochs", "3", "--opts", "AMP_OPT_LEVEL", "O1"])
    assert len(hist) == 2 and len(hist2) == 1 and np.isfinite(hist + hist2).all()
    run = tmp_path / "out" / "vit_small" / "AM_32_Experimental_Run"
    assert sorted(os.listdir(run))[:3] == ["ckpt_epoch_0", "ckpt_epoch_1", "ckpt_epoch_2"]
    state = torch.load(run / "ckpt_epoch_2", weights_only=False)
    assert state["epoch"] == 2 and state["optimizer"]["updates"] == 6
    assert {int(s["step"]) for s in state["optimizer"]["opt"]["state"].values()} == {6}


def test_mim_cli_refuses_what_is_not_ported(tmp_path):
    """One process: TRAIN.PP_STAGES 2 has no ranks to divide into stages and
    raises; TRAIN.FSDP has no 'data' axis to shard over and is ignored with
    a warning in the log, as the JAX trainer does (the multi-rank paths:
    tests/test_torch_parallel_cli.py)."""
    src = _write_images(tmp_path / "imgs", 4)
    base = ["--image_path", src, "--image_size", "32", "--mask_patch_size", "8",
            "--batch_size", "4", "--epochs", "1", "--warmup_epochs", "0", "--device", "cpu",
            "--output", str(tmp_path / "o"), "--output_dir", str(tmp_path / "l")]
    with pytest.raises(ValueError, match="PP_STAGES=2 does not divide 1 ranks"):
        mim.main(base + ["--opts", "TRAIN.PP_STAGES", "2"])
    _, hist = mim.main(base + ["--opts", "TRAIN.FSDP", "True"])
    assert len(hist) == 1 and np.isfinite(hist).all()
    logs = "".join(p.read_text() for p in tmp_path.rglob("log_rank0.txt"))
    assert "TRAIN.FSDP=True ignored: no multi-rank 'data' axis" in logs


def test_remat_keeps_gradients():
    """TRAIN.USE_CHECKPOINT recomputes each block in the backward: same loss
    and gradients."""
    _, _, model = _models()
    x, mask = (torch.from_numpy(a) for a in _batch(2))
    out = []
    for remat in (False, True):
        loss, _, _ = model(x, mask, remat)
        out.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_keeps_the_amp_step():
    """TRAIN.USE_CHECKPOINT under AMP: the recompute in the backward reads the
    bf16 parameters the forward read, not the f32 ones the step's
    functional_call has put back by then (which raised a dtype mismatch), so
    two steps give the same losses, grad norms and parameters, bit for
    bit, as the step without it."""
    tc = _cfgs()[1]
    out = []
    for remat in (False, True):
        _, _, model = _models()
        step = make_train_step(model, optim.Optimizer(tc, model, lambda t: 1e-3), amp=True,
                               remat=remat)
        read = [tuple(float(t) for t in step(*(torch.from_numpy(a) for a in _batch(2, seed=s))))
                for s in (0, 1)]
        out.append((read, [p.detach().clone() for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mim_checkpoints_load_both_ways(tmp_path):
    """A full MIM state dict replaces every parameter; a bare ViT state dict
    (DINO-style, under "teacher" with a "backbone." prefix) fills the encoder
    and keeps the mask token and decoder."""
    _, _, src = _models(seed=4)
    _, _, dst = _models(seed=5)
    torch.save({"model": src.state_dict()}, tmp_path / "mim.pth")
    ckpt.load_mim_or_vit_checkpoint(str(tmp_path / "mim.pth"), dst)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    _, _, dst = _models(seed=5)
    keep = {k: v.clone() for k, v in dst.state_dict().items()
            if k.startswith("decoder") or k == "encoder.mask_token"}
    enc = {"backbone." + k: v for k, v in src.encoder.state_dict().items() if k != "mask_token"}
    torch.save({"teacher": enc}, tmp_path / "vit.pth")
    ckpt.load_mim_or_vit_checkpoint(str(tmp_path / "vit.pth"), dst)
    for k, v in dst.state_dict().items():
        want = keep[k] if k in keep else src.state_dict()[k]
        assert torch.equal(v, want), k

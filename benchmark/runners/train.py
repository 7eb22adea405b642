"""The training runner: SimMIM pretraining steps of the port, one after
another, fed by the port's device-augmentation loader, as the port's
``mim.py`` trains with ``DATA.DEVICE_AUG``.

Set-up writes the traffic's OCM-like 384^2 source tiles, made from the seed,
as PNG files into the run's temporary directory, builds the loader
(``data.datasets.build_simmim_device_loader``) and one training object: the
SimMIM model with the seed's weights, ``train.optim.Optimizer`` on
``train.schedule``'s schedule and ``train.mim_trainer.make_train_step``'s
step. It drives that object through its first three steps, which the
reference follows, keeping their batches, the losses, AdamW's first moment
after step 1 and the parameters after step 3, and hands the same object to
the window. The window runs steps until ``seconds`` have passed, then waits
for the device; the rate is the images of every step over the whole window,
the loader's work included.

Correctness (after the window, the program freed): the plain reference derives
the three batches again from the seed's sources (``reference/augment.py``, the
feed's own random protocol) and runs the three steps from the seed's weights
(``reference/simmim.py``), so that a fault in the loader shows in the steps it
feeds. Compared are each step's loss; the norm of the first gradient as the
optimizer got it (its first moment after step 1 over 1 - beta1), leaf by leaf;
and the norm of each leaf's change over the three steps, each gap taken
against the reference's norm of that leaf or of the median leaf, whichever is
larger, and the worst leaf kept. A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left out of
the change.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from .. import inputs
from ..reference import augment
from ..reference import simmim as ref
from ..reference.precision import matmul_flags
from ..tracing import Capture, Phases, Spans
from ..weights import make_state

JUDGED_STEPS = 3
ZERO_GRAD = 1e-3


def optimizer_config(cell, loader_len: int) -> dict:
    o, t = cell.config["optimizer"], cell.traffic
    return {"base_lr": o["base_lr"], "warmup_lr": o["warmup_lr"], "min_lr": o["min_lr"],
            "warmup_steps": int(t["warmup_epochs"] * loader_len),
            "total_steps": int(t["epochs"] * loader_len),
            "clip_grad": o["clip_grad"], "betas": tuple(o["betas"]), "eps": o["eps"],
            "weight_decay": o["weight_decay"]}


class ProgramTrainer:
    """The port's training object: model, optimizer and step."""

    def __init__(self, cell, state, device, loader_len):
        from vit_ocm_wmsegmentation_tpu_torch.models import simmim
        from vit_ocm_wmsegmentation_tpu_torch.models.vit import ViTConfig
        from vit_ocm_wmsegmentation_tpu_torch.pipeline import exact_matmuls
        from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import (make_train_step,
                                                                        train_routes)
        from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer
        from vit_ocm_wmsegmentation_tpu_torch.train.schedule import build_schedule
        from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

        c, t, o = cell.config, cell.traffic, cell.config["optimizer"]
        cfg = default_config()
        cfg.defrost()
        cfg.DATA.IMG_SIZE, cfg.DATA.BATCH_SIZE = t["img_size"], t["batch"]
        cfg.DATA.MASK_PATCH_SIZE, cfg.DATA.MASK_RATIO = t["mask_patch"], t["mask_ratio"]
        cfg.MODEL.PATCH_SIZE = c["patch_size"]
        cfg.AMP_OPT_LEVEL = t["amp_opt_level"]
        cfg.TRAIN.EPOCHS, cfg.TRAIN.WARMUP_EPOCHS = t["epochs"], t["warmup_epochs"]
        cfg.TRAIN.BASE_LR, cfg.TRAIN.WARMUP_LR, cfg.TRAIN.MIN_LR = (o["base_lr"], o["warmup_lr"],
                                                                    o["min_lr"])
        cfg.TRAIN.WEIGHT_DECAY, cfg.TRAIN.CLIP_GRAD = o["weight_decay"], o["clip_grad"]
        cfg.TRAIN.OPTIMIZER.NAME, cfg.TRAIN.OPTIMIZER.EPS = "adamw", o["eps"]
        cfg.TRAIN.OPTIMIZER.BETAS = tuple(o["betas"])
        cfg.freeze()
        vcfg = ViTConfig(patch_size=c["patch_size"], embed_dim=c["embed_dim"], depth=c["depth"],
                         num_heads=c["num_heads"], mlp_ratio=c["mlp_ratio"],
                         qkv_bias=c["qkv_bias"], ln_eps=c["ln_eps"],
                         pretrain_img_size=c["img_size"])
        with torch.device("meta"):
            self.model = simmim.SimMIM(vcfg)
        self.model.load_state_dict(state, assign=True)
        self.model.requires_grad_(True)
        self.optimizer = Optimizer(cfg, self.model, build_schedule(cfg, loader_len))
        amp = cfg.AMP_OPT_LEVEL not in ("", "O0")
        self._step = make_train_step(self.model, self.optimizer, amp=amp,
                                     remat=bool(cfg.TRAIN.USE_CHECKPOINT),
                                     routes=train_routes(cfg))
        self.context = exact_matmuls

    def step(self, x, mask):
        return self._step(x, mask)[0]

    def params(self) -> dict:
        return {n: p.detach() for n, p in self.model.named_parameters()}

    def first_moment(self) -> dict:
        st = self.optimizer.opt.state
        return {n: st[p]["exp_avg"] if p in st and "exp_avg" in st[p] else torch.zeros_like(p)
                for n, p in self.model.named_parameters()}


class ReferenceTrainer:
    """The plain reference in the program's place (the controls), in
    ``precision``."""

    def __init__(self, cell, state, device, loader_len, precision="fp8"):
        self.ref = ref.Trainer(state, cell.config, optimizer_config(cell, loader_len), precision)
        self.context = contextlib.nullcontext

    def step(self, x, mask):
        return torch.tensor(self.ref.step(x, mask))

    def params(self) -> dict:
        return self.ref.params

    def first_moment(self) -> dict:
        return self.ref.m


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def worst_leaf_gap(got: dict, want: dict, names) -> float:
    """max over ``names`` of |got - want| / max(want, the median of want)."""
    names = list(names)
    if not names:
        return float("nan")
    med = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def judge(cell, seed, record, loader_len, device) -> dict:
    """The compared numbers of the three set-up steps (module docstring)."""
    t, c = cell.traffic, cell.config
    state0 = make_state(c, seed, device)
    opt = optimizer_config(cell, loader_len)
    rt = ref.Trainer(state0, c, opt, "float32")
    tiles = inputs.source_tiles(t["img_size"], t["source_rows"], t["source_cols"], t["blob"],
                                seed, device)
    losses, g1 = [], None
    for k in range(JUDGED_STEPS):
        epoch, batch = divmod(k, loader_len)
        with matmul_flags("float32"):
            x, mask = augment.augment(tiles, seed, epoch, batch, t["batch"], t["img_size"],
                                      t["mask_patch"], c["patch_size"], t["mask_ratio"])
        losses.append(rt.step(x, mask))
        if k == 0:
            g1 = _norms(rt.last_grads)
    b1 = opt["betas"][0]
    g1p = {n: v / (1.0 - b1) for n, v in _norms(record["m1"]).items()}
    start = {n: t.float() for n, t in state0.items()}
    dr = _norms({n: rt.params[n] - start[n] for n in start})
    dp = _norms({n: record["theta3"][n].to(device).float() - start[n] for n in start})
    med = float(np.median(list(g1.values())))
    moving = [n for n in start if g1[n] >= ZERO_GRAD * med]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(record["losses"], losses))
    return {"loss_rel": loss_rel, "grad1_leaf": worst_leaf_gap(g1p, g1, start),
            "delta3_leaf": worst_leaf_gap(dp, dr, moving)}


def run(cell, seed, seconds, trace, device, tmpdir, trainer_factory=None):
    """One run of a training cell. ``trainer_factory(cell, state, device,
    loader_len)`` replaces the program (controls and fault tests)."""
    from vit_ocm_wmsegmentation_tpu_torch.data.datasets import build_simmim_device_loader

    t, c = cell.traffic, cell.config
    spans, phases = Spans(bool(trace)), Phases()
    from vit_ocm_wmsegmentation_tpu_torch.train import mim_trainer  # noqa: F401

    phases.mark("port_imports")
    cuda = device.type == "cuda"
    tiles = inputs.source_tiles(t["img_size"], t["source_rows"], t["source_cols"], t["blob"],
                                seed, device)
    src_dir = os.path.join(tmpdir, "sources")
    inputs.write_pngs(tiles, src_dir)
    del tiles
    loader = build_simmim_device_loader(src_dir, t["batch"], t["img_size"], t["mask_patch"],
                                        c["patch_size"], t["mask_ratio"], seed=seed,
                                        device=device)
    loader_len = len(loader)
    phases.mark("sources_and_loader")
    state = make_state(c, seed, device)
    trainer = (trainer_factory or ProgramTrainer)(cell, state, device, loader_len)
    del state
    phases.mark("weights_and_model")

    def batches():
        for epoch in range(t["epochs"] * 1_000_000):
            yield from loader.epoch(epoch)

    feed = batches()

    def next_batch():
        with spans("loader"):
            return next(feed)

    record = {"losses": []}
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    view = None
    with trainer.context():
        for k in range(JUDGED_STEPS):
            x, mask = next_batch()
            record["losses"].append(trainer.step(x, mask))
            if k == 0:
                record["m1"] = {n: v.detach().cpu().clone() for n, v in
                                trainer.first_moment().items()}
        record["theta3"] = {n: v.detach().cpu().clone() for n, v in trainer.params().items()}
        record["losses"] = [float(v) for v in record["losses"]]
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        phases.mark("three_judged_steps")
        losses = []
        t0 = time.perf_counter()
        if trace:
            with Capture(tmpdir) as cap:
                for _ in range(t["trace_steps"]):
                    x, mask = next_batch()
                    with spans("step"):
                        losses.append(trainer.step(x, mask))
                sync()
        while time.perf_counter() < t0 + seconds:
            x, mask = next_batch()
            with spans("step"):
                losses.append(trainer.step(x, mask))
        sync()
        t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int((~torch.isfinite(torch.stack([torch.as_tensor(v).float() for v in losses]))).sum())
    del trainer, feed, loader
    if cuda:
        torch.cuda.empty_cache()
    if trace:
        n = t["trace_steps"]
        view = cap.view({"steps": n, "images": n * t["batch"], "batches": n})
    numbers = judge(cell, seed, record, loader_len, device)
    metrics = {"train_img_per_s": len(losses) * t["batch"] / (t_end - t0),
               "peak_mem_gib": peak / 2**30}
    if any(not math.isfinite(v) for v in record["losses"]):
        failed += 1
    return {"metrics": metrics, "attempted": len(losses), "failed": failed, "numbers": numbers,
            "unjudged": 0, "memory_peak_bytes": peak, "view": view, "t0": t0,
            "phases": phases.done}

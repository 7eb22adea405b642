"""Image-classification training loop (the Allen-brain Swin experiment).

Counterpart of ``vit_ocm_wmsegmentation_tpu/train/classifier.py``, the
rebuild of Allen_data_Backbone/train.py's HF-Trainer setup: AdamW at lr
5e-5 with weight decay 0, linear warmup over the first 10 % of the
optimizer steps then linear decay (HF's defaults), gradient accumulation
4, per-epoch accuracy, the best-accuracy weights kept.

:class:`AccumulatedAdamW` is ``optax.MultiSteps(optax.adamw(schedule,
weight_decay=0.0), k)``: each micro-step folds its gradients into a running
mean (MultiSteps' Welford update), every k-th applies AdamW with the
schedule read at the optimizer step count, and a partial accumulation
carries over into the next epoch. ``amp`` is the MIM trainer's rule
(``train/mim_trainer.amp_cast``): bf16 copies of the f32 master weights and
a bf16 input inside the step, gradients back in f32 through the casts, the
cross-entropy in f32.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..pipeline import exact_matmuls
from .mim_trainer import amp_cast


def hf_linear_schedule(base_lr, total_steps, warmup_ratio=0.1):
    """HF get_linear_schedule_with_warmup: t -> learning rate."""
    warmup = int(total_steps * warmup_ratio)

    def fn(t):
        if t < warmup:
            return base_lr * t / max(warmup, 1)
        return base_lr * max(total_steps - t, 0) / max(total_steps - warmup, 1)

    return fn


class AccumulatedAdamW:
    """optax.MultiSteps(optax.adamw(schedule, weight_decay=0.0), k) over
    ``params``. :meth:`step` takes one micro-batch's gradients (aligned with
    ``params``); returns whether an update was applied."""

    def __init__(self, params, schedule, k: int = 1):
        self.params = list(params)
        self.opt = torch.optim.AdamW(self.params, lr=0.0, weight_decay=0.0)
        self.schedule, self.k = schedule, max(int(k), 1)
        self.updates = 0  # optimizer steps applied (the schedule's count)
        self.mini = 0  # micro-steps accumulated since the last update
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    def step(self, grads) -> bool:
        diff = torch._foreach_sub([g.float() for g in grads], self.acc)
        torch._foreach_div_(diff, float(self.mini + 1))
        torch._foreach_add_(self.acc, diff)
        self.mini += 1
        if self.mini < self.k:
            return False
        for group in self.opt.param_groups:
            group["lr"] = float(self.schedule(self.updates))
        for p, a in zip(self.params, self.acc):
            p.grad = a.to(p.dtype)
        self.opt.step()
        for p in self.params:
            p.grad = None
        torch._foreach_zero_(self.acc)
        self.mini = 0
        self.updates += 1
        return True


def make_classifier_step(model, optimizer: AccumulatedAdamW, *, amp: bool = False):
    """model(x (B, H, W, 3)) -> logits. Returns train_step(x, y) -> loss (the
    mean cross-entropy of integer labels, in f32; one micro-step of
    ``optimizer``) and eval_step(x, y) -> number correct, on the model's
    device."""
    params = [p for p in model.parameters() if p.requires_grad]

    def logits_of(x):
        if not amp:
            return model(x)
        live = amp_cast(dict(model.named_parameters()))
        return torch.func.functional_call(model, live, (x.to(torch.bfloat16),))

    def train_step(x, y):
        loss = F.cross_entropy(logits_of(x).float(), y)
        optimizer.step(torch.autograd.grad(loss, params))
        return loss.detach()

    @torch.no_grad()
    def eval_step(x, y):
        return (torch.argmax(logits_of(x), dim=-1) == y).sum()

    return train_step, eval_step


def train_classifier(model, train_batches, eval_batches, *, epochs=3, lr=5e-5, grad_accum=4,
                     steps_per_epoch=None, logger=print, amp=False):
    """train_batches / eval_batches: callables epoch -> iterator of (x, y)
    numpy arrays, x (B, H, W, 3) float in [0, 1], y (B,) int. Trains
    ``model`` in place on its device and loads the best-accuracy weights
    back at the end; returns (model, history). The schedule spans
    ``steps_per_epoch`` (100 when None) x epochs micro-steps, counted in
    optimizer steps. Library matmuls run under ``pipeline.exact_matmuls()``."""
    device = next(model.parameters()).device
    n_steps = (steps_per_epoch or 100) * epochs
    schedule = hf_linear_schedule(lr, max(n_steps // max(grad_accum, 1), 1))
    optimizer = AccumulatedAdamW([p for p in model.parameters() if p.requires_grad], schedule,
                                 grad_accum)
    train_step, eval_step = make_classifier_step(model, optimizer, amp=amp)

    def to_dev(x, y):
        return (torch.as_tensor(np.asarray(x, np.float32)).to(device),
                torch.as_tensor(np.asarray(y)).long().to(device))

    best_acc, history = -1.0, []
    best = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with exact_matmuls():
        for epoch in range(epochs):
            t0 = time.time()
            losses, n_seen = [], 0
            for x, y in train_batches(epoch):
                losses.append(train_step(*to_dev(x, y)))  # one sync an epoch
                n_seen += len(x)
            losses = [float(v) for v in losses]
            correct = total = 0
            for x, y in eval_batches(epoch):
                correct += int(eval_step(*to_dev(x, y)))
                total += len(y)
            acc = correct / max(total, 1)
            dt = time.time() - t0
            logger(f"epoch {epoch}: train_loss {np.mean(losses):.4f}  eval_accuracy {acc:.4f}  "
                   f"({n_seen / max(dt, 1e-9):.2f} samples/s train)")
            history.append({"epoch": epoch, "train_loss": float(np.mean(losses)),
                            "eval_accuracy": acc})
            if acc > best_acc:
                best_acc = acc
                best = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(best)
    return model, history

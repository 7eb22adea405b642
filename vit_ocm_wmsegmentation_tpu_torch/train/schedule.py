"""Per-iteration learning-rate schedules (the reference's lr_scheduler.py:18-152).

Counterpart of ``vit_ocm_wmsegmentation_tpu/train/schedule.py`` as plain
Python functions of the raw update step t (timm schedulers with
``t_in_epochs=False``):

* cosine: linear warmup to base_lr, then lr_min + (base_lr - lr_min)/2 *
  (1 + cos(pi t / t_total)) with t counted from 0, warmup included;
* linear: base -> base * lr_min_rate over the post-warmup span;
* step: base * decay_rate^((t - warmup) // decay_t);
* multistep: base * gamma^(number of milestones <= t).
"""

from __future__ import annotations

import bisect
import math


def _warm(base_lr, warmup_lr, warmup_steps, t):
    return warmup_lr + t * (base_lr - warmup_lr) / max(warmup_steps, 1)


def cosine_lr(base_lr, min_lr, warmup_lr, warmup_steps, total_steps):
    def fn(t):
        if t < warmup_steps:
            return _warm(base_lr, warmup_lr, warmup_steps, t)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t / total_steps))

    return fn


def linear_lr(base_lr, warmup_lr, warmup_steps, total_steps, lr_min_rate=0.01):
    def fn(t):
        if t < warmup_steps:
            return _warm(base_lr, warmup_lr, warmup_steps, t)
        span = max(total_steps - warmup_steps, 1)
        return base_lr - (base_lr - base_lr * lr_min_rate) * ((t - warmup_steps) / span)

    return fn


def step_lr(base_lr, warmup_lr, warmup_steps, decay_steps, decay_rate):
    def fn(t):
        if t < warmup_steps:
            return _warm(base_lr, warmup_lr, warmup_steps, t)
        return base_lr * decay_rate ** (max(t - warmup_steps, 0) // decay_steps)

    return fn


def multistep_lr(base_lr, warmup_lr, warmup_steps, milestones, gamma):
    milestones = sorted(milestones)

    def fn(t):
        if t < warmup_steps:
            return _warm(base_lr, warmup_lr, warmup_steps, t)
        return base_lr * gamma ** bisect.bisect_right(milestones, t)

    return fn


def build_schedule(cfg, n_iter_per_epoch: int):
    """build_scheduler (lr_scheduler.py:18-63) from a config tree."""
    num_steps = int(cfg.TRAIN.EPOCHS * n_iter_per_epoch)
    warmup_steps = int(cfg.TRAIN.WARMUP_EPOCHS * n_iter_per_epoch)
    decay_steps = int(cfg.TRAIN.LR_SCHEDULER.DECAY_EPOCHS * n_iter_per_epoch)
    tr = cfg.TRAIN
    name = tr.LR_SCHEDULER.NAME
    if name == "cosine":
        return cosine_lr(tr.BASE_LR, tr.MIN_LR, tr.WARMUP_LR, warmup_steps, num_steps)
    if name == "linear":
        return linear_lr(tr.BASE_LR, tr.WARMUP_LR, warmup_steps, num_steps)
    if name == "step":
        return step_lr(tr.BASE_LR, tr.WARMUP_LR, warmup_steps, decay_steps,
                       tr.LR_SCHEDULER.DECAY_RATE)
    if name == "multistep":
        milestones = [i * n_iter_per_epoch for i in tr.LR_SCHEDULER.MULTISTEPS]
        return multistep_lr(tr.BASE_LR, tr.WARMUP_LR, warmup_steps, milestones,
                            tr.LR_SCHEDULER.GAMMA)
    raise ValueError(f"unknown scheduler {name!r}")

"""Optimizer of the MIM trainer (the reference's optimizer.py:14-78 and the
clip of mim.py:176), as the JAX package's optax chain computes it.

* AdamW (or SGD with Nesterov momentum) in two parameter groups: weight
  decay for every parameter except 1-D tensors and biases, decided per
  tensor (the reference's rule; the JAX package's ``decay_mask`` tests
  ``ndim > 1`` on its depth-stacked tree, so there every block LayerNorm
  and block bias is decayed too: ROADMAP Queue 3);
* clipping by global norm as optax's ``clip_by_global_norm``: the gradients
  are scaled by max_norm / norm only when norm >= max_norm (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
* the learning rate set from the schedule at update count t (from 0) before
  each step; with ACCUMULATION_STEPS k > 1 the mean of k micro-batch
  gradients is clipped and applied, the schedule read at t*k + k - 1, as
  under ``optax.MultiSteps``;
* on CUDA, AdamW is capturable: its step count and the learning rate live in
  device tensors, so that a CUDA graph of the update (train/mim_trainer.py)
  reads each update's rate. The host part of an update
  (:meth:`Optimizer.next_update`) fills the rate; the device part
  (:meth:`Optimizer.apply`) clips and updates without a host sync.
"""

from __future__ import annotations

import torch


def _no_decay(name: str, ndim: int) -> bool:
    return ndim <= 1 or name.endswith(".bias")


def decay_groups(model):
    """(decay, no_decay) lists of the trainable parameters."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (no_decay if _no_decay(name, p.ndim) else decay).append(p)
    return decay, no_decay


def decay_names(named_shapes):
    """(decay, no_decay) lists of names from (name, shape) pairs: the
    groups, in an Optimizer's order, of a module whose parameters have those
    shapes. A sharded rank decides from the whole tensor's name and shape
    (parallel.mesh.ParamLayout), not from its piece's."""
    decay, no_decay = [], []
    for name, shape in named_shapes:
        (no_decay if _no_decay(name, len(shape)) else decay).append(name)
    return decay, no_decay


def global_norm(grads):
    """The l2 norm of all gradients together, in f32 (a 0-dim tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([g.float() for g in grads])))


class Optimizer:
    """AdamW/SGD with the weight-decay groups, global-norm clipping, the
    per-update schedule and gradient accumulation. :meth:`step` takes one
    micro-batch's gradients, aligned with :attr:`params` (named
    :attr:`names`). :attr:`norm` computes the global norm the clip reads:
    a sharded rank sets ``parallel.mesh.ParamLayout.norm_fn(names)``, which
    sums over the ranks that hold the pieces."""

    def __init__(self, cfg, model, schedule):
        tr = cfg.TRAIN
        decay, no_decay = decay_groups(model)
        name_of = {id(p): n for n, p in model.named_parameters()}
        groups = [{"params": decay, "weight_decay": tr.WEIGHT_DECAY},
                  {"params": no_decay, "weight_decay": 0.0}]
        name = tr.OPTIMIZER.NAME.lower()
        self.params = decay + no_decay
        # AdamW on CUDA: the rate a 0-dim device tensor that next_update fills
        self.capturable = name == "adamw" and self.params[0].is_cuda
        self._lr = (torch.zeros((), device=self.params[0].device) if self.capturable else None)
        if name == "adamw":
            self.opt = torch.optim.AdamW(groups, lr=self._lr if self.capturable else 0.0,
                                         betas=tuple(tr.OPTIMIZER.BETAS), eps=tr.OPTIMIZER.EPS,
                                         capturable=self.capturable)
        elif name == "sgd":
            self.opt = torch.optim.SGD(groups, lr=0.0, momentum=tr.OPTIMIZER.MOMENTUM,
                                       nesterov=True)
        else:
            raise ValueError(f"unknown optimizer {name!r}")
        self.names = [name_of[id(p)] for p in self.params]
        self.norm = global_norm
        self.schedule = schedule
        self.clip = tr.CLIP_GRAD
        self.k = max(int(tr.ACCUMULATION_STEPS), 1)
        self.updates = 0  # optimizer updates applied
        self._acc, self._micro = None, 0

    def lr(self) -> float:
        """The learning rate of the next update."""
        t = self.updates
        return float(self.schedule(t * self.k + self.k - 1 if self.k > 1 else t))

    def next_update(self):
        """The host part of an update: the schedule's rate for it into the
        groups (a fill of the device tensor on CUDA), the count advanced."""
        lr = self.lr()
        if self.capturable:
            self._lr.fill_(lr)
        else:
            for group in self.opt.param_groups:
                group["lr"] = lr
        self.updates += 1

    def apply(self, grads):
        """The device part of an update: clip ``grads`` by their global norm
        and apply them at the rate :meth:`next_update` set."""
        if self.clip:
            # max_norm / norm where norm >= max_norm, else 1, without a
            # device-to-host sync (a branch on the norm would stall the step)
            grads = [g.float() for g in grads]
            torch._foreach_mul_(grads, torch.clamp(self.clip / self.norm(grads), max=1.0))
        for p, g in zip(self.params, grads):
            p.grad = g
        self.opt.step()
        for p in self.params:
            p.grad = None

    def step(self, grads) -> bool:
        """Accumulate one micro-batch's gradients; every k-th call clip the
        mean and apply it. Returns whether an update was applied."""
        if self.k > 1:
            if self._acc is None:
                self._acc = [g.float().clone() for g in grads]
            else:
                for a, g in zip(self._acc, grads):
                    a.add_(g)
            self._micro += 1
            if self._micro < self.k:
                return False
            grads = [a / self.k for a in self._acc]
            self._acc, self._micro = None, 0
        self.next_update()
        self.apply(grads)
        return True

    def state_dict(self):
        return {"opt": self.opt.state_dict(), "updates": self.updates}

    def load_state_dict(self, state):
        """Load :meth:`state_dict`'s, written on any device: the groups keep
        this optimizer's rate and capture mode, and a capturable one's step
        counts move to its parameters' device."""
        self.opt.load_state_dict(state["opt"])
        self.updates = int(state["updates"])
        for group in self.opt.param_groups:
            if "capturable" in group:
                group["capturable"] = self.capturable
            if self.capturable:
                group["lr"] = self._lr
        if self.capturable:
            for p, st in self.opt.state.items():
                if "step" in st:
                    st["step"] = st["step"].to(p.device, torch.float32)

"""DINO self-supervised training components (the reference vendors them in
dino/utils.py and dino/vision_transformer.py).

Counterpart of ``vit_ocm_wmsegmentation_tpu/train/dino.py``:

* :func:`cosine_scheduler`: the per-iteration value array
  (dino/utils.py:157-168);
* :class:`LARS`: the LARS optimizer (dino/utils.py:523-561) as a
  ``torch.optim.Optimizer``, its momentum buffer LR-free (mu = m mu + dp,
  p -= lr mu) and 1-d parameters exempt from weight decay and adaptation;
* :func:`multi_crop_forward`: MultiCropWrapper (dino/utils.py:564-597);
* :class:`DINOHead` (vision_transformer.py:282-316): MLP with GELU, the
  l2-normalized bottleneck, the weight-normalized last layer (g fixed at 1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import nn as tnn


def cosine_scheduler(base_value, final_value, epochs, niter_per_ep, warmup_epochs=0,
                     start_warmup_value=0):
    """Per-iteration schedule array, exactly dino/utils.py:157-168."""
    warmup_iters = warmup_epochs * niter_per_ep
    warmup = (np.linspace(start_warmup_value, base_value, warmup_iters) if warmup_epochs > 0
              else np.array([]))
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    sched = final_value + 0.5 * (base_value - final_value) * (1 + np.cos(np.pi * iters / len(iters)))
    out = np.concatenate([warmup, sched])
    assert len(out) == epochs * niter_per_ep
    return out


class LARS(torch.optim.Optimizer):
    """Layer-wise adaptive rate scaling (dino/utils.py:523-561). Each
    parameter p with gradient g: for p.ndim != 1, dp = g + wd p scaled by the
    trust ratio eta ||p|| / ||dp|| (1 where either norm is 0); 1-d
    parameters (biases, norms) take dp = g. Then mu = momentum mu + dp and
    p -= lr mu: the buffer holds no learning rate, so under a schedule every
    step scales the whole buffer by the current lr."""

    def __init__(self, params, lr=0.0, weight_decay=0.0, momentum=0.9, eta=0.001):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
                                      eta=eta))

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            for p in g["params"]:
                dp = p.grad
                if dp is None:
                    continue
                if p.ndim != 1:
                    dp = dp.add(p, alpha=g["weight_decay"])
                    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(dp)
                    one = torch.ones_like(pn)
                    q = torch.where(pn > 0.0, torch.where(un > 0, g["eta"] * pn / un, one), one)
                    dp = dp.mul(q)
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                mu.mul_(g["momentum"]).add_(dp)
                p.add_(mu, alpha=-g["lr"])


def multi_crop_forward(backbone_fn, head_fn, crops):
    """MultiCropWrapper: ``crops`` is a list of (B, H_i, W_i, 3) tensors;
    consecutive crops of one resolution run as one backbone call, the
    outputs are concatenated, then go through the head."""
    outputs = []
    i = 0
    while i < len(crops):
        j = i
        while j < len(crops) and crops[j].shape[1:] == crops[i].shape[1:]:
            j += 1
        outputs.append(backbone_fn(torch.cat(crops[i:j], dim=0)))
        i = j
    return head_fn(torch.cat(outputs, dim=0))


class DINOHead(nn.Module):
    """The reference's DINOHead keys: ``mlp`` (one Linear) or ``mlp.{0,2,
    4...}`` (Linear, GELU, ...), and ``last_layer.weight_v`` (out,
    bottleneck), ``last_layer.weight_g`` (out, 1): weight_norm's
    parameters."""

    def __init__(self, in_dim, out_dim, nlayers=3, hidden_dim=2048, bottleneck_dim=256):
        super().__init__()
        nlayers = max(nlayers, 1)
        dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        if nlayers == 1:
            self.mlp = nn.Linear(in_dim, bottleneck_dim)
        else:
            layers = []
            for i in range(nlayers):
                layers.append(nn.Linear(dims[i], dims[i + 1]))
                if i < nlayers - 1:
                    layers.append(nn.GELU())
            self.mlp = nn.Sequential(*layers)
        self.last_layer = nn.Module()
        self.last_layer.weight_v = nn.Parameter(torch.empty(out_dim, bottleneck_dim))
        self.last_layer.weight_g = nn.Parameter(torch.ones(out_dim, 1), requires_grad=False)

    def forward(self, x):
        return dino_head_apply(self, x)


def dino_head_init(in_dim, out_dim, nlayers=3, hidden_dim=2048, bottleneck_dim=256,
                   generator: torch.Generator | None = None, device=None) -> DINOHead:
    """trunc-normal(0.02) linear weights and zero biases, a trunc-normal
    direction v for the last layer and its norm g at 1 (norm_last_layer),
    drawn from ``generator`` on the CPU."""
    head = DINOHead(in_dim, out_dim, nlayers, hidden_dim, bottleneck_dim)
    with torch.no_grad():
        for m in head.modules():
            if isinstance(m, nn.Linear):
                tnn.trunc_normal(m.weight, generator=generator)
                m.bias.zero_()
        tnn.trunc_normal(head.last_layer.weight_v, generator=generator)
    return head.to(device) if device is not None else head


def dino_head_apply(head: DINOHead, x):
    """MLP (exact GELU between the layers), the bottleneck l2-normalized,
    then the weight-normalized last layer g v / ||v||, norms floored at
    1e-12 as the JAX package's."""
    mlp = [head.mlp] if isinstance(head.mlp, nn.Linear) else \
        [m for m in head.mlp if isinstance(m, nn.Linear)]
    h = x
    for i, lin in enumerate(mlp):
        h = F.linear(h, lin.weight, lin.bias)
        if i < len(mlp) - 1:
            h = tnn.gelu(h)
    h = h / torch.clamp_min(torch.linalg.vector_norm(h, dim=-1, keepdim=True), 1e-12)
    v = head.last_layer.weight_v
    w = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1, keepdim=True), 1e-12)
    return F.linear(h, w * head.last_layer.weight_g)

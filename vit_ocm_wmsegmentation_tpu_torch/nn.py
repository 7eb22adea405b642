"""Functional layers of the port, on tensors, with the JAX package's numerics.

Counterpart of ``vit_ocm_wmsegmentation_tpu/nn.py``: LayerNorm with biased
variance and f32 statistics, exact-erf GELU, and the patch split whose
``(ph, pw, c)`` order matches the converted patch-embed weight.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def linear(x, weight, bias=None):
    """x @ weight.T + bias with ``weight`` in nn.Linear's (out, in) layout;
    f32 accumulation, result in x's dtype."""
    return F.linear(x, weight, bias)


def layer_norm(x, weight, bias, eps=1e-6):
    """LayerNorm over the last axis: f32 statistics, biased variance, the
    result cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def gelu(x):
    """Exact (erf) GELU, written in the fused-MLP kernels' order of
    operations, ``x * (0.5 * (1 + erf(x / sqrt(2))))``, so that their plain
    twins round as the kernels do."""
    return x * (0.5 * (1.0 + torch.erf(x * _INV_SQRT2)))


def patchify(x, patch: int):
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C), ``(ph, pw, c)`` order inside a
    patch: a Conv2d(k=p, s=p) weight (D, C, p, p) becomes the matching
    (p*p*C, D) matrix as ``weight.permute(2, 3, 1, 0).reshape(-1, D)``."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def pixel_shuffle(x, upscale: int):
    """nn.PixelShuffle on an NHWC tensor: (B, H, W, C*r*r) -> (B, H*r, W*r, C),
    with torch's (C, r, r) channel order, so a reference decoder's weights
    load unchanged."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), upscale).permute(0, 2, 3, 1)


def trunc_normal(t, generator=None):
    """Fill t in place from N(0, 0.02) truncated to the absolute bounds
    [-2, 2], the reference's init (dino/utils.py:482-520)."""
    return torch.nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0, generator=generator)


def torch_linear_init(weight, bias, generator=None):
    """nn.Linear's default init in place: kaiming-uniform(a=sqrt(5)) weight,
    i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)), and a bias on the same bound.
    fan_in is the product of the weight's dims after the first (a 1x1 conv
    counts like a linear layer)."""
    bound = 1.0 / math.sqrt(weight[0].numel())
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)
        bias.uniform_(-bound, bound, generator=generator)
    return weight, bias

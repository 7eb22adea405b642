"""Functional layers of the port, on tensors, with the JAX package's numerics.

Counterpart of ``vit_ocm_wmsegmentation_tpu/nn.py``: LayerNorm with biased
variance and f32 statistics, exact-erf GELU, the patch split whose
``(ph, pw, c)`` order matches the converted patch-embed weight, and the
conv, transposed-conv, BatchNorm and pooling layers of the UNet and the
probing decoder with torch's default inits.
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


# ---------------------------------------------------------------------------
# Convolutions, BatchNorm and pooling (the JAX package's nn.py:93-230)
#
# The models hold nn.Conv2d / nn.ConvTranspose2d / nn.BatchNorm2d in torch's
# own layouts and compute in NCHW inside (F.conv2d, F.conv_transpose2d,
# F.max_pool2d, :func:`batch_norm`), NHWC at their boundary as the JAX
# package's layers take it. A ConvTranspose2d's (Cin, Cout, kh, kw) weight is
# the JAX package's HWIO kernel spatially flipped:
# weight = kernel[::-1, ::-1].transpose(2, 3, 0, 1).
# ---------------------------------------------------------------------------


def nchw(x):
    """(B, H, W, C) -> (B, C, H, W)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    """(B, C, H, W) -> (B, H, W, C)."""
    return x.permute(0, 2, 3, 1)


def batch_norm(x, bn, train: bool):
    """nn.BatchNorm2d ``bn`` over dim 1 of an NCHW tensor with the JAX
    package's numerics: statistics in f32 whatever x's dtype (the running
    buffers stay f32), the running variance unbiased and the normalization
    biased, momentum and eps from ``bn`` (0.1, 1e-5). In training the
    running statistics update in place, as nn.BatchNorm2d's do."""
    if train:
        bn.num_batches_tracked.add_(1)
    wide = torch.promote_types(x.dtype, torch.float32)
    y = F.batch_norm(x.to(wide), bn.running_mean, bn.running_var, bn.weight.to(wide),
                     bn.bias.to(wide), train, bn.momentum, bn.eps)
    return y.to(x.dtype)


def conv_init(conv, generator=None):
    """nn.Conv2d / nn.ConvTranspose2d default init, drawn from ``generator``:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, where fan_in is
    the product of the weight's dims after the first. For ConvTranspose2d,
    whose weight is (Cin, Cout, kh, kw), that is Cout*kh*kw, as torch counts
    it."""
    return torch_linear_init(conv.weight, conv.bias, generator)


def batch_norm_init(bn):
    """Scale 1, bias 0, running mean 0, running variance 1, count 0."""
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
    bn.reset_running_stats()
    return bn

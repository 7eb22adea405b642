"""Dense-prediction probing heads on a ViT (the reference's model.py:110-224).

Counterpart of ``vit_ocm_wmsegmentation_tpu/models/probing.py``. The
finetune ViT is the full 12-block ViT-S whose patch tokens form the (B, gh,
gw, D) feature grid; :class:`LinearProbing` adds a 1-layer (1x1 conv ->
PixelShuffle) or 2-layer (3x3 conv + BN + ReLU -> 3x3 conv -> PixelShuffle)
decoder giving a 1-channel logit map at input resolution. The state-dict
keys are the reference's: ``encoder.*`` (the timm/DINO ViT),
``one_layer_decoder.0`` or ``two_layer_decoder.{0,1,3}``.

The training forward (:func:`apply` with ``train=True``) runs the blocks on
the training kernels (``models.vit.run_blocks_train``: the folded flash
attention with its backward, the fused MLP block with its backward), as the
JAX package's ``encode(train=True)`` does; eval and test run them on the
inference routes (``models.vit.run_blocks``: the attention kernel, the
LN-out fused MLP kernel, the plain fused MLP kernel in the last block).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import nn as tnn
from . import vit as vit_mod
from .vit import InferRoutes, ViTConfig


def finetune_vit_config(img_size: int, patch_size: int = 8) -> ViTConfig:
    """build_finetune_model (model.py:176-193): ViT-S/patch, depth 12, 6
    heads, the positional table sized for ``img_size``."""
    return ViTConfig(patch_size=patch_size, embed_dim=384, depth=12, num_heads=6,
                     pretrain_img_size=img_size)


class LinearProbing(nn.Module):
    """Parameter container: ``encoder`` and the reference's decoder."""

    def __init__(self, cfg: ViTConfig, layer_num: int = 1):
        super().__init__()
        if layer_num not in (1, 2):
            raise ValueError(f"layer_num {layer_num} not in (1, 2)")
        self.cfg, self.layer_num = cfg, layer_num
        self.encoder = vit_mod.ViT(cfg)
        p, d = cfg.patch_size, cfg.embed_dim
        if layer_num == 1:
            self.one_layer_decoder = nn.Sequential(nn.Conv2d(d, p * p, 1), nn.PixelShuffle(p))
        else:
            hidden = p * p * 4
            self.two_layer_decoder = nn.Sequential(
                nn.Conv2d(d, hidden, 3, padding=1), nn.BatchNorm2d(hidden), nn.ReLU(),
                nn.Conv2d(hidden, p * p, 3, padding=1), nn.PixelShuffle(p))


def init(cfg: ViTConfig, generator: torch.Generator | None = None, layer_num: int = 1,
         device=None) -> LinearProbing:
    """The encoder with the ViT's init, then the decoder's convolutions with
    torch's default init, both from ``generator`` on the CPU; every
    parameter requires a gradient."""
    model = LinearProbing(cfg, layer_num)
    model.encoder.load_state_dict(vit_mod.init(cfg, generator).state_dict())
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            tnn.conv_init(m, generator)
        elif isinstance(m, nn.BatchNorm2d):
            tnn.batch_norm_init(m)
    model.requires_grad_(True)
    return model.to(device) if device is not None else model


def encode(encoder: vit_mod.ViT, x, train: bool = False):
    """VisionTransformerForFinetune.forward (model.py:121-139): (B, H, W, 3)
    -> the final-normed patch-token grid (B, gh, gw, D). ``train`` takes the
    training kernels, else the inference routes."""
    cfg = encoder.cfg
    b, h, w, _ = x.shape
    tok = vit_mod.prepare_tokens(encoder, x)
    if train:
        tok = vit_mod.run_blocks_train(encoder, tok)
    else:
        tok = vit_mod.run_blocks(encoder, tok, cfg.depth, InferRoutes())
    tok = tnn.layer_norm(tok, encoder.norm.weight, encoder.norm.bias, cfg.ln_eps)
    return tok[:, 1:, :].reshape(b, h // cfg.patch_size, w // cfg.patch_size, cfg.embed_dim)


def decode(model: LinearProbing, z, train: bool = False):
    """Feature grid (B, gh, gw, D) -> logits (B, H, W, 1). ``train`` runs
    the 2-layer decoder's BatchNorm on the batch statistics and updates its
    running ones."""
    p = model.cfg.patch_size
    if model.layer_num == 1:
        conv = model.one_layer_decoder[0]
        y = F.linear(z, conv.weight.reshape(conv.weight.shape[0], -1), conv.bias)
        return tnn.pixel_shuffle(y, p)
    conv1, bn, _, conv2, _ = model.two_layer_decoder
    y = F.conv2d(tnn.nchw(z), conv1.weight, conv1.bias, padding=1)
    y = F.relu(tnn.batch_norm(y, bn, train))
    y = F.conv2d(y, conv2.weight, conv2.bias, padding=1)
    return tnn.nhwc(F.pixel_shuffle(y, p))


def apply(model: LinearProbing, x, train: bool = False):
    """The LinearProbing forward: (B, H, W, 3) -> logits (B, H, W, 1). An
    encoder whose parameters require no gradient (finetune's ``--finetune
    False``, the JAX package's ``stop_gradient``) records no graph and
    still runs the training kernels' forward when ``train``."""
    return decode(model, encode(model.encoder, x, train), train)

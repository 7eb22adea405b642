"""SimMIM masked image modeling (the reference's model.py:11-108).

Counterpart of ``vit_ocm_wmsegmentation_tpu/models/simmim.py``. Encoder: the
ViT with a learnable mask token substituted at masked patch positions before
the CLS concat and the positional embedding, its positional table sized for
the training image (model.py:99, so no interpolation). Decoder: a 1x1 conv
to p*p*3 channels and PixelShuffle(p), i.e. one matmul on the token grid.
Loss: masked L1 over the masked pixels and the 3 channels (model.py:71-77).

:class:`SimMIM` holds the parameters under the reference's state-dict keys
(``encoder.*`` with ``encoder.mask_token``; ``decoder.0.weight`` (p*p*3, D,
1, 1) and ``decoder.0.bias``), so a reference MIM ``.pth`` loads with
``load_state_dict``. The forward is functional, on the port's layers and
kernels; images are NHWC (B, H, W, 3) in [0, 1], masks (B, gh, gw) {0, 1}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import nn as tnn
from . import vit as vit_mod
from .vit import TrainRoutes, ViTConfig


def mim_vit_config(img_size: int, patch_size: int = 8) -> ViTConfig:
    """build_model (model.py:91-108): ViT-S width at depth 4, 3 heads."""
    return ViTConfig(patch_size=patch_size, embed_dim=384, depth=4, num_heads=3,
                     pretrain_img_size=img_size)


class SimMIM(nn.Module):
    """Parameter container with the reference's MIM state-dict layout."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = vit_mod.ViT(cfg)
        self.encoder.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.decoder = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, cfg.patch_size ** 2 * 3, kernel_size=1),
            nn.PixelShuffle(cfg.patch_size))

    def forward(self, x, mask, remat: bool = False, routes: TrainRoutes = TrainRoutes(),
                pix_count=None):
        """(loss, x_rec, pixel mask) of :func:`mim_loss`."""
        return mim_loss(self, x, mask, remat, routes, pix_count)


def init(cfg: ViTConfig, generator: torch.Generator | None = None, device=None) -> SimMIM:
    """Encoder with the ViT's init, trunc-normal(0.02) mask token, and the
    decoder with nn.Linear's default init, drawn from ``generator`` on the
    CPU; every parameter requires a gradient."""
    model = SimMIM(cfg)
    enc = vit_mod.init(cfg, generator, requires_grad=True)
    model.encoder.load_state_dict(enc.state_dict(), strict=False)
    with torch.no_grad():
        tnn.trunc_normal(model.encoder.mask_token, generator=generator)
        tnn.torch_linear_init(model.decoder[0].weight, model.decoder[0].bias, generator)
    model.requires_grad_(True)
    return model.to(device) if device is not None else model


def embed_tokens(model: SimMIM, x, mask):
    """encode's pre-block section (model.py:25-42): patchify, mask-token
    substitution, CLS concat, positional embedding -> (B, 1 + gh*gw, D)."""
    b = x.shape[0]
    token = model.encoder.mask_token

    def substitute_masked(tok):
        w = mask.reshape(b, -1, 1).to(tok.dtype)
        return tok * (1.0 - w) + token.to(tok.dtype) * w

    return vit_mod.prepare_tokens(model.encoder, x, patch_hook=substitute_masked)


def tokens_to_grid(model: SimMIM, tok, gh: int, gw: int):
    """encode's post-block section (model.py:43-53): final LayerNorm, drop
    CLS, reshape to the (B, gh, gw, D) feature grid."""
    enc = model.encoder
    tok = tnn.layer_norm(tok, enc.norm.weight, enc.norm.bias, model.cfg.ln_eps)
    return tok[:, 1:, :].reshape(tok.shape[0], gh, gw, model.cfg.embed_dim)


def encode(model: SimMIM, x, mask, remat: bool = False, routes: TrainRoutes = TrainRoutes()):
    """VisionTransformerForSimMIM.forward (model.py:25-53) on the training
    route (its opt-in kernel routes as ``routes`` selects them):
    (B, H, W, 3) and (B, gh, gw) -> (B, gh, gw, D)."""
    _, h, w, _ = x.shape
    p = model.cfg.patch_size
    tok = vit_mod.run_blocks_train(model.encoder, embed_tokens(model, x, mask), remat, routes)
    return tokens_to_grid(model, tok, h // p, w // p)


def decode_grid(model: SimMIM, z):
    """PixelShuffle decoder: (B, gh, gw, D) feature grid -> (B, H, W, 3)."""
    conv = model.decoder[0]
    rec = F.linear(z, conv.weight.reshape(conv.weight.shape[0], -1), conv.bias)
    return tnn.pixel_shuffle(rec, model.cfg.patch_size)


def reconstruct(model: SimMIM, x, mask, remat: bool = False,
                routes: TrainRoutes = TrainRoutes()):
    """Full MIM forward: encoder + PixelShuffle decoder -> (B, H, W, 3)."""
    return decode_grid(model, encode(model, x, mask, remat, routes))


def masked_l1(x, x_rec, mask, p: int, pix_count=None):
    """model.py:71-77's loss: (loss, pixel mask (B, H, W, 1)). The sums run
    in f32 whatever the compute dtype, as the JAX package reduces them.
    ``pix_count`` (f32, 0-dim) replaces the mask's own pixel sum as the
    denominator: a rank of a data-parallel step passes the whole batch's,
    so that the ranks' losses sum to the single-device loss (the global
    masked mean, whatever each shard's mask count)."""
    pix_mask = mask.repeat_interleave(p, 1).repeat_interleave(p, 2).to(x.dtype)[..., None]
    l1 = (x - x_rec).abs()
    if pix_count is None:
        pix_count = pix_mask.float().sum()
    loss = (l1 * pix_mask).float().sum() / (pix_count + 1e-5) / 3.0
    return loss, pix_mask


def mim_loss(model: SimMIM, x, mask, remat: bool = False, routes: TrainRoutes = TrainRoutes(),
             pix_count=None):
    """(loss, x_rec, pixel mask): masked L1 / mask area / 3 (the area
    ``pix_count`` when given, :func:`masked_l1`)."""
    x_rec = reconstruct(model, x, mask, remat, routes)
    loss, pix_mask = masked_l1(x, x_rec, mask, model.cfg.patch_size, pix_count)
    return loss, x_rec, pix_mask

"""The SimMIM augmentation on the device (DATA.DEVICE_AUG).

Counterpart of ``vit_ocm_wmsegmentation_tpu/data/device_aug.py``: the
reference's per-image host transform (data.py:189-253: RandomResizedCrop
(scale=(0.67, 1), ratio=(3/4, 4/3)), random horizontal and vertical flips,
ToTensor and the MaskGenerator) as batched tensor operations on the
device of the decoded uint8 sources, drawn from a ``torch.Generator`` on
that device:

* :func:`sample_crop_box`: torchvision's 10-attempt box sampler, vectorized
  (10 draws, the first whose rounded box fits wins, else the clamped centre
  fallback);
* :func:`crop_resize_bilinear`: the box resized with an antialiased
  triangle filter, ``jax.image.scale_and_translate``'s weights
  (``compute_weight_mat``) built per image and axis and applied as two
  batched products. The filter reads source pixels outside the box near
  its edges, so a crop followed by an antialiased ``F.interpolate`` would
  differ in the border rows;
* flips, and :func:`random_mask`, a permutation of the coarse grid per image
  with the reference's ceil(count * ratio) cells masked.

The random streams are not the JAX package's (another generator): what
must be equal is the deterministic part, the crop-resize; the sampler is
held to torchvision's bounds and distribution.
"""

from __future__ import annotations

import math

import torch


def _fallback_box(h: int, w: int, ratio):
    """torchvision's centre-crop fallback at the clamped aspect."""
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def sample_crop_box(gen: torch.Generator, b: int, h: int, w: int, scale=(0.67, 1.0),
                    ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """RandomResizedCrop boxes (i, j, ch, cw) of b images of (h, w), each an
    int64 tensor (b,) on the generator's device."""
    dev = gen.device
    u = torch.rand((b, 22), generator=gen, device=dev)
    ta = h * w * (scale[0] + (scale[1] - scale[0]) * u[:, :10])
    la = math.log(ratio[0]) + (math.log(ratio[1]) - math.log(ratio[0])) * u[:, 10:20]
    aspect = torch.exp(la)
    cws = torch.round(torch.sqrt(ta * aspect)).long()
    chs = torch.round(torch.sqrt(ta / aspect)).long()
    valid = (cws > 0) & (cws <= w) & (chs > 0) & (chs <= h)
    first = torch.argmax(valid.int(), dim=1, keepdim=True)  # the first valid draw
    any_valid = valid.any(dim=1)
    fi, fj, fch, fcw = _fallback_box(h, w, ratio)
    ch = torch.where(any_valid, chs.gather(1, first)[:, 0], fch)
    cw = torch.where(any_valid, cws.gather(1, first)[:, 0], fcw)
    # randint(0, n - c + 1) with a per-image bound: floor(U[0, 1) * (n - c + 1))
    i = torch.where(any_valid, torch.floor(u[:, 20] * (h - ch + 1)).long(), fi)
    j = torch.where(any_valid, torch.floor(u[:, 21] * (w - cw + 1)).long(), fj)
    return i, j, ch, cw


def _weight_mat(in_size: int, out_size: int, scale, translation):
    """(B, in_size, out_size) antialiased triangle-filter weights of
    jax.image.scale_and_translate (compute_weight_mat) for per-image f32
    scale and translation (B,)."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)[None] + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5)
    x = (sample_f[:, None, :] - torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
         ).abs() / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * 1.1920929e-07,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def crop_resize_bilinear(images, i, j, ch, cw, out_size: int):
    """(B, H, W, C) float images and boxes (B,) -> (B, S, S, C): each box
    resized with the antialiased bilinear of scale_and_translate, the box
    edges mapped onto the output edges."""
    _, h, w, _ = images.shape
    s = out_size
    sy = s / ch.float()
    sx = s / cw.float()
    wy = _weight_mat(h, s, sy, -i.float() * sy)  # (B, H, S)
    wx = _weight_mat(w, s, sx, -j.float() * sx)  # (B, W, S)
    out = torch.einsum("bhwc,bho->bowc", images, wy)
    return torch.einsum("bowc,bwp->bopc", out, wx)


def random_mask(gen: torch.Generator, b: int, rand_size: int, mask_count: int, scale: int):
    """b MaskGenerator draws (data.py:163-186): a random permutation of the
    coarse grid per image, its first mask_count cells masked, each cell
    repeated scale x scale on the token grid. int32 (b, g, g)."""
    tc = rand_size * rand_size
    perm = torch.argsort(torch.rand((b, tc), generator=gen, device=gen.device), dim=1)
    mask = torch.zeros((b, tc), dtype=torch.int32, device=gen.device)
    mask.scatter_(1, perm[:, :mask_count], 1)
    mask = mask.reshape(b, rand_size, rand_size)
    return mask.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def simmim_augment(images, gen: torch.Generator, *, out_size: int, mask_patch_size: int,
                   model_patch_size: int, mask_ratio: float, scale=(0.67, 1.0),
                   ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """(B, H0, W0[, C]) sources on the generator's device -> ((B, S, S, 3)
    float32 images in [0, 1], (B, g, g) int32 token masks), g = S //
    model_patch_size: crop boxes, the antialiased crop-resize, the flips
    (p = 0.5 each) and the masks. uint8 sources are divided by 255 on the
    device; a channelless grayscale source is augmented once and broadcast
    to RGB at the end."""
    if out_size % mask_patch_size:
        raise ValueError(f"image size {out_size} not divisible by mask_patch_size "
                         f"{mask_patch_size}")
    if mask_patch_size % model_patch_size:
        raise ValueError(f"mask_patch_size {mask_patch_size} not divisible by "
                         f"model_patch_size {model_patch_size}")
    x = images.float() / 255.0 if images.dtype == torch.uint8 else images.float()
    grayscale = x.ndim == 3
    if grayscale:
        x = x[..., None]
    b, h0, w0, _ = x.shape
    rand_size = out_size // mask_patch_size
    mask_count = int(math.ceil(rand_size * rand_size * mask_ratio))

    i, j, ch, cw = sample_crop_box(gen, b, h0, w0, scale, ratio)
    out = crop_resize_bilinear(x, i, j, ch, cw, out_size)
    flips = torch.rand((b, 2), generator=gen, device=gen.device) < 0.5
    out = torch.where(flips[:, 0, None, None, None], out.flip(2), out)
    out = torch.where(flips[:, 1, None, None, None], out.flip(1), out)
    mask = random_mask(gen, b, rand_size, mask_count, mask_patch_size // model_patch_size)
    if grayscale:
        out = out.expand(out.shape[:-1] + (3,))
    return out.contiguous(), mask

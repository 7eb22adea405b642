"""Plain reference of the SimMIM training feed on the device (the MIM CLI's
``DATA.DEVICE_AUG``): the epoch's order, torchvision's RandomResizedCrop
box (scale (0.67, 1), ratio (3/4, 4/3), ten attempts, the first that fits,
else the centre crop at the clamped ratio), the box resized to the training
size by the antialiased triangle filter of ``jax.image.scale_and_translate``
(the JAX package's loader, which the device path reproduces), horizontal
then vertical flips with probability 1/2, and the MaskGenerator's mask:
ceil(cells * ratio) cells of the coarse grid, each a mask patch of tokens.

The random numbers come from the feed's own protocol, so that the same seed
gives the same draws: a numpy permutation of the sources per (seed, epoch),
and per (seed, epoch, batch) a ``torch.Generator`` on the device, seeded from
numpy's SeedSequence, drawing 22 uniforms an image for the box, 2 for the
flips and one a coarse cell for the mask, in that order.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def order(seed: int, epoch: int, n: int):
    return np.random.default_rng((seed, epoch)).permutation(n)


def batch_generator(seed: int, epoch: int, batch: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence((seed, epoch, batch)).generate_state(1, np.uint64)[0]
                        >> 1))
    return gen


def crop_box(u, h, w, scale=(0.67, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """torchvision's RandomResizedCrop.get_params from 22 uniforms: (i, j,
    ch, cw)."""
    area = h * w
    for a in range(10):
        target = area * (scale[0] + (scale[1] - scale[0]) * u[a])
        lo, hi = math.log(ratio[0]), math.log(ratio[1])
        aspect = math.exp(lo + (hi - lo) * u[10 + a])
        cw = int(round(math.sqrt(target * aspect)))
        ch = int(round(math.sqrt(target / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = int(math.floor(u[20] * (h - ch + 1)))
            return i, int(math.floor(u[21] * (w - cw + 1))), ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def triangle_weights(in_size: int, out_size: int, start: int, length: int, device):
    """(in_size, out_size) weights mapping [start, start + length) of the
    input onto the output: scale_and_translate's antialiased triangle
    filter, each column normalized, zero where the sample falls outside."""
    scale = out_size / length
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    k = torch.arange(in_size, dtype=torch.float64, device=device)[:, None]
    o = torch.arange(out_size, dtype=torch.float64, device=device)[None, :]
    sample = (o + 0.5) * inv + start - 0.5
    wts = torch.clamp(1.0 - (sample - k).abs() / kscale, min=0.0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * 1.1920929e-07, wts / total, torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, wts, torch.zeros_like(wts)).float()


def augment(src_u8, seed: int, epoch: int, batch: int, batch_size: int, out_size: int,
            mask_patch: int, patch: int, ratio: float):
    """The feed's batch ``batch`` of ``epoch`` from the uint8 sources (N, H,
    W): (images (B, S, S, 3) float32 in [0, 1], token masks (B, g, g) int32)."""
    n, h, w = src_u8.shape
    dev = src_u8.device
    idx = order(seed, epoch, n)[batch * batch_size : (batch + 1) * batch_size]
    gen = batch_generator(seed, epoch, batch, dev)
    b = len(idx)
    u = torch.rand((b, 22), generator=gen, device=dev).double().cpu().numpy()
    flips = (torch.rand((b, 2), generator=gen, device=dev) < 0.5).cpu().numpy()
    rand_size = out_size // mask_patch
    cells = rand_size * rand_size
    noise = torch.rand((b, cells), generator=gen, device=dev)
    images = []
    for r, k in enumerate(idx):
        i, j, ch, cw = crop_box(u[r], h, w)
        wy = triangle_weights(h, out_size, i, ch, dev)
        wx = triangle_weights(w, out_size, j, cw, dev)
        img = wy.t() @ (src_u8[int(k)].float() / 255.0) @ wx
        if flips[r, 0]:
            img = img.flip(1)
        if flips[r, 1]:
            img = img.flip(0)
        images.append(img)
    x = torch.stack(images)[..., None].expand(-1, -1, -1, 3).contiguous()
    count = int(math.ceil(cells * ratio))
    chosen = torch.argsort(noise, dim=1)[:, :count]
    mask = torch.zeros((b, cells), dtype=torch.int32, device=dev)
    mask.scatter_(1, chosen, 1)
    rep = mask_patch // patch
    mask = mask.reshape(b, rand_size, rand_size).repeat_interleave(rep, 1).repeat_interleave(rep, 2)
    return x, mask

"""Plain float32 reference of SimMIM pretraining (linum-uqam
ViT-OCM-WMSegmentation ``Self-supervised_segmentation/model.py``
``build_model`` and ``mim.py``'s step), in plain PyTorch.

The encoder is the DINO ViT of :mod:`.vit` with a mask token put in place of
the masked patch embeddings before the CLS token and the positional table
(sized for the training image, so not interpolated); the decoder a 1x1
convolution to p*p*3 channels and a pixel shuffle; the loss the L1 distance
over the masked pixels and the three channels divided by the masked area
(+1e-5) and by 3. The step clips the gradients by their global norm (when it
is at least the limit) and applies AdamW with decoupled weight decay on
every tensor of more than one dimension that is not a bias, at the learning
rate of timm's cosine schedule with its linear warm-up, per update. Rows run in
blocks, their gradients summed, since the loss is a sum over rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import vit
from .precision import matmul_flags, round_operand, store

ROW_BLOCK = 4


def encode(state, cfg, x, mask, precision):
    """(B, H, W, 3), (B, gh, gw) -> (B, gh*gw, D) final-normed patch tokens."""
    b = x.shape[0]
    tok = vit.patch_embed(state, cfg, store(x, precision), precision)
    w = mask.reshape(b, -1, 1).to(tok.dtype)
    tok = tok * (1.0 - w) + state["encoder.mask_token"].float() * w
    cls = state["cls_token"].float().expand(b, 1, -1)
    tok = store(torch.cat([cls, tok], dim=1) + state["pos_embed"].float(), precision)
    for i in range(cfg["depth"]):
        tok = vit.block(state, cfg, i, tok, precision)
    return vit.layer_norm(state, "norm", cfg, tok, precision)[:, 1:]


def loss_sum(state, cfg, x, mask, precision):
    """The masked L1 sum of rows x (B, H, W, 3) and the masked pixel count."""
    b, hgt, wdt, _ = x.shape
    p = cfg["patch_size"]
    z = encode(state, cfg, x, mask, precision)
    z = z.transpose(1, 2).reshape(b, -1, hgt // p, wdt // p)
    wd = state["decoder.0.weight"].float()
    rec = F.conv2d(round_operand(z, precision), round_operand(wd, precision),
                   state["decoder.0.bias"].float())
    rec = F.pixel_shuffle(store(rec, precision), p)
    pix = mask.repeat_interleave(p, 1).repeat_interleave(p, 2)[:, None].float()
    return ((x.permute(0, 3, 1, 2) - rec).abs() * pix).sum(), pix.sum()


def _encoder_view(params):
    """The encoder's tensors under the ViT's own keys (``encoder.`` dropped),
    the decoder's and the mask token's under their full keys."""
    out = {}
    for name, t in params.items():
        out[name[len("encoder."):] if name.startswith("encoder.") else name] = t
    out["encoder.mask_token"] = params["encoder.mask_token"]
    return out


def no_decay(name: str, t) -> bool:
    return t.ndim <= 1 or name.endswith(".bias")


def cosine_lr(opt_cfg, t: int) -> float:
    """timm's cosine schedule per update t (from 0): a linear warm-up from
    warmup_lr to base_lr, then min_lr + (base_lr - min_lr) (1 + cos(pi t /
    total)) / 2, t counted from 0 with the warm-up in it."""
    w, base = opt_cfg["warmup_steps"], opt_cfg["base_lr"]
    if t < w:
        return opt_cfg["warmup_lr"] + t * (base - opt_cfg["warmup_lr"]) / w
    lo = opt_cfg["min_lr"]
    return lo + 0.5 * (base - lo) * (1 + math.cos(math.pi * t / opt_cfg["total_steps"]))


class Trainer:
    """The reference's training state: float32 parameters (name -> tensor)
    and AdamW's moments, advanced by :meth:`step`. ``precision`` selects the
    products' arithmetic (:mod:`.precision`). After each step,
    :attr:`last_grads` holds the clipped gradients the update read."""

    def __init__(self, state, cfg, opt_cfg, precision="float32"):
        self.params = {n: t.detach().float().clone() for n, t in state.items()}
        self.cfg, self.opt, self.precision = cfg, opt_cfg, precision
        self.m = {n: torch.zeros_like(t) for n, t in self.params.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.params.items()}
        self.t = 0
        self.last_grads = None

    def grads(self, x, mask):
        """(loss, gradients) of the batch, rows in blocks of ROW_BLOCK."""
        live = {n: t.clone().requires_grad_(True) for n, t in self.params.items()}
        view = _encoder_view(live)
        pix = sum(float(mask[i : i + ROW_BLOCK].sum()) for i in range(0, x.shape[0], ROW_BLOCK))
        denom = pix * self.cfg["patch_size"] ** 2 + 1e-5
        total = 0.0
        grads = {n: torch.zeros_like(t) for n, t in live.items()}
        with matmul_flags(self.precision):
            for i in range(0, x.shape[0], ROW_BLOCK):
                s, _ = loss_sum(view, self.cfg, x[i : i + ROW_BLOCK].float(),
                                mask[i : i + ROW_BLOCK], self.precision)
                part = s / denom / 3.0
                gs = torch.autograd.grad(part, list(live.values()), allow_unused=True)
                for (n, _), g in zip(live.items(), gs):
                    if g is not None:
                        grads[n] += g
                total += float(part.detach())
        return total, grads

    def step(self, x, mask) -> float:
        loss, grads = self.grads(x, mask)
        o = self.opt
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if o["clip_grad"] and float(norm) >= o["clip_grad"]:
            grads = {n: g * (o["clip_grad"] / norm) for n, g in grads.items()}
        lr = cosine_lr(o, self.t)
        b1, b2 = o["betas"]
        self.t += 1
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            if not no_decay(n, p):
                p.mul_(1.0 - lr * o["weight_decay"])
            self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[n].sqrt() / bc2 ** 0.5).add_(o["eps"])
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)
        self.last_grads = grads
        return loss

"""Swin Transformer (Tiny) image classifier, the Allen-brain side
experiment's backbone (Allen_data_Backbone/train.py:79-85 fine-tunes HF's
``microsoft/swin-tiny-patch4-window7-224``).

Counterpart of ``vit_ocm_wmsegmentation_tpu/models/swin.py``: 4 stages of
windowed attention with a relative position bias, shifted windows on every
other block with the masked-attention trick, patch merging between stages,
LayerNorm, mean pool and a linear head. :class:`Swin` holds the parameters
under HF's SwinForImageClassification keys (``swin.embeddings.*``,
``swin.encoder.layers.{s}.blocks.{b}.attention.self.query`` ...,
``classifier``), so a local HF-layout state dict loads with
``load_state_dict`` (``train/checkpoint.load_hf_swin``). The forward is
functional and takes NHWC images, as the JAX package's does; the window
attention is plain tensor algebra (cuBLAS products, f32 softmax), as it is
an XLA computation in the JAX package. LayerNorm, GELU and the linear
layers are one library call each (a Swin-Tiny step is bound by the host's
kernel launches on the card).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import nn as tnn


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: int = 4
    ln_eps: float = 1e-5
    num_classes: int = 1000

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2 ** s)

    def stage_res(self, s: int) -> int:
        return self.img_size // self.patch_size // (2 ** s)


# ---------------------------------------------------------------------------
# Window helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) int64 indices into the (2w-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[..., 0] += w - 1
    rel[..., 1] += w - 1
    rel[..., 0] *= 2 * w - 1
    rel = rel.sum(-1)
    rel.flags.writeable = False
    return rel


@functools.lru_cache(maxsize=None)
def shifted_window_mask(res, w: int, shift: int) -> np.ndarray:
    """(num_windows, w*w, w*w) additive mask (0 or -100) for shifted windows
    on a ``res`` (int, square, or (h, w)) token grid."""
    rh, rw = (res, res) if isinstance(res, int) else res
    img_mask = np.zeros((rh, rw))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(rh // w, w, rw // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    mask = np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)
    mask.flags.writeable = False
    return mask


_DEVICE_CONSTANTS = {}


def _on_device(fn, *args, device):
    """fn(*args)'s numpy array as a tensor on ``device``, made once."""
    key = (fn.__name__, args, str(device))
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = torch.as_tensor(np.array(fn(*args)), device=device)
    return _DEVICE_CONSTANTS[key]


def window_partition(x, w: int):
    """(B, H, W, C) -> (B*nW, w*w, C)."""
    b, h, wid, c = x.shape
    x = x.reshape(b, h // w, w, wid // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(x, w: int, h: int, wid: int):
    """(B*nW, w*w, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // w) * (wid // w))
    x = x.reshape(b, h // w, wid // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wid, c)


# ---------------------------------------------------------------------------
# Parameter containers (HF's SwinForImageClassification layout)
# ---------------------------------------------------------------------------


def _container(**children):
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


class _SelfAttention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(np.array(relative_position_index(window))))


class _Block(nn.Module):
    def __init__(self, dim, heads, window, mlp_ratio, eps):
        super().__init__()
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = _container(self=_SelfAttention(dim, heads, window),
                                    output=_container(dense=nn.Linear(dim, dim)))
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = _container(dense=nn.Linear(dim, dim * mlp_ratio))
        self.output = _container(dense=nn.Linear(dim * mlp_ratio, dim))


class Swin(nn.Module):
    """Parameter container with HF's SwinForImageClassification keys."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        p, e = cfg.patch_size, cfg.embed_dim
        layers = nn.ModuleList()
        for s, depth in enumerate(cfg.depths):
            dim = cfg.stage_dim(s)
            layer = _container(blocks=nn.ModuleList(
                [_Block(dim, cfg.num_heads[s], cfg.window, cfg.mlp_ratio, cfg.ln_eps)
                 for _ in range(depth)]))
            if s < len(cfg.depths) - 1:
                layer.downsample = _container(reduction=nn.Linear(4 * dim, 2 * dim, bias=False),
                                              norm=nn.LayerNorm(4 * dim, eps=cfg.ln_eps))
            layers.append(layer)
        last = cfg.stage_dim(len(cfg.depths) - 1)
        self.swin = _container(
            embeddings=_container(
                patch_embeddings=_container(projection=nn.Conv2d(cfg.in_chans, e, p, stride=p)),
                norm=nn.LayerNorm(e, eps=cfg.ln_eps)),
            encoder=_container(layers=layers),
            layernorm=nn.LayerNorm(last, eps=cfg.ln_eps))
        self.classifier = nn.Linear(last, cfg.num_classes)

    def forward(self, x):
        return apply(self, x)


def init(cfg: SwinConfig, generator: torch.Generator | None = None, device=None) -> Swin:
    """A Swin with the JAX package's init distributions, drawn from
    ``generator`` on the CPU: nn.Linear's default init for every linear
    layer (bias-free patch-merge reductions on the same bound) and the
    patch-embed conv, trunc-normal(0.02) relative-bias tables, LayerNorm
    scale 1 and bias 0; every parameter requires a gradient."""
    model = Swin(cfg)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                if m.bias is not None:
                    tnn.torch_linear_init(m.weight, m.bias, generator)
                else:
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    m.weight.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, _SelfAttention):
                tnn.trunc_normal(m.relative_position_bias_table, generator=generator)
    return model.to(device) if device is not None else model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ln(x, ln):
    """LayerNorm in one library call: f32 statistics for bf16 x too."""
    return F.layer_norm(x, (x.shape[-1],), ln.weight.to(x.dtype), ln.bias.to(x.dtype), ln.eps)


def _linear(x, lin):
    """x @ W^T + b in one library call (f32 accumulation; in bf16 the bias
    joins the product in the epilogue)."""
    bias = lin.bias.to(x.dtype) if lin.bias is not None else None
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _window_attention(sa, dense, x, heads, window, mask):
    """x: (nWb, n, C) windows; mask: (nW, n, n) or None."""
    nwb, n, c = x.shape
    hd = c // heads

    def proj(lin):
        return _linear(x, lin).reshape(nwb, n, heads, hd).permute(0, 2, 1, 3)

    q, k, v = proj(sa.query), proj(sa.key), proj(sa.value)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
    index = _on_device(relative_position_index, window, device=x.device)
    bias = sa.relative_position_bias_table[index.reshape(-1)]
    logits = logits + bias.reshape(n, n, heads).permute(2, 0, 1).float()[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(nwb // nw, nw, heads, n, n) + mask[None, :, None])
        logits = logits.reshape(nwb, heads, n, n)
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(nwb, n, c)
    return _linear(out, dense)


def _swin_block(bp, x, heads, window, shift):
    """x: (B, H, W, C). Resolutions that are not window multiples are
    zero-padded on the bottom/right before the partition and cropped after,
    the shift mask computed on the padded grid (HF's maybe_pad)."""
    b, h, w, c = x.shape
    hp, wp = -(-h // window) * window, -(-w // window) * window
    mask = (_on_device(shifted_window_mask, (hp, wp), window, shift, device=x.device)
            if shift > 0 else None)
    xn = _ln(x, bp.layernorm_before)
    if (hp, wp) != (h, w):
        xn = F.pad(xn, (0, 0, 0, wp - w, 0, hp - h))
    if shift > 0:
        xn = torch.roll(xn, (-shift, -shift), dims=(1, 2))
    attn = _window_attention(bp.attention.self, bp.attention.output.dense,
                             window_partition(xn, window), heads, window, mask)
    xn = window_reverse(attn, window, hp, wp)
    if shift > 0:
        xn = torch.roll(xn, (shift, shift), dims=(1, 2))
    x = x + xn[:, :h, :w]
    xn = _linear(F.gelu(_linear(_ln(x, bp.layernorm_after), bp.intermediate.dense)),
                 bp.output.dense)
    return x + xn


def _patch_merge(ds, x):
    """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C), HF's component order
    (x0, x1, x2, x3), odd sizes zero-padded on the bottom/right first."""
    _, h, w, _ = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1)
    return _linear(_ln(x, ds.norm), ds.reduction)


def forward_features(model: Swin, x):
    """(B, H, W, 3) -> (B, final_res^2, final_dim) tokens before the pool."""
    cfg = model.cfg
    emb = model.swin.embeddings
    conv = emb.patch_embeddings.projection
    x = tnn.nhwc(F.conv2d(tnn.nchw(x), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                          stride=cfg.patch_size))
    x = _ln(x, emb.norm)
    for s, layer in enumerate(model.swin.encoder.layers):
        res = x.shape[1]
        window = min(cfg.window, res)
        for bidx, bp in enumerate(layer.blocks):
            shift = 0 if (bidx % 2 == 0 or window >= res) else window // 2
            x = _swin_block(bp, x, cfg.num_heads[s], window, shift)
        if hasattr(layer, "downsample"):
            x = _patch_merge(layer.downsample, x)
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def apply(model: Swin, x):
    """Classification logits (B, num_classes): LN -> mean pool -> head."""
    tokens = _ln(forward_features(model, x), model.swin.layernorm)
    return _linear(tokens.mean(dim=1), model.classifier)

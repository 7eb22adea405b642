"""Weights made from the seed, on the device, in a few large calls.

A configuration's ``weights`` block gives the init: ``std`` of the
normally drawn matrices, embeddings and tokens (the reference's
trunc-normal(0.02), truncated at the absolute bounds +-2), ``bias_std`` of the
biases and of the LayerNorm shifts and scales around 0 and 1 (0 gives the
reference's zeros and ones; a served checkpoint has neither), and the
decoder's nn.Linear default init, uniform within 1/sqrt(fan_in). The state
dict has the timm/DINO keys, and ``encoder.`` keys with a mask token and a
decoder for SimMIM. Both the program and the reference receive it.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def vit_layout(cfg: dict, prefix: str = ""):
    """[(name, shape, kind)] of the ViT's tensors, kind one of "normal",
    "bias", "scale"."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    hidden = d * cfg["mlp_ratio"]
    n_pos = (cfg["img_size"] // p) ** 2 + 1
    out = [("patch_embed.proj.weight", (d, 3, p, p), "normal"),
           ("patch_embed.proj.bias", (d,), "bias"),
           ("cls_token", (1, 1, d), "normal"),
           ("pos_embed", (1, n_pos, d), "normal")]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,), "scale"), (b + "norm1.bias", (d,), "bias"),
                (b + "attn.qkv.weight", (3 * d, d), "normal")]
        if cfg["qkv_bias"]:
            out.append((b + "attn.qkv.bias", (3 * d,), "bias"))
        out += [(b + "attn.proj.weight", (d, d), "normal"), (b + "attn.proj.bias", (d,), "bias"),
                (b + "norm2.weight", (d,), "scale"), (b + "norm2.bias", (d,), "bias"),
                (b + "mlp.fc1.weight", (hidden, d), "normal"),
                (b + "mlp.fc1.bias", (hidden,), "bias"),
                (b + "mlp.fc2.weight", (d, hidden), "normal"),
                (b + "mlp.fc2.bias", (d,), "bias")]
    out += [("norm.weight", (d,), "scale"), ("norm.bias", (d,), "bias")]
    return [(prefix + n, s, k) for n, s, k in out]


def layout(cfg: dict):
    """The layout of a configuration's model: the ViT, or with a
    ``decoder`` the SimMIM encoder (``encoder.`` keys, mask token) and
    its 1x1-conv decoder."""
    if "decoder" not in cfg:
        return vit_layout(cfg)
    d, p = cfg["embed_dim"], cfg["patch_size"]
    out = vit_layout(cfg, "encoder.") + [("encoder.mask_token", (1, 1, d), "normal")]
    return out + [("decoder.0.weight", (p * p * 3, d, 1, 1), "uniform"),
                  ("decoder.0.bias", (p * p * 3,), "uniform")]


def make_state(cfg: dict, seed: int, device, dtype=None):
    """The state dict of ``cfg``'s model from ``seed`` on ``device``: one
    normal draw for every "normal", "bias" and "scale" tensor together, one
    uniform draw for the decoder, in float32, then cast to ``dtype`` (the
    configuration's ``weights.dtype`` when None)."""
    init = cfg["weights"]
    dtype = DTYPES[init["dtype"]] if dtype is None else dtype
    entries = layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = [e for e in entries if e[2] != "uniform"]
    uniform = [e for e in entries if e[2] == "uniform"]
    z = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=gen, device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen, device=device)
    state, off = {}, 0
    for name, shape, kind in normal:
        n = math.prod(shape)
        t = z[off : off + n].reshape(shape)
        off += n
        if kind == "normal":
            t = torch.clamp(t * init["std"], -2.0, 2.0)
        else:
            t = t * init["bias_std"] + (1.0 if kind == "scale" else 0.0)
        state[name] = t.to(dtype)
    off = 0
    for name, shape, _ in uniform:
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(cfg["embed_dim"])
        state[name] = ((u[off : off + n].reshape(shape) * 2.0 - 1.0) * bound).to(dtype)
        off += n
    return state

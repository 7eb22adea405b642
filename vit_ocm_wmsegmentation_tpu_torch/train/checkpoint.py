"""Weights into and out of the port: reference ``.pth`` checkpoints, the JAX
package's parameter trees, and the MIM trainer's own checkpoints.

The port's ViT uses the timm/DINO state-dict layout, so a reference
checkpoint needs only the key ritual every reference entry point repeats
(eval.py:67-94): take ``checkpoint_key`` if present, fall back to the inner
``"model"`` dict, strip ``module.`` and ``backbone.``. The JAX package's
tree (stacked blocks, (in, out) kernels) converts as its own
``train/checkpoint.py::vit_params_to_torch`` does, re-implemented here on
numpy so that the port never imports JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.vit import ViTConfig


def clean_torch_state_dict(state_dict: dict, checkpoint_key: str = "teacher") -> dict:
    """The reference's key ritual: checkpoint_key extraction + prefix strip."""
    if checkpoint_key is not None and checkpoint_key in state_dict:
        state_dict = state_dict[checkpoint_key]
    if "model" in state_dict and not any(k.startswith("blocks") for k in state_dict):
        state_dict = state_dict["model"]
    state_dict = {k.replace("module.", ""): v for k, v in state_dict.items()}
    return {k.replace("backbone.", ""): v for k, v in state_dict.items()}


def vit_state_from_jax_numpy(tree, cfg: ViTConfig) -> dict:
    """The JAX package's ViT params (leaves already numpy arrays) -> the
    port's state dict of f32 tensors: kernels (in, out) -> (out, in), the
    (p*p*3, D) patch kernel -> the (D, 3, p, p) conv weight, per-block
    tensors unstacked from the leading depth axis."""
    d, depth, p = cfg.embed_dim, cfg.depth, cfg.patch_size

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    pe = np.asarray(tree["patch_embed"]["kernel"]).reshape(p, p, 3, d).transpose(3, 2, 0, 1)
    sd = {
        "patch_embed.proj.weight": t(pe),
        "patch_embed.proj.bias": t(tree["patch_embed"]["bias"]),
        "cls_token": t(tree["cls_token"]),
        "pos_embed": t(tree["pos_embed"]),
        "norm.weight": t(tree["norm"]["scale"]),
        "norm.bias": t(tree["norm"]["bias"]),
    }
    b = tree["blocks"]
    for i in range(depth):
        pre = f"blocks.{i}."
        sd[pre + "norm1.weight"] = t(b["norm1"]["scale"][i])
        sd[pre + "norm1.bias"] = t(b["norm1"]["bias"][i])
        sd[pre + "attn.qkv.weight"] = t(np.asarray(b["attn"]["wqkv"][i]).T)
        if "bqkv" in b["attn"]:
            sd[pre + "attn.qkv.bias"] = t(b["attn"]["bqkv"][i])
        sd[pre + "attn.proj.weight"] = t(np.asarray(b["attn"]["wo"][i]).T)
        sd[pre + "attn.proj.bias"] = t(b["attn"]["bo"][i])
        sd[pre + "norm2.weight"] = t(b["norm2"]["scale"][i])
        sd[pre + "norm2.bias"] = t(b["norm2"]["bias"][i])
        sd[pre + "mlp.fc1.weight"] = t(np.asarray(b["mlp"]["w1"][i]).T)
        sd[pre + "mlp.fc1.bias"] = t(b["mlp"]["b1"][i])
        sd[pre + "mlp.fc2.weight"] = t(np.asarray(b["mlp"]["w2"][i]).T)
        sd[pre + "mlp.fc2.bias"] = t(b["mlp"]["b2"][i])
    return sd


def load_torch_checkpoint(path: str, cfg: ViTConfig, checkpoint_key: str = "teacher") -> dict:
    """Read a reference ``.pth`` on the CPU and return the cleaned ViT state
    dict. Keys outside the ViT (``head.*``, decoders) are dropped, like the
    reference's strict=False loads; a patch-embed width other than
    ``cfg.embed_dim`` raises."""
    from ..models.vit import ViT

    sd = clean_torch_state_dict(torch.load(path, map_location="cpu", weights_only=False),
                                checkpoint_key)
    pe = sd.get("patch_embed.proj.weight")
    if pe is not None and (pe.shape[0] != cfg.embed_dim or pe.shape[-1] != cfg.patch_size):
        raise ValueError(f"{path}: patch embed {tuple(pe.shape)} does not fit {cfg}")
    keys = set(ViT(cfg).state_dict())
    return {k: v for k, v in sd.items() if k in keys}


def mim_state_from_jax_numpy(tree, cfg: ViTConfig) -> dict:
    """The JAX package's MIM params (numpy leaves) -> the port's SimMIM state
    dict: :func:`vit_state_from_jax_numpy` under ``encoder.``, the mask
    token, and the (D, p*p*3) decoder kernel as the (p*p*3, D, 1, 1) conv
    weight."""
    sd = {"encoder." + k: v for k, v in vit_state_from_jax_numpy(tree, cfg).items()}
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # noqa: E731
    sd["encoder.mask_token"] = t(tree["mask_token"])
    sd["decoder.0.weight"] = t(np.asarray(tree["decoder"]["kernel"]).T[:, :, None, None])
    sd["decoder.0.bias"] = t(tree["decoder"]["bias"])
    return sd


def load_mim_or_vit_checkpoint(path: str, model, checkpoint_key: str = "teacher"):
    """MIM-resume semantics for a ``.pth`` file (the JAX package's function of
    the same name): a full MIM checkpoint (``encoder.*`` and ``decoder.0.*``)
    replaces every parameter; a bare ViT checkpoint (e.g. DINO) fills the
    encoder and keeps the model's mask token and decoder."""
    sd = clean_torch_state_dict(torch.load(path, map_location="cpu", weights_only=False),
                                checkpoint_key)
    if "decoder.0.weight" in sd:
        model.load_state_dict(sd)
    else:
        enc = load_torch_checkpoint(path, model.cfg, checkpoint_key)
        missing = set(model.encoder.state_dict()) - set(enc) - {"mask_token"}
        if missing:
            raise KeyError(f"{path}: no {sorted(missing)[:3]}... for the encoder")
        model.encoder.load_state_dict(enc, strict=False)
    return model


def save_checkpoint(output_dir: str, epoch: int, model, optimizer) -> str:
    """{model, optimizer, epoch} to <output_dir>/ckpt_epoch_<epoch>
    (torch.save, written to a temporary name and renamed)."""
    path = os.path.join(output_dir, f"ckpt_epoch_{epoch}")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "epoch": epoch}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def latest_checkpoint(output_dir: str):
    """The newest ckpt_epoch_* in output_dir, or None (TRAIN.AUTO_RESUME)."""
    if not os.path.isdir(output_dir):
        return None
    cands = [d for d in os.listdir(output_dir)
             if d.startswith("ckpt_epoch_") and d.rsplit("_", 1)[-1].isdigit()]
    if not cands:
        return None
    return os.path.join(output_dir, max(cands, key=lambda d: int(d.rsplit("_", 1)[-1])))


def restore_checkpoint(path: str, model, optimizer) -> int:
    """Load a :func:`save_checkpoint` file into model and optimizer (on the
    model's device); returns its epoch."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])

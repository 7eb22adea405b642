"""Weights into and out of the port: reference ``.pth`` checkpoints, the JAX
package's parameter trees, HF-layout Swin state dicts, and the trainers' own
checkpoints.

The port's ViT uses the timm/DINO state-dict layout, so a reference
checkpoint needs only the key ritual every reference entry point repeats
(eval.py:67-94): take ``checkpoint_key`` if present, fall back to the inner
``"model"`` dict, strip ``module.`` and ``backbone.``. The JAX package's
tree (stacked blocks, (in, out) kernels) converts as its own
``train/checkpoint.py::vit_params_to_torch`` does, re-implemented here on
numpy so that the port never imports JAX. The supervised models (UNet,
LinearProbing), the Swin classifier and the DINO head convert the same way
(``*_state_from_jax_numpy``); the JAX package stores conv kernels HWIO and
the transposed conv's kernel spatially flipped (its ``nn.py:113-136``).
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


def save_checkpoint(output_dir: str, epoch: int, model, optimizer=None) -> str:
    """{model, optimizer, epoch} to <output_dir>/ckpt_epoch_<epoch>
    (torch.save, written to a temporary name and renamed); without an
    optimizer, {model, epoch} (the supervised trainers' best model, the
    Allen classifier's best checkpoint)."""
    return write_checkpoint(output_dir, epoch, model.state_dict(),
                            optimizer.state_dict() if optimizer is not None else None)


def write_checkpoint(output_dir: str, epoch: int, model_state: dict, optimizer_state=None,
                     **extra) -> str:
    """:func:`save_checkpoint` from state dicts, with ``extra`` entries (a
    pipeline run's ``pp_stages``); a sharded run's rank 0 writes the states
    its ranks gathered into the single-device layout."""
    path = os.path.join(output_dir, f"ckpt_epoch_{epoch}")
    os.makedirs(output_dir, exist_ok=True)
    state = {"model": model_state, "epoch": epoch, **extra}
    if optimizer_state is not None:
        state["optimizer"] = optimizer_state
    torch.save(state, path + ".tmp")
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


def read_checkpoint(path: str) -> dict:
    """A :func:`save_checkpoint` file's dict, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------------------
# The supervised models, the Swin classifier and the DINO head
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv_from_hwio(node, prefix):
    """A JAX conv node (HWIO kernel, bias) -> ``prefix.weight`` (OIHW) and
    ``prefix.bias``."""
    sd = {prefix + ".weight": _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in node:
        sd[prefix + ".bias"] = _t(node["bias"])
    return sd


def _conv_transpose_from_hwio(node, prefix):
    """The JAX package's transposed-conv kernel (HWIO, spatially flipped
    against torch's) -> ConvTranspose2d's (Cin, Cout, kh, kw) weight: the
    inverse of its ``_conv_transpose_from_torch``."""
    w = np.asarray(node["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return {prefix + ".weight": _t(w), prefix + ".bias": _t(node["bias"])}


def _bn_from_jax(params, state, prefix):
    return {prefix + ".weight": _t(params["scale"]), prefix + ".bias": _t(params["bias"]),
            prefix + ".running_mean": _t(state["mean"]),
            prefix + ".running_var": _t(state["var"]),
            prefix + ".num_batches_tracked": torch.tensor(int(np.asarray(state["count"])))}


def unet_state_from_jax_numpy(params, state) -> dict:
    """The JAX package's UNet (params, BN state), numpy leaves -> the
    port's UNet state dict (the reference's build_unet keys)."""
    sd = {}

    def block(p, s, prefix):
        sd.update(_conv_from_hwio(p["conv1"], prefix + ".conv1"))
        sd.update(_bn_from_jax(p["bn1"], s["bn1"], prefix + ".bn1"))
        sd.update(_conv_from_hwio(p["conv2"], prefix + ".conv2"))
        sd.update(_bn_from_jax(p["bn2"], s["bn2"], prefix + ".bn2"))

    for i in range(1, 5):
        block(params[f"e{i}"], state[f"e{i}"], f"e{i}.conv")
    block(params["b"], state["b"], "b")
    for i in range(1, 5):
        sd.update(_conv_transpose_from_hwio(params[f"up{i}"], f"d{i}.up"))
        block(params[f"d{i}"], state[f"d{i}"], f"d{i}.conv")
    sd.update(_conv_from_hwio(params["out"], "outputs"))
    return sd


def probing_state_from_jax_numpy(tree, cfg: ViTConfig, layer_num: int = 1) -> dict:
    """The JAX package's LinearProbing tree ({encoder, decoder, state}, numpy
    leaves) -> the port's state dict: ``encoder.*`` and
    ``one_layer_decoder.0`` (the (D, p*p) kernel as a 1x1 conv) or
    ``two_layer_decoder.{0,1,3}``."""
    sd = {"encoder." + k: v for k, v in vit_state_from_jax_numpy(tree["encoder"], cfg).items()}
    dec = tree["decoder"]
    if layer_num == 1:
        k = np.asarray(dec["conv"]["kernel"])
        sd["one_layer_decoder.0.weight"] = _t(k.T[:, :, None, None])
        sd["one_layer_decoder.0.bias"] = _t(dec["conv"]["bias"])
        return sd
    sd.update(_conv_from_hwio(dec["conv1"], "two_layer_decoder.0"))
    sd.update(_bn_from_jax(dec["bn"], tree["state"]["bn"], "two_layer_decoder.1"))
    sd.update(_conv_from_hwio(dec["conv2"], "two_layer_decoder.3"))
    return sd


def swin_state_from_jax_numpy(tree, cfg) -> dict:
    """The JAX package's Swin tree (numpy leaves) -> the port's Swin state
    dict under HF's SwinForImageClassification keys (the inverse of its
    ``params_from_hf``), the relative-position index buffers included."""
    from ..models.swin import relative_position_index

    sd = {}

    def lin(node, prefix):
        sd[prefix + ".weight"] = _t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            sd[prefix + ".bias"] = _t(node["bias"])

    def ln(node, prefix):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = _t(node["scale"]), _t(node["bias"])

    sd.update(_conv_from_hwio(tree["patch_embed"], "swin.embeddings.patch_embeddings.projection"))
    ln(tree["embed_norm"], "swin.embeddings.norm")
    for s, stage in enumerate(tree["stages"]):
        for b, bp in enumerate(stage["blocks"]):
            p = f"swin.encoder.layers.{s}.blocks.{b}."
            ln(bp["norm1"], p + "layernorm_before")
            a = bp["attn"]
            sd[p + "attention.self.relative_position_bias_table"] = _t(a["bias_table"])
            sd[p + "attention.self.relative_position_index"] = torch.from_numpy(
                np.array(relative_position_index(cfg.window)))
            for ours, hf in (("q", "query"), ("k", "key"), ("v", "value")):
                lin(a[ours], p + "attention.self." + hf)
            lin(a["proj"], p + "attention.output.dense")
            ln(bp["norm2"], p + "layernorm_after")
            lin(bp["mlp"]["fc1"], p + "intermediate.dense")
            lin(bp["mlp"]["fc2"], p + "output.dense")
        if "downsample" in stage:
            lin(stage["downsample"]["reduction"], f"swin.encoder.layers.{s}.downsample.reduction")
            ln(stage["downsample"]["norm"], f"swin.encoder.layers.{s}.downsample.norm")
    ln(tree["norm"], "swin.layernorm")
    lin(tree["head"], "classifier")
    return sd


def dino_head_state_from_jax_numpy(tree) -> dict:
    """The JAX package's DINO head ({mlp: [{kernel, bias}], last_v (bottleneck,
    out), last_g (out,)}, numpy leaves) -> the port's DINOHead state dict
    (the reference's keys: ``mlp.{0,2,4}``, or ``mlp`` for one layer, and the
    weight-normed ``last_layer.weight_v`` (out, bottleneck) and
    ``last_layer.weight_g`` (out, 1))."""
    layers = tree["mlp"]
    sd = {}
    for i, layer in enumerate(layers):
        prefix = "mlp" if len(layers) == 1 else f"mlp.{2 * i}"
        sd[prefix + ".weight"] = _t(np.asarray(layer["kernel"]).T)
        sd[prefix + ".bias"] = _t(layer["bias"])
    sd["last_layer.weight_v"] = _t(np.asarray(tree["last_v"]).T)
    sd["last_layer.weight_g"] = _t(np.asarray(tree["last_g"])[:, None])
    return sd


def _fit_pos_embed(encoder, pos):
    """Give ``encoder`` a positional table of ``pos``'s size when it differs
    (a DINO checkpoint's 224^2 table in a model sized for 384^2): the
    forward interpolates from the table's own size
    (``models.vit.interpolate_pos_embed``), as the JAX package does with a
    converted checkpoint."""
    if pos is not None and pos.shape != encoder.pos_embed.shape:
        encoder.pos_embed = torch.nn.Parameter(
            torch.empty_like(pos, device=encoder.pos_embed.device),
            requires_grad=encoder.pos_embed.requires_grad)


def load_vit_state(encoder, sd: dict):
    """Load a ViT state dict (e.g. :func:`load_torch_checkpoint`'s) into
    ``encoder`` strictly, its positional table at the checkpoint's size."""
    _fit_pos_embed(encoder, sd.get("pos_embed"))
    encoder.load_state_dict(sd)
    return encoder


def load_reference_checkpoint(path: str, model, checkpoint_key: str = "teacher"):
    """A reference ``.pth`` of a UNet or LinearProbing (the JAX package's
    ``unet_params_from_torch`` / ``probing_params_from_torch``) into
    ``model``, strictly, after :func:`clean_torch_state_dict`."""
    sd = clean_torch_state_dict(torch.load(path, map_location="cpu", weights_only=False),
                                checkpoint_key)
    if hasattr(model, "encoder"):
        _fit_pos_embed(model.encoder, sd.get("encoder.pos_embed"))
    model.load_state_dict(sd)
    return model


def read_state_dict(path: str) -> dict:
    """A state dict from a local file: ``.safetensors`` (through the
    safetensors package, when installed) or a torch file; a directory is
    read through its ``model.safetensors`` or ``pytorch_model.bin`` (the HF
    layout). Never downloads."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            if os.path.isfile(os.path.join(path, name)):
                return read_state_dict(os.path.join(path, name))
        raise FileNotFoundError(f"{path}: no model.safetensors or pytorch_model.bin")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.get("model", sd) if isinstance(sd, dict) else sd


def load_hf_swin(path: str, model):
    """An HF-layout SwinForImageClassification state dict from a local file
    or directory (:func:`read_state_dict`) into the port's Swin: tensors
    whose shape differs from the model's (the classifier, for another
    number of classes: HF's ``ignore_mismatched_sizes``) and the
    relative-position index buffers a file may lack keep the model's
    values; any other missing or unexpected key raises."""
    sd = read_state_dict(path)
    own = model.state_dict()
    keep = {k: v for k, v in sd.items() if k in own and v.shape == own[k].shape}
    missing = [k for k in own if k not in keep and not k.endswith("relative_position_index")
               and not k.startswith("classifier.")]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing[:3]}, unexpected {unexpected[:3]}")
    model.load_state_dict(keep, strict=False)
    return model

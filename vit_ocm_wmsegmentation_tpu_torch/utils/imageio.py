"""Image writers of the CLIs.

Counterpart of ``vit_ocm_wmsegmentation_tpu/cli.py``'s ``create_dir``,
``viridis_lut``, ``imsave_fast``, ``imsave`` and ``save_threshold_outputs``,
plus the on-device quantization of an attention map to viridis table
indices (``sw_processing.py:195``). The port does not depend on matplotlib:
the viridis table is kept here as bytes and the gray one is computed, and
:func:`imsave` applies matplotlib's own rules for ``plt.imsave``; tests hold
the tables and the rules byte-equal to matplotlib's.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..ops import threshold as th

# matplotlib's viridis colormap at 256 levels, RGB uint8, row i = index i
# (plt.get_cmap("viridis")(np.arange(256), bytes=True)[:, :3])
_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
)
VIRIDIS = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), np.uint8).reshape(256, 3)
# matplotlib's "gray" at 256 levels as bytes: its table i / 255 truncated
# after the product by 255, so 24 levels land one below i
GRAY = np.repeat((np.linspace(0.0, 1.0, 256) * 255).astype(np.uint8)[:, None], 3, axis=1)
_CMAPS = {None: VIRIDIS, "viridis": VIRIDIS, "gray": GRAY}


def create_dir(path: str):
    os.makedirs(path, exist_ok=True)


def attention_lut_index(attention):
    """(H, W) attention -> uint8 viridis indices, on the attention's device:
    clip(floor(min_max_normalize(attention) * 256), 0, 255), matplotlib's
    own 256-level quantization of a colormapped float image, over row
    chunks so that no full-size float temporary is made."""
    lo, hi = attention.min().float(), attention.max().float()
    return th.map_rows(
        lambda a: torch.clamp(torch.floor(th._normalize(a.float(), lo, hi) * 256.0), 0, 255)
        .to(torch.uint8), attention)


def imsave_fast(fname: str, arr_u8, cmap=None):
    """Write a uint8 (H, W) array as PNG bytes whatever the extension,
    lossless, at compression level 1. ``cmap=None`` reads ``arr_u8`` as
    viridis indices and writes RGB; ``"gray"`` writes the plane as is."""
    arr_u8 = np.asarray(arr_u8, dtype=np.uint8)
    if cmap == "gray":
        im = Image.fromarray(arr_u8, mode="L")
    else:
        im = Image.fromarray(VIRIDIS[arr_u8])
    im.save(fname, format="PNG", compress_level=1)


def _lut_index(arr):
    """matplotlib's 256-level index of a colormapped 2-D array (its
    Normalize, then the colormap's float lookup): floor((x - min) / (max -
    min) * 256) clipped to 255, in float32 (float64 for float64 data), and 0
    everywhere for a constant array."""
    a = arr if arr.dtype == torch.float64 else arr.float()
    lo, hi = a.min(), a.max()
    if bool(hi == lo):
        return torch.zeros(a.shape, dtype=torch.uint8, device=a.device)
    return torch.clamp(torch.floor((a - lo) / (hi - lo) * 256.0), 0, 255).to(torch.uint8)


def imsave(fname: str, arr, cmap=None):
    """``plt.imsave(fname, arr, format="png", cmap=cmap)`` without
    matplotlib: an RGBA PNG whatever the extension, pixel for pixel
    matplotlib's. A 2-D array (float, integer or bool, a tensor on any
    device or a numpy array) is min-max normalized and colormapped (viridis
    by default, or "gray"); an (H, W, 3) float image in [0, 1] is written as
    uint8(x * 255), truncated, and a uint8 one as it is."""
    t = torch.as_tensor(arr) if not isinstance(arr, torch.Tensor) else arr
    if t.ndim == 2:
        if cmap not in _CMAPS:
            raise ValueError(f"imsave: colormap {cmap!r} not in {sorted(map(str, _CMAPS))}")
        rgb = _CMAPS[cmap][_lut_index(t).cpu().numpy()]
    elif t.ndim == 3 and t.shape[-1] == 3:
        if t.dtype == torch.uint8:
            rgb = t.cpu().numpy()
        else:
            x = t if t.dtype == torch.float64 else t.float()
            if bool(x.max() > 1) or bool(x.min() < 0):
                raise ValueError("Floating point image RGB values must be in the 0..1 range.")
            rgb = (x * 255).to(torch.uint8).cpu().numpy()
    else:
        raise ValueError(f"imsave: an (H, W) or (H, W, 3) array, not {tuple(t.shape)}")
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    # zlib level 1: the same pixels as matplotlib's level-6 file, written faster
    Image.fromarray(np.ascontiguousarray(rgba), mode="RGBA").save(fname, format="PNG",
                                                                 compress_level=1)
    print(f"{fname} saved.")


def save_threshold_outputs(output_directory: str, img_u8, attention, name: str | None = None):
    """The reference threshold()'s files (utils.py:83-115) for a uint8 gray
    image and its attention map, both (H, W) tensors on one device: the
    blend (result.png, weighted_iamge_attention.png), the three Otsu masks
    and the quantized attention (temp.png). Returns the three masks."""
    blend_u8, attn_u8 = th.blend_ours(img_u8, attention)
    masks = th.threshold_ours(img_u8, attention)
    imsave(os.path.join(output_directory, "result.png"), blend_u8)
    subdir = ""
    if name is not None:
        subdir = name + "/"
        create_dir(os.path.join(output_directory, subdir))
    imsave(os.path.join(output_directory, subdir, "OTSU_th_average.png"), masks[0], cmap="gray")
    imsave(os.path.join(output_directory, "OTSU_th_original.png"), masks[1], cmap="gray")
    imsave(os.path.join(output_directory, "weighted_iamge_attention.png"), blend_u8, cmap="gray")
    imsave(os.path.join(output_directory, "heatmap_otsu_attention.png"), masks[2], cmap="gray")
    imsave(os.path.join(output_directory, "temp.png"), attn_u8)
    return masks

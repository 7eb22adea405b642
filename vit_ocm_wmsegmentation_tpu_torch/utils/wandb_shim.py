"""File-backed Weights & Biases logging, with no network.

The port's copy of ``vit_ocm_wmsegmentation_tpu/utils/wandb_shim.py``'s
offline shim. The reference logs scalars and image panels to W&B
(eval.py:258-282); here scalars append to ``<output>/wandb_offline.jsonl``
and each ``wandb.Image`` panel is written as a PNG under
``<output>/wandb_images/step{N}/``. The W&B client itself is never
imported, so nothing is sent anywhere.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np


def _to_u8(arr) -> np.ndarray:
    """wandb.Image's dtype handling: integer data is 0-255 already (clipped);
    float data in [0, 1] is scaled by 255, other float data clipped to
    [0, 255]. No contrast stretch: a constant panel keeps its shade."""
    a = np.squeeze(np.asarray(arr))
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        return np.clip(a, 0, 255).astype(np.uint8)
    a = a.astype(np.float32)
    if a.size and a.min() >= 0.0 and a.max() <= 1.0:
        a = a * 255.0
    return np.clip(a, 0.0, 255.0).astype(np.uint8)


class _FileImage:
    """wandb.Image stand-in: the array and its caption."""

    def __init__(self, data, caption: str = "image", **kwargs):
        self.data = data
        self.caption = caption


class FileWandb:
    """wandb without a network: log() writes scalars to JSONL and images
    to PNGs under the output directory."""

    Image = _FileImage

    def __init__(self, output_dir: str | None = None):
        self._dir = output_dir
        self._step = 0

    def init(self, *args, **kwargs):
        cfg = kwargs.get("dir") or (args[0] if args else None)
        if isinstance(cfg, str):
            self._dir = cfg
        return self

    def _save_image(self, img: _FileImage, step: int, idx: int, panel: str):
        if not self._dir:
            return
        from PIL import Image as PILImage

        d = os.path.join(self._dir, "wandb_images", f"step{step}")
        os.makedirs(d, exist_ok=True)
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", img.caption) or f"img{idx}"
        PILImage.fromarray(_to_u8(img.data)).save(os.path.join(d, f"{panel}_{slug}.png"))

    def log(self, data: dict, step: int | None = None, **kwargs):
        step = self._step if step is None else step
        self._step = step + 1
        scalars = {}
        for key, val in data.items():
            if isinstance(val, _FileImage):
                self._save_image(val, step, 0, key)
            elif isinstance(val, (list, tuple)) and val and isinstance(val[0], _FileImage):
                for i, im in enumerate(val):
                    self._save_image(im, step, i, key)
            else:
                try:
                    scalars[key] = float(val)
                except (TypeError, ValueError):
                    pass
        if self._dir and scalars:
            os.makedirs(self._dir, exist_ok=True)
            with open(os.path.join(self._dir, "wandb_offline.jsonl"), "a") as f:
                f.write(json.dumps({"step": step, **scalars}) + "\n")

    def __getattr__(self, name):  # finish(), watch(), ...
        def _noop(*args, **kwargs):
            return None

        return _noop


def get_wandb(enabled: bool, output_dir: str | None = None):
    """(logger, enabled): the file-backed logger writing into ``output_dir``
    when enabled, else one that writes nothing."""
    return FileWandb(output_dir if enabled else None), bool(enabled)

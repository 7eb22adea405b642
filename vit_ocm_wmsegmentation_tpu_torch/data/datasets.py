"""SimMIM training data: image listing, augmentation, masking, batching.

The port's copy of the host loader of
``vit_ocm_wmsegmentation_tpu/data/datasets.py`` (data.py of the
reference): RandomResizedCrop(scale=(0.67, 1), ratio=(3/4, 4/3)) + random
horizontal and vertical flips + ToTensor, plus the MaskGenerator, drawn from
one numpy ``Generator`` per (seed, epoch) in the same order, so one seed
gives the same batches as the JAX package's loader. Batches are numpy
arrays; the trainer moves them to the device. ROI-restricted masking is not
ported (it needs ``ops/morphology.get_rois``).
"""

from __future__ import annotations

import math
import os
from glob import glob
from typing import Iterator

import numpy as np
from PIL import Image

from .mask_generator import MaskGenerator


def list_images(path: str, pattern: str = "/*") -> list[str]:
    """glob helper matching build_loader_simmim (data.py:271-275)."""
    if os.path.isfile(path):
        return sorted(glob(path))
    return sorted(glob(path + pattern))


def random_resized_crop(img: Image.Image, rng: np.random.Generator, out_size: int,
                        scale=(0.67, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)) -> Image.Image:
    """torchvision RandomResizedCrop's sampling algorithm (10 attempts, then
    center fallback), BILINEAR resize."""
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = int(rng.integers(0, h - ch + 1))
            j = int(rng.integers(0, w - cw + 1))
            return img.resize((out_size, out_size), Image.Resampling.BILINEAR,
                              box=(j, i, j + cw, i + ch))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    i, j = (h - ch) // 2, (w - cw) // 2
    return img.resize((out_size, out_size), Image.Resampling.BILINEAR, box=(j, i, j + cw, i + ch))


class SimMIMTransform:
    """Aug + mask pair generator (data.py:189-253, minus its debug dumps)."""

    def __init__(self, img_size: int, mask_patch_size: int, model_patch_size: int,
                 mask_ratio: float, roi_masking: bool = False):
        if roi_masking:
            raise NotImplementedError("roi_masking is not ported yet (it needs the connected-"
                                      "component ROIs of ops/morphology.get_rois)")
        self.img_size = img_size
        self.mask_generator = MaskGenerator(img_size, mask_patch_size, model_patch_size, mask_ratio)

    def __call__(self, img: Image.Image, rng: np.random.Generator):
        img = random_resized_crop(img.convert("RGB"), rng, self.img_size)
        if rng.random() < 0.5:
            img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        if rng.random() < 0.5:
            img = img.transpose(Image.Transpose.FLIP_TOP_BOTTOM)
        return np.asarray(img, dtype=np.float32) / 255.0, self.mask_generator(rng)


def build_simmim_loader(image_path: str, batch_size: int, img_size: int, mask_patch_size: int,
                        model_patch_size: int, mask_ratio: float, roi_masking: bool = False,
                        seed: int = 0, drop_last: bool = True, cache_images: bool = True) -> "Loader":
    transform = SimMIMTransform(img_size, mask_patch_size, model_patch_size, mask_ratio, roi_masking)
    return Loader(list_images(image_path), transform, batch_size, seed=seed, drop_last=drop_last,
                  cache_images=cache_images)


class Loader:
    """Epoch-based loader: per-item PIL decode + transform, stacked into
    numpy batches (B, S, S, 3) float32 and masks (B, g, g) int32.
    Deterministic per (seed, epoch); ``cache_images`` decodes each file once.
    Unreadable files are skipped with a message, as the JAX loader does."""

    def __init__(self, paths, transform, batch_size, seed=0, drop_last=True, cache_images=False):
        self.paths = list(paths)
        self.transform = transform
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self._cache = {} if cache_images else None

    def _open(self, path):
        if self._cache is None:
            return Image.open(path)
        if path not in self._cache:
            img = Image.open(path)
            img.load()
            self._cache[path] = img
        return self._cache[path]

    def __len__(self):
        n = len(self.paths) // self.batch_size
        if not self.drop_last and len(self.paths) % self.batch_size:
            n += 1
        return max(n, 0)

    def epoch(self, epoch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch))
        pending = list(rng.permutation(len(self.paths)))
        imgs, masks = [], []
        while pending or (imgs and not self.drop_last):
            if pending:
                i = pending.pop(0)
                try:
                    arr, mask = self.transform(self._open(self.paths[i]), rng)
                except Exception as e:
                    print(f"Error reading image: {self.paths[i]} ({e}); skipping")
                    continue
                imgs.append(arr)
                masks.append(mask)
            if len(imgs) == self.batch_size or (not pending and imgs and not self.drop_last):
                yield np.stack(imgs), np.stack(masks)
                imgs, masks = [], []

"""Labeled eval samples, and SimMIM training data: image listing,
augmentation, masking, batching.

The port's copy of the host loaders of
``vit_ocm_wmsegmentation_tpu/data/datasets.py`` (data.py of the
reference). Eval images and labels resize with PIL NEAREST to the square
image size (data.py:282-306); the grid-crop variant (crop > 1) keeps the
bicubic resize it cuts its grid from (data.py:97-122). Training:
RandomResizedCrop(scale=(0.67, 1), ratio=(3/4, 4/3)) + random
horizontal and vertical flips + ToTensor, plus the MaskGenerator, drawn from
one numpy ``Generator`` per (seed, epoch) in the same order, so one seed
gives the same batches as the JAX package's loader, with the optional
ROI-restricted masking (the mask kept only on the connected components of
the image's foreground, ``ops/morphology.get_rois``). Batches are numpy
arrays; the trainer moves them to the device. :class:`DeviceAugLoader`
(DATA.DEVICE_AUG) keeps the decoded sources on the device as uint8 and runs
the whole transform there (``data/device_aug.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from glob import glob
from typing import Iterator

import numpy as np
import torch
from PIL import Image

from ..utils.profiling import annotate
from .mask_generator import MaskGenerator


def list_images(path: str, pattern: str = "/*") -> list[str]:
    """glob helper matching build_loader_simmim (data.py:271-275)."""
    if os.path.isfile(path):
        return sorted(glob(path))
    return sorted(glob(path + pattern))


def load_rgb_resized(path: str, size_hw, resample=Image.Resampling.NEAREST) -> np.ndarray:
    """-> float32 (H, W, 3) in [0, 1] (PIL resize, then ToTensor's /255)."""
    img = Image.open(path).convert("RGB").resize((size_hw[1], size_hw[0]), resample)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_gray_resized(path: str, size_hw, resample=Image.Resampling.NEAREST) -> np.ndarray:
    """-> uint8 (H, W): resized as RGB, then converted to L, the reference's
    order (the resize on RGB, convert('L') later in threshold())."""
    img = Image.open(path).convert("RGB").resize((size_hw[1], size_hw[0]), resample)
    return np.array(img.convert("L"), dtype=np.uint8)


@dataclasses.dataclass
class EvalSample:
    image: np.ndarray  # float32 (H, W, 3) in [0, 1]
    gray: np.ndarray  # uint8 (H, W)
    label: np.ndarray  # float32 (H, W) in [0, 1]
    path: str
    # crop > 1 only: the reference opens the source again and resizes it
    # with PIL's default filter (bicubic) before cutting the grid
    # (data.py:99-102), so the grid source is not the NEAREST eval image
    crop_image: np.ndarray | None = None  # float32 (H, W, 3) in [0, 1]
    crop_gray: np.ndarray | None = None  # uint8 (H, W)
    # the image is exactly the gray replicated (a grayscale source): the
    # batched eval then sends uint8 gray to the device instead of f32 RGB
    gray_exact: bool = False


def build_eval_samples(eval_dataset_path: str, image_size: int, crop: int = 1) -> list[EvalSample]:
    """build_eval_loader (data.py:282-306): images/ and labels/ subfolders,
    NEAREST resize to the square image_size. With crop > 1 the bicubic grid
    source of AIP_Croped_Labeled_Dataset (data.py:97-122) is loaded too."""
    images = sorted(glob(eval_dataset_path + "/images/*"))
    labels = sorted(glob(eval_dataset_path + "/labels/*"))
    assert len(images) == len(labels), f"{len(images)} images vs {len(labels)} labels"
    out = []
    for ip, lp in zip(images, labels):
        rgb = load_rgb_resized(ip, (image_size, image_size))
        gray = load_gray_resized(ip, (image_size, image_size))
        lab = Image.open(lp).convert("L").resize((image_size, image_size), Image.Resampling.NEAREST)
        crop_rgb = crop_gray = None
        if crop > 1:
            crop_rgb = load_rgb_resized(ip, (image_size, image_size), Image.Resampling.BICUBIC)
            # the reference's crop > 1 gray is channel 0 of the re-assembled
            # crops replicated to RGB (eval.py:161-166), not a luma; the f32
            # /255 * 255 round trip is exact in uint8, so it is the R plane
            crop_gray = np.round(crop_rgb[..., 0] * 255.0).astype(np.uint8)
        gray_exact = bool(
            np.array_equal(rgb[..., 0], rgb[..., 1])
            and np.array_equal(rgb[..., 1], rgb[..., 2])
            and np.array_equal(np.round(rgb[..., 0] * 255.0).astype(np.uint8), gray)
        )
        out.append(EvalSample(rgb, gray, np.asarray(lab, np.float32) / 255.0, ip,
                              crop_rgb, crop_gray, gray_exact))
    return out


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
        self.img_size = img_size
        self.roi_masking = roi_masking
        self.mask_generator = MaskGenerator(img_size, mask_patch_size, model_patch_size, mask_ratio)

    def __call__(self, img: Image.Image, rng: np.random.Generator):
        img = random_resized_crop(img.convert("RGB"), rng, self.img_size)
        if rng.random() < 0.5:
            img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        if rng.random() < 0.5:
            img = img.transpose(Image.Transpose.FLIP_TOP_BOTTOM)
        mask = self.mask_generator(rng)
        if self.roi_masking:
            mask = self._restrict_to_rois(img, mask)
        return np.asarray(img, dtype=np.float32) / 255.0, mask

    @staticmethod
    def _restrict_to_rois(img: Image.Image, mask: np.ndarray) -> np.ndarray:
        """The mask on the ROIs of the gray > 10 foreground only (the ROI
        labels resized to the mask grid, order 0), kept as it was where that
        leaves nothing masked."""
        from ..ops.morphology import get_rois

        gray = np.asarray(img.convert("L"))
        rois = get_rois(np.where(gray > 10, 255, 0).astype(np.uint8))
        ys = (np.arange(mask.shape[0]) * rois.shape[0] / mask.shape[0]).astype(int)
        xs = (np.arange(mask.shape[1]) * rois.shape[1] / mask.shape[1]).astype(int)
        new_mask = mask * (rois[np.ix_(ys, xs)] != 0).astype(mask.dtype)
        return new_mask if new_mask.sum() != 0 else mask


def build_simmim_loader(image_path: str, batch_size: int, img_size: int, mask_patch_size: int,
                        model_patch_size: int, mask_ratio: float, roi_masking: bool = False,
                        seed: int = 0, drop_last: bool = True, cache_images: bool = True) -> "Loader":
    transform = SimMIMTransform(img_size, mask_patch_size, model_patch_size, mask_ratio, roi_masking)
    return Loader(list_images(image_path), transform, batch_size, seed=seed, drop_last=drop_last,
                  cache_images=cache_images)


def build_simmim_device_loader(image_path: str, batch_size: int, img_size: int,
                               mask_patch_size: int, model_patch_size: int, mask_ratio: float,
                               seed: int = 0, drop_last: bool = True,
                               device="cuda") -> "DeviceAugLoader":
    """The DATA.DEVICE_AUG loader: the host decodes, the device augments.
    ROI masking needs host connected components: the host loader does it."""
    return DeviceAugLoader(list_images(image_path), batch_size, img_size, mask_patch_size,
                           model_patch_size, mask_ratio, seed=seed, drop_last=drop_last,
                           device=device)


class DeviceAugLoader:
    """The dataset resident on the device as uint8 and the SimMIM transform
    run there (``data/device_aug.simmim_augment``).

    Every source is decoded once, at the size of the first readable image
    (others are PIL-bilinear-resized to it, where the reference crops each
    at its own size); grayscale sources (OCM tiles) are kept as one channel.
    A set larger than ``max_resident_bytes`` stays on the host and each
    batch's uint8 sources are sent to the device. Yields (images (B, S, S,
    3) float32, masks (B, g, g) int32) on the device; the order is a numpy
    permutation per (seed, epoch), sent to resident sources once an epoch
    without a host sync, the augmentation draws from a
    ``torch.Generator`` on the device seeded per (seed, epoch, batch), so
    an epoch is deterministic. Under a profiler the epoch's set-up and each
    batch run inside a ``data.device_aug`` span (utils.profiling), closed
    before the batch is yielded, so that the consumer's work between two
    batches stays outside it."""

    def __init__(self, paths, batch_size, img_size, mask_patch_size, model_patch_size,
                 mask_ratio, seed=0, drop_last=True, device="cuda", max_resident_bytes=4 << 30):
        self.paths = list(paths)
        self.batch_size = batch_size
        self.img_size = img_size
        self.mask_patch_size = mask_patch_size
        self.model_patch_size = model_patch_size
        self.mask_ratio = mask_ratio
        self.seed = seed
        self.drop_last = drop_last
        self.device = torch.device(device)
        self.max_resident_bytes = max_resident_bytes
        self._src = None  # (N, H, W[, 3]) uint8, on the device or the host
        self._n: int | None = None

    def _ensure_sources(self):
        if self._n is not None:
            return
        arrs, canonical, all_gray = [], None, True
        for p in self.paths:
            try:
                img = Image.open(p).convert("RGB")
            except Exception as e:
                print(f"Error reading image: {p} ({e}); skipping")
                continue
            if canonical is None:
                canonical = img.size
            elif img.size != canonical:
                img = img.resize(canonical, Image.Resampling.BILINEAR)
            a = np.asarray(img, dtype=np.uint8)
            all_gray = all_gray and bool(np.array_equal(a[..., 0], a[..., 1])
                                         and np.array_equal(a[..., 1], a[..., 2]))
            arrs.append(a)
        self._n = len(arrs)
        if not arrs:
            return
        src = np.stack(arrs)
        if all_gray:
            src = np.ascontiguousarray(src[..., 0])
        src = torch.from_numpy(src)
        self._src = src.to(self.device) if src.nbytes <= self.max_resident_bytes else src

    def __len__(self):
        self._ensure_sources()
        n = self._n // self.batch_size
        if not self.drop_last and self._n % self.batch_size:
            n += 1
        return max(n, 0)

    def epoch(self, epoch: int):
        from .device_aug import simmim_augment

        with annotate("data.device_aug"):
            self._ensure_sources()
            n = self._n
            order = torch.from_numpy(np.random.default_rng((self.seed, epoch)).permutation(n))
            if self._src is not None and self._src.is_cuda:
                # from pinned memory without a wait: the upload queues behind
                # the steps still running instead of draining them
                order = order.pin_memory().to(self._src.device, non_blocking=True)
            stop = n - n % self.batch_size if self.drop_last else n
            gen = torch.Generator(device=self.device)
        for batch_idx, s0 in enumerate(range(0, stop, self.batch_size)):
            with annotate("data.device_aug"):
                batch = self._src[order[s0 : s0 + self.batch_size]].to(self.device)
                gen.manual_seed(int(np.random.SeedSequence((self.seed, epoch, batch_idx))
                                    .generate_state(1, np.uint64)[0] >> 1))
                out = simmim_augment(batch, gen, out_size=self.img_size,
                                     mask_patch_size=self.mask_patch_size,
                                     model_patch_size=self.model_patch_size,
                                     mask_ratio=self.mask_ratio)
            yield out


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

"""Supervised and pseudo-supervised dense-prediction training: the loop
behind the port's finetune, PGT and UNet entry points.

Counterpart of ``vit_ocm_wmsegmentation_tpu/train/supervised.py`` (the
reference's finetune.py:59-363, unet.py:191-452, PGT.py:50-401): Adam and
ReduceLROnPlateau (patience 5, factor 0.1), Dice loss, best-validation
checkpointing, and a per-image test pass with Jaccard, F1, recall,
precision, accuracy and ROC-AUC plus image|GT|prediction triptychs.

Images load as the reference loads them with cv2, without cv2:
:func:`imread` decodes with PIL into cv2.imread's bytes (BGR order, PNG's
16-bit samples cut to their high byte, libpng's truncated luma for a colour
image read as grayscale), and :func:`resize_linear_u8` /
:func:`resize_nearest_u8` are cv2.resize's INTER_LINEAR (fixed-point
weights with 11 fractional bits, its rounding) and INTER_NEAREST on uint8.
JPEG decodes through PIL's libjpeg, not cv2's, and cv2's EXIF rotation is
not applied: the bytes are cv2's for PNG.

The PGT teacher (:func:`teacher_pseudo_labels`) makes the pseudo-labels of
a whole batch on the device in one pass: CLS attention on the inference
kernels, head average, smoothing, the Otsu blend threshold.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from PIL import Image

from ..ops.metrics import calculate_metrics, dice_loss, roc_auc
from ..ops.resize import smooth_attention
from ..ops.threshold import threshold_ours
from ..pipeline import exact_matmuls, head_average_attention
from . import checkpoint as ckpt

# ---------------------------------------------------------------------------
# cv2.imread and cv2.resize on uint8, without cv2
# ---------------------------------------------------------------------------

# libpng's png_set_rgb_to_gray(1, 0.299, 0.587) weights in 1/32768
# (29900 * 32768 // 100000, ...), the blue one taking the remainder
_PNG_GRAY = (9797, 19234, 32768 - 9797 - 19234)


def _size_hw(size):
    """int -> square; (H, W) passes through (unet's --H / --W)."""
    return (size, size) if isinstance(size, int) else tuple(size)


def imread(path, gray: bool = False) -> np.ndarray:
    """cv2.imread(path, IMREAD_COLOR or IMREAD_GRAYSCALE): uint8 (H, W, 3) in
    BGR order, or (H, W). Grey images are replicated, alpha dropped, 16-bit
    samples cut to their high byte, and a colour image read as grayscale
    takes libpng's truncated luma (a pixel with equal channels keeps its
    value), as cv2 decodes a PNG."""
    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I;16L", "I"):
            a = (np.asarray(im).astype(np.uint32) >> 8).astype(np.uint8)
            return a if gray else np.repeat(a[..., None], 3, axis=-1)
        rgb = np.asarray(im.convert("RGB"))
    if not gray:
        return np.ascontiguousarray(rgb[..., ::-1])
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    luma = (r * _PNG_GRAY[0] + g * _PNG_GRAY[1] + b * _PNG_GRAY[2]) >> 15
    return np.where((r == g) & (r == b), r, luma).astype(np.uint8)


def _linear_taps(ssize: int, dsize: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis: source indices (i0, i1) and
    fixed-point weights (a0, a1) in 1/2048. The centre is computed in double
    and rounded to float, the weights are float, rounded half to even. Along
    x a tap left of the first source pixel or right of the last gets weight
    (2048, 0) on the edge pixel; along y (``clamp=False``) the weights stay
    and both rows clip to the edge, as cv2 does."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = i0 < 0, i0 >= ssize - 1
        f[low | high] = 0
        i0[low], i0[high] = 0, ssize - 1
    a0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    a1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return np.clip(i0, 0, ssize - 1), np.clip(i0 + 1, 0, ssize - 1), a0, a1


def resize_linear_u8(img: np.ndarray, size_hw) -> np.ndarray:
    """cv2.resize(img, (w, h)) with INTER_LINEAR for uint8 (H, W) or (H, W, C):
    a horizontal pass in integers (weights in 1/2048), then the vertical
    one as cv2's uint8 path rounds it, ((b0 * (S0 >> 4)) >> 16) +
    ((b1 * (S1 >> 4)) >> 16) + 2 >> 2. The same size returns a copy."""
    h, w = size_hw
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img.copy()
    x = img.astype(np.int64)
    trail = (None,) * (img.ndim - 2)
    i0, i1, a0, a1 = _linear_taps(sw, w, clamp=True)
    rows = x[:, i0] * a0[(None, slice(None)) + trail] + x[:, i1] * a1[(None, slice(None)) + trail]
    j0, j1, b0, b1 = _linear_taps(sh, h, clamp=False)
    b0, b1 = b0[(slice(None), None) + trail], b1[(slice(None), None) + trail]
    out = (((b0 * (rows[j0] >> 4)) >> 16) + ((b1 * (rows[j1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_nearest_u8(img: np.ndarray, size_hw) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST): source index
    floor(i * (1 / (d / s))) in double, clipped to the last pixel."""
    h, w = size_hw

    def idx(s, d):
        return np.minimum(np.floor(np.arange(d) * (1.0 / (d / s))).astype(np.int64), s - 1)

    return img[idx(img.shape[0], h)][:, idx(img.shape[1], w)]


def read_image_u8(path, size) -> np.ndarray:
    """cv2.resize(cv2.imread(path, IMREAD_COLOR), (w, h)): uint8 (H, W, 3) BGR."""
    return resize_linear_u8(imread(path), _size_hw(size))


def read_mask_u8(path, size, nearest: bool = False) -> np.ndarray:
    """A grayscale mask resized with INTER_LINEAR (or INTER_NEAREST): (H, W)."""
    resize = resize_nearest_u8 if nearest else resize_linear_u8
    return resize(imread(path, gray=True), _size_hw(size))


def load_image_cv2(path, size) -> np.ndarray:
    """finetune.py:25-53's image: /255 in float64, as float32 (H, W, 3). The
    BGR order is kept: the reference feeds it to the model as it is."""
    return (read_image_u8(path, size) / 255.0).astype(np.float32)


def load_mask_cv2(path, size, nearest: bool = False) -> np.ndarray:
    return (read_mask_u8(path, size, nearest) / 255.0).astype(np.float32)


def _unit(u8):
    """uint8 -> float32 / 255 by true division on every device (a division
    by a Python scalar runs as a product with its reciprocal on CUDA)."""
    return u8.float() / torch.full((), 255.0, device=u8.device)


class SegLoader:
    """Labeled (or, for PGT, unlabeled) batch iterator.

    Every image is decoded once (cv2's uint8 resize) into a uint8 stack on
    ``device``, and batches are gathered there, /255 included: after the
    first epoch no image byte crosses the host link. The supervised sets are
    small (~70 x 512^2). Batches are float32: x (B, H, W, 3) and, with
    labels, y (B, H, W, 1)."""

    def __init__(self, images, labels=None, image_size=512, batch_size=2, shuffle=False, seed=42,
                 device="cpu"):
        self.images, self.labels = list(images), (list(labels) if labels is not None else None)
        self.image_size, self.batch_size = image_size, batch_size
        self.shuffle, self.seed = shuffle, seed
        self.device = torch.device(device)
        self._dev = None  # (x_u8 (N, H, W, 3), y_u8 (N, H, W, 1) | None)

    def __len__(self):
        return (len(self.images) + self.batch_size - 1) // self.batch_size

    def _ensure_device_stack(self):
        if self._dev is not None:
            return
        xs = np.stack([read_image_u8(p, self.image_size) for p in self.images])
        ys = None
        if self.labels is not None:
            ys = np.stack([read_mask_u8(p, self.image_size) for p in self.labels])[..., None]
            ys = torch.from_numpy(ys).to(self.device)
        self._dev = (torch.from_numpy(xs).to(self.device), ys)

    def epoch(self, epoch=0):
        if not self.images:
            return  # an empty split yields nothing
        order = np.arange(len(self.images))
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(order)
        self._ensure_device_stack()
        xd, yd = self._dev
        for s in range(0, len(order), self.batch_size):
            idx = torch.from_numpy(order[s : s + self.batch_size]).to(self.device)
            x = _unit(xd.index_select(0, idx))
            yield x if yd is None else (x, _unit(yd.index_select(0, idx)))


def split_reference(images, labels, kind: str, ratio=1.0):
    """The hard-coded splits of the reference entry points."""
    if kind == "finetune":  # finetune.py:119-128, 259-264
        tr, va, te = slice(0, 50), slice(50, 70), slice(70, None)
    elif kind == "unet":  # unet.py:209-216, 349-354
        tr, va, te = slice(0, 25), slice(25, 30), slice(30, None)
    elif kind == "pgt":  # PGT.py:161-165
        tr, va, te = slice(0, 200), slice(200, None), slice(200, None)
    else:
        raise ValueError(kind)
    train_x = images[tr][: int(len(images[tr]) * ratio)]
    train_y = labels[tr][: int(len(labels[tr]) * ratio)] if labels else None
    return ((train_x, train_y), (images[va], labels[va] if labels else None),
            (images[te], labels[te] if labels else None))


# ---------------------------------------------------------------------------
# PGT teacher
# ---------------------------------------------------------------------------


def pil_luma(x):
    """ToPILImage + convert('L') of float (..., 3) images: u8 = trunc(x*255),
    then PIL's ITU-R 601-2 integer luma (R*19595 + G*38470 + B*7471 +
    2^15) >> 16."""
    u8 = (x * 255.0).to(torch.int32)
    luma = (u8[..., 0] * 19595 + u8[..., 1] * 38470 + u8[..., 2] * 7471 + (1 << 15)) >> 16
    return luma.to(torch.uint8)


def head_subset_weights(num, order, num_heads: int):
    """The ``rand`` mode's head weights (PGT.py:68-78) of one image: 1 for
    the heads at the first ``num`` positions of the permutation ``order``,
    0 elsewhere, as the JAX package's (arange < num)[argsort(order)]."""
    ranks = torch.argsort(order)
    return (ranks < num).float()


@torch.no_grad()
def teacher_pseudo_labels(teacher, x, generator: torch.Generator | None = None):
    """(B, H, W, 3) float batch -> (B, H, W, 1) {0, 1} float pseudo-masks
    (PGT.py:57-86), on x's device: the teacher's last-block CLS attention on
    the inference kernels (``models.vit.cls_attention_grid``), averaged
    over the heads, smoothed to the image, then threshold_ours's blend mask
    against the image's PIL luma.

    With a ``generator`` (the reference's ``rand`` mode) each image averages
    a random subset of 1..num_heads heads: the subset size and a
    permutation are drawn from the CPU generator per image. The draws are
    torch's, so they are not the JAX package's keys. The masks are ordinary
    tensors (not inference tensors), fit to be a loss target."""
    b, h, w, _ = x.shape
    gray = pil_luma(x)
    with exact_matmuls():
        if generator is None:
            avg = head_average_attention(teacher, x)
        else:
            from ..models.vit import cls_attention_grid

            grids = cls_attention_grid(teacher, x)  # (B, nh, gh, gw)
            nh = teacher.cfg.num_heads
            wts = torch.stack([
                head_subset_weights(int(torch.randint(1, nh + 1, (), generator=generator)),
                                    torch.randperm(nh, generator=generator), nh)
                for _ in range(b)]).to(grids.device)
            avg = torch.einsum("bh,bhij->bij", wts.to(grids.dtype), grids) / wts.sum(
                1, keepdim=True)[..., None].to(grids.dtype)
    attn = smooth_attention(avg, teacher.cfg.patch_size, (h, w))
    masks = threshold_ours(gray, attn)[0]
    return _unit(masks)[..., None]


# ---------------------------------------------------------------------------
# Train / evaluate / test
# ---------------------------------------------------------------------------


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau('min', patience=5): an
    epoch counts as improved only when metric < best * (1 - threshold)
    (threshold_mode 'rel', 1e-4); after more than ``patience`` epochs
    without improvement the rate drops by ``factor``."""

    def __init__(self, lr, patience=5, factor=0.1, min_lr=0.0, threshold=1e-4):
        self.lr, self.patience, self.factor, self.min_lr = lr, patience, factor, min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
        return self.lr


def make_adam(model, lr):
    """Adam over the parameters that require a gradient (optax.adam: betas
    0.9 / 0.999, eps 1e-8 added outside the square root)."""
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)


def make_seg_step(apply_fn, model, optimizer):
    """apply_fn(model, x, train) -> logits (B, H, W, 1). Returns
    train_step(x, y, lr) -> loss (one Adam step on the Dice loss at rate
    lr; BatchNorm running statistics update in place) and eval_step(x, y)
    -> loss, both 0-dim tensors on the model's device."""

    def train_step(x, y, lr):
        loss = dice_loss(apply_fn(model, x, True), y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(x, y):
        return dice_loss(apply_fn(model, x, False), y)

    return train_step, eval_step


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_supervised(apply_fn, model, train_loader, valid_loader, *, epochs, lr,
                     checkpoint_path, pseudo_label_fn=None, logger=print):
    """The fully_train loop: Adam at ``lr`` with the plateau schedule on the
    validation loss, the best-validation weights saved to
    ``checkpoint_path``/ckpt_epoch_0 and loaded back into ``model`` at the
    end. ``pseudo_label_fn(x) -> y`` turns unlabeled batches into (x, y)
    (PGT). Batches move to the model's device. Returns (model, train
    losses, valid losses). Library matmuls and convolutions run under
    ``pipeline.exact_matmuls()`` (no TF32)."""
    if len(train_loader) == 0:
        # training on nothing gives nan losses and a garbage "best"
        # checkpoint; usually a wrong --image_path root (the CLIs expect the
        # folder CONTAINING images/)
        raise ValueError("train split is empty — no images found (is --image_path the "
                         "dataset root containing images/?)")
    device = next(model.parameters()).device
    optimizer = make_adam(model, lr)
    train_step, eval_step = make_seg_step(apply_fn, model, optimizer)
    plateau = ReduceLROnPlateau(lr)

    def batches(loader, epoch):
        for batch in loader.epoch(epoch):
            if pseudo_label_fn is not None:
                x = (batch[0] if isinstance(batch, tuple) else batch).to(device)
                yield x, pseudo_label_fn(x)
            else:
                x, y = batch
                yield x.to(device), y.to(device)

    best_valid, cur_lr = float("inf"), lr
    train_losses, valid_losses = [], []
    best = _snapshot(model)
    with exact_matmuls():
        for epoch in range(epochs):
            t0 = time.time()
            tl = [train_step(x, y, cur_lr) for x, y in batches(train_loader, epoch)]
            tl = [float(v) for v in tl]  # one sync an epoch, not a batch
            vl = [float(eval_step(x, y)) for x, y in batches(valid_loader, epoch)]
            train_loss = float(np.mean(tl)) if tl else float("nan")
            if not vl and epoch == 0:
                logger("WARNING: validation split is empty (dataset smaller than the "
                       "train split); using the train loss for best-checkpoint "
                       "selection and LR plateau decisions")
            # an empty valid split must not poison best/plateau with NaN
            valid_loss = float(np.mean(vl)) if vl else train_loss
            train_losses.append(train_loss)
            valid_losses.append(valid_loss)
            if valid_loss < best_valid:
                logger(f"Valid loss improved from {best_valid:2.4f} to {valid_loss:2.4f}. "
                       f"Saving checkpoint: {checkpoint_path}")
                best_valid = valid_loss
                best = _snapshot(model)
                ckpt.save_checkpoint(checkpoint_path, 0, model)
            cur_lr = plateau.step(valid_loss)
            dt = time.time() - t0
            logger(f"Epoch: {epoch+1:02} | Epoch Time: {int(dt//60)}m {int(dt%60)}s\n"
                   f"\tTrain Loss: {train_loss:.3f}\n\t Val. Loss: {valid_loss:.3f}")
    model.load_state_dict(best)
    return model, train_losses, valid_losses


@torch.no_grad()
def test_supervised(apply_fn, model, test_x, test_y, image_size, results_dir, *,
                    pseudo_label_fn=None, mask_nearest=True, logger=print):
    """fully_test: per-image metrics and triptych PNGs. Returns the 6
    averaged metrics [jaccard, f1, recall, precision, acc, roc] (numpy) and
    the mean loss. ``test_y`` entries of None take ``pseudo_label_fn(x)``.

    mask_nearest: the GT masks' resize. The reference's three test loops
    differ (finetune.py:301 INTER_NEAREST, unet.py:390 and PGT.py:339 cv2's
    default INTER_LINEAR), so each entry point passes its own."""
    os.makedirs(results_dir, exist_ok=True)
    device = next(model.parameters()).device
    totals = np.zeros(6)
    total_loss = 0.0
    n = len(test_x)
    with exact_matmuls():
        for xp, yp in zip(test_x, test_y):
            name = os.path.basename(xp).rsplit(".", 1)[0]
            x_np = load_image_cv2(xp, image_size)
            x = torch.from_numpy(x_np[None]).to(device)
            if yp is not None:
                y = torch.from_numpy(load_mask_cv2(yp, image_size, mask_nearest)[None, ..., None])
                y = y.to(device)
            else:
                y = pseudo_label_fn(x)
            logits = apply_fn(model, x, False)
            total_loss += float(dice_loss(logits, y))
            prob = torch.sigmoid(logits.float())
            mets = calculate_metrics(y, prob).cpu().numpy()
            totals += np.concatenate([mets, [float(roc_auc(y, prob))]])
            # triptych: image | GT | prediction (finetune.py:327-336)
            pred = (prob[0, ..., 0] > 0.5).cpu().numpy().astype(np.uint8) * 255
            gt = (y[0, ..., 0] * 255).cpu().numpy().astype(np.uint8)
            img_u8 = (x_np * 255).astype(np.uint8)
            line = np.full((x_np.shape[0], 10, 3), 128, np.uint8)
            trip = np.concatenate([img_u8, line, np.repeat(gt[..., None], 3, -1), line,
                                   np.repeat(pred[..., None], 3, -1)], axis=1)
            Image.fromarray(trip).save(os.path.join(results_dir, f"{name}.png"))
    avg = totals / max(n, 1)
    if n == 0:
        logger("WARNING: test split is empty (dataset smaller than the "
               "reference's hard-coded train/val split); metrics below are 0")
    logger(f"Jaccard: {avg[0]:1.4f} - F1: {avg[1]:1.4f} - Recall: {avg[2]:1.4f} - "
           f"Precision: {avg[3]:1.4f} - Acc: {avg[4]:1.4f} - ROC-AUC : {avg[5]:1.4f}")
    return avg, total_loss / max(n, 1)

"""Labeled evaluation: the eight segmentation methods and their metrics.

Counterpart of ``vit_ocm_wmsegmentation_tpu/evaluation.py`` (eval.py:106-283
of the reference). Each image goes through the ViT's attention path (the
attention and fused MLP kernels on a CUDA model), one of the reference's
eight methods, then Dice, accuracy, F1, precision, recall and Jaccard
against its label. Everything from the uploaded sample to the metrics runs
on the model's device; only the per-image metric scalars come back to the
host, where the meters average them.

Methods (eval.py:172-202): ours, otsu, heatmap_threshold, k-means,
k-means_ours, chan-vese, chan-vese_ours, k-means_feature_clustering.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from .data.prefetch import prefetch
from .models import vit
from .ops import cluster
from .ops import threshold as th
from .ops.chan_vese import chan_vese
from .ops.metrics import AverageMeter, calculate_metrics, dice_loss
from .ops.resize import resize_linear_cv2, smooth_attention
from .ops.stitch import concat_crops
from .pipeline import (attention_map_rgb, cast_params, exact_matmuls, head_average_attention,
                       to_model_input)

METHODS = (
    "ours",
    "otsu",
    "heatmap_threshold",
    "k-means",
    "k-means_ours",
    "chan-vese",
    "chan-vese_ours",
    "k-means_feature_clustering",
)
# methods whose crop 1 images run in batches (batch_size > 1): chan-vese
# stops per image, and feature clustering reads the ViT again per image
THRESHOLD_METHODS = ("ours", "otsu", "heatmap_threshold")
BATCHED_METHODS = THRESHOLD_METHODS + ("k-means", "k-means_ours")
METERS = ("loss", "acc", "f1", "precision", "recall", "jaccard", "time")


def apply_method(img_u8, attention, method: str):
    """(H, W) uint8 gray and (H, W) f32 attention -> the {0,255} uint8 mask
    of ``method`` (any of METHODS but k-means_feature_clustering). The
    THRESHOLD_METHODS also take a leading batch axis, image by image."""
    if method in THRESHOLD_METHODS:
        t, t2, t3 = th.threshold_ours(img_u8, attention)
        return {"ours": t, "otsu": t2, "heatmap_threshold": t3}[method]
    if method == "k-means_ours":
        return cluster.kmeans_mask_ours(img_u8, attention)
    if method == "k-means":
        return cluster.kmeans_mask_image(img_u8)
    if method == "chan-vese_ours":
        return chan_vese(th.mult_blend_u8(img_u8, attention)).to(torch.uint8) * 255
    if method == "chan-vese":
        return chan_vese(img_u8).to(torch.uint8) * 255
    raise ValueError(f"unknown method {method!r}")


def feature_clustering_mask(model, x, gray_u8, routes=vit.InferRoutes()):
    """k-means_feature_clustering (eval.py:186-202) for one image x
    (1, H, W, 3): the last block's keys upsampled bilinearly to (H, W),
    z-scored, 2-means, the {0,255} label map. The polarity comes from the
    mean gray of each cluster (cluster.kmeans_feature_mask); the label is
    never read."""
    _, h, w, _ = x.shape
    k = vit.last_block_key_features(model, x, routes)[0]  # (gh, gw, D)
    up = resize_linear_cv2(k.permute(2, 0, 1), (h, w))  # (D, H, W)
    return cluster.kmeans_feature_mask(up.permute(1, 2, 0), gray_u8)


def score_pair(output_u8, target):
    """(dice_loss, [jaccard, f1, recall, precision, acc]) with the
    reference's quirks: output / 255, then the sigmoid inside DiceLoss."""
    out = output_u8.float() / 255.0
    return dice_loss(out, target), calculate_metrics(target, out)


def _crop_attention(model, crop_image, g, median_size, dtype, routes):
    """crop > 1 attention (eval.py:135-171) of one (H, W, 3) f32 image on
    the device: its g x g tiles through one ViT call, their head-averaged
    grids concatenated, then smoothed to (H, W). The reference upsamples
    each grid by the patch, concatenates and strides back down
    (eval.py:219-231), an identity on equal tiles, so the grids are
    concatenated directly."""
    h, w, _ = crop_image.shape
    ch, cw = h // g, w // g
    tiles = crop_image.reshape(g, ch, g, cw, 3).permute(0, 2, 1, 3, 4).reshape(g * g, ch, cw, 3)
    grids = head_average_attention(model, tiles.to(dtype), median_size, routes).float()
    return smooth_attention(concat_crops(grids), model.cfg.patch_size, (h, w))


def _image_attention(model, sample, crop, median_size, dtype, routes, device):
    """Smoothed attention of one sample, crop 1 or the grid-crop variant:
    ((H, W) f32 attention, (H, W) uint8 gray), both on ``device``.

    crop > 1 follows AIP_Croped_Labeled_Dataset (data.py:97-122): the grid
    is cut from the bicubic resize of the source (sample.crop_image), and
    the gray the methods read is channel 0 of it (sample.crop_gray)."""
    if crop == 1:
        x = torch.from_numpy(sample.image)[None].to(device, dtype)
        attn = attention_map_rgb(model, x, median_size, routes)[0]
        return attn, torch.from_numpy(sample.gray).to(device)
    if sample.crop_image is None:
        raise ValueError("crop > 1 needs build_eval_samples(..., crop=crop)")
    g = math.isqrt(crop)
    attn = _crop_attention(model, torch.from_numpy(sample.crop_image).to(device), g,
                           median_size, dtype, routes)
    return attn, torch.from_numpy(sample.crop_gray).to(device)


def _batched_eval_step(model, grays_u8, targets, method, median_size, dtype, routes,
                       images=None):
    """One batch of crop 1 images of a BATCHED_METHODS method: the ViT over
    the batch, the thresholds and the scores as batched tensor operations
    (the JAX package's vmap), the k-means methods image by image.
    ``grays_u8`` (B, H, W) uint8; ``targets`` (B, H, W) in [0, 1]; ``images``
    (B, H, W, 3) f32, or None for grayscale sources, whose model input is
    the gray replicated (the same values as their RGB image). Returns
    (losses (B,), metrics (B, 5), masks (B, H, W) uint8, attention (B, H, W)
    f32)."""
    x = to_model_input(grays_u8, dtype) if images is None else images.to(dtype)
    attn = attention_map_rgb(model, x, median_size, routes)
    if method in THRESHOLD_METHODS:
        outputs = apply_method(grays_u8, attn, method)
    else:
        outputs = torch.stack([apply_method(g, a, method) for g, a in zip(grays_u8, attn)])
    losses, mets = torch.vmap(score_pair)(outputs, targets)
    return losses, mets, outputs, attn


def _log_image_panels(wandb, meters, sample, output, attn, epoch):
    """The reference's per-image W&B panels (eval.py:258-282): input,
    target, output and attention, beside the running metrics."""
    wandb.log(
        {"Loss": meters["loss"].val, "Dice": 1 - meters["loss"].avg,
         "Acc": meters["acc"].avg, "f1": meters["f1"].avg,
         "precision": meters["precision"].avg, "recall": meters["recall"].avg,
         "jaccard": meters["jaccard"].avg,
         "input_images": [
             wandb.Image(np.asarray(sample.gray), caption="Input Image"),
             wandb.Image(np.asarray(sample.label), caption="Target"),
             wandb.Image(output.cpu().numpy(), caption="Output"),
             wandb.Image(attn.float().cpu().numpy(), caption="Attention"),
         ]},
        step=epoch,
    )


def _update(meters, loss, mets, seconds):
    jac, f1, rec, prec, acc = (float(m) for m in mets)
    meters["loss"].update(float(loss), 1)
    meters["acc"].update(acc, 1)
    meters["f1"].update(f1, 1)
    meters["precision"].update(prec, 1)
    meters["recall"].update(rec, 1)
    meters["jaccard"].update(jac, 1)
    meters["time"].update(seconds)


def _log_average(logger, m):
    if logger:
        logger.info(
            f" * Acc_average: {m['acc'].avg:.3f} F1_average {m['f1'].avg:.3f} "
            f"precision {m['precision'].avg:.3f} recall {m['recall'].avg:.3f} "
            f"jaccard {m['jaccard'].avg:.3f} Dice Score {1 - m['loss'].avg:.4f}"
        )


def _batches(samples, batch_size, device):
    """The samples in batches of batch_size, stacked and uploaded on a
    prefetch thread (on CUDA by a side stream; the consumer waits on the
    returned event). Grayscale sources send uint8 gray and labels, else f32
    RGB and labels. Yields (chunk, (grays, targets, images or None), event)."""
    chunks = [samples[s0 : s0 + batch_size] for s0 in range(0, len(samples), batch_size)]
    u8_wire = all(s.gray_exact for s in samples)
    cuda = device.type == "cuda"
    upload = torch.cuda.Stream(device) if cuda else None

    def host():
        for chunk in chunks:
            grays = np.stack([s.gray for s in chunk])
            if u8_wire:
                targets = np.stack([np.round(s.label * 255.0).astype(np.uint8) for s in chunk])
                yield chunk, (grays, targets)
            else:
                yield chunk, (grays, np.stack([s.label for s in chunk]),
                              np.stack([s.image for s in chunk]))

    def place(item):
        chunk, arrays = item
        if not cuda:
            return chunk, [torch.from_numpy(a) for a in arrays], None
        with torch.cuda.stream(upload):
            dev = [torch.from_numpy(a).pin_memory().to(device, non_blocking=True) for a in arrays]
            ready = torch.cuda.Event()
            ready.record(upload)
        return chunk, dev, ready

    for chunk, arrays, ready in prefetch(host(), depth=2, place=place):
        if ready is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for a in arrays:
                a.record_stream(stream)
        grays, targets = arrays[0], arrays[1]
        if u8_wire:
            targets = targets.float() / 255.0
        yield chunk, grays, targets, (arrays[2] if len(arrays) > 2 else None)


@torch.inference_mode()
def validate(model, samples, *, method="ours", crop=1, median_size=1, logger=None, wandb=None,
             epoch=0, print_freq=1, batch_size=1, dtype=torch.float32, meters_out=None,
             routes=vit.InferRoutes(), masks_out=None):
    """(acc_avg, f1_avg, loss_avg) over ``samples`` (data.datasets.
    build_eval_samples), logged per image as the reference's validate()
    logs. ``meters_out`` (a dict) receives the AverageMeters of loss, acc,
    f1, precision, recall, jaccard and time; ``masks_out`` (a list) each
    image's uint8 mask, copied to the host.

    batch_size > 1 (crop 1, a method of BATCHED_METHODS) runs the images in
    batches through one ViT call each, with the same numbers. dtype bf16
    (eval.py --bf16 1) runs a bf16 copy of the model; its attention leaves
    the ViT in f32, and the smoothing, methods and metrics are unchanged.
    ``routes`` selects the ViT's inference routes (models.vit.InferRoutes:
    --infer_mlp, --quant)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if dtype != torch.float32:
        model = cast_params(copy.deepcopy(model), dtype)
    device = next(model.parameters()).device
    meters = {k: AverageMeter() for k in METERS}
    if meters_out is not None:
        meters_out.update(meters)
    with exact_matmuls():
        if crop == 1 and method in BATCHED_METHODS and batch_size > 1:
            end = time.time()
            for chunk, grays, targets, images in _batches(samples, batch_size, device):
                losses, mets, outputs, attns = _batched_eval_step(
                    model, grays, targets, method, median_size, dtype, routes, images)
                losses, mets = losses.cpu().numpy(), mets.cpu().numpy()
                for b in range(len(chunk)):
                    _update(meters, losses[b], mets[b], (time.time() - end) / len(chunk))
                    if masks_out is not None:
                        masks_out.append(outputs[b].cpu().numpy())
                    if wandb is not None:
                        _log_image_panels(wandb, meters, chunk[b], outputs[b], attns[b], epoch)
                end = time.time()
            _log_average(logger, meters)
            return meters["acc"].avg, meters["f1"].avg, meters["loss"].avg

        end = time.time()
        for idx, sample in enumerate(samples):
            attn, gray = _image_attention(model, sample, crop, median_size, dtype, routes, device)
            if method == "k-means_feature_clustering":
                x = torch.from_numpy(sample.image)[None].to(device, dtype)
                output = feature_clustering_mask(model, x, gray, routes)
            else:
                output = apply_method(gray, attn, method)
            loss, mets = score_pair(output, torch.from_numpy(sample.label).to(device))
            scores = torch.cat([loss[None], mets]).cpu().numpy()
            _update(meters, scores[0], scores[1:], time.time() - end)
            if masks_out is not None:
                masks_out.append(output.cpu().numpy())
            if wandb is not None:
                _log_image_panels(wandb, meters, sample, output, attn, epoch)
            end = time.time()
            if logger and idx % print_freq == 0:
                m = meters
                logger.info(
                    f"Test: [{idx}/{len(samples)}]\t"
                    f"Time {m['time'].val:.3f} ({m['time'].avg:.3f})\t"
                    f"Loss {m['loss'].val:.4f} ({m['loss'].avg:.4f})\t"
                    f"Dice Score {1 - m['loss'].val:.4f} ({1 - m['loss'].avg:.4f})\t"
                    f"Acc {m['acc'].val:.3f} ({m['acc'].avg:.3f})\t"
                    f"f1 {m['f1'].val:.3f} ({m['f1'].avg:.3f})\t"
                    f"prec {m['precision'].val:.3f} ({m['precision'].avg:.3f})\t"
                    f"recall {m['recall'].val:.3f} ({m['recall'].avg:.3f})\t"
                    f"jaccard {m['jaccard'].val:.3f} ({m['jaccard'].avg:.3f})"
                )
    _log_average(logger, meters)
    if wandb is not None:
        wandb.log(
            {"Loss": meters["loss"].val, "Dice": 1 - meters["loss"].avg, "Acc": meters["acc"].avg,
             "f1": meters["f1"].avg, "precision": meters["precision"].avg,
             "recall": meters["recall"].avg, "jaccard": meters["jaccard"].avg},
            step=epoch,
        )
    return meters["acc"].avg, meters["f1"].avg, meters["loss"].avg

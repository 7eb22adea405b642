"""Swin-Tiny brain-region classification on the Allen dataset: the port's
counterpart of ``Allen_data_Backbone/train.py``.

    python -m vit_ocm_wmsegmentation_tpu_torch.allen_train --data_path <imagefolder root>

The Swin (``models/swin.py``) trains with ``train/classifier.py``: AdamW at
5e-5, linear warmup over 10 %, gradient accumulation 4, 3 epochs, accuracy
each epoch, the best kept. Data: an imagefolder, <root>/<class>/*.png|jpg,
split 80/20 by a permutation seeded with ``--seed``; training images are
flipped left-right with probability 0.5. ``--model_name`` names the
pretrained weights: a local HF-layout file or directory
(``train/checkpoint.load_hf_swin``); anything else, or
``--from_scratch``, trains from a seeded init. Nothing is downloaded.
``--amp`` runs bf16 compute on f32 masters. The best weights go to
``<output_dir>/ckpt_epoch_0`` beside ``history.json``. The device is
``--device`` (default ``cuda``); a missing device raises, the CPU is taken
only when asked for.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

import numpy as np
import torch
from PIL import Image

from .models import swin
from .sw_processing import resolve_device
from .train import checkpoint as ckpt
from .train.classifier import train_classifier


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a model on Allen data (PyTorch/CUDA)")
    parser.add_argument("--data_path", type=str, required=True,
                        help="imagefolder root: <root>/<class>/*.png")
    parser.add_argument("--model_name", type=str, default="microsoft/swin-tiny-patch4-window7-224",
                        help="pretrained weights: a local HF-layout file or directory")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--from_scratch", action="store_true",
                        help="skip pretrained init (the reference's SwinModel(config) arm)")
    parser.add_argument("--amp", action="store_true",
                        help="bf16 compute / f32 master mixed precision (the MIM AMP rule)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", type=str, default="swin_allen_output",
                        help="best checkpoint + history destination")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on; raises if it is missing")
    return parser.parse_args(argv)


def load_imagefolder(root):
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    label2id = {c: i for i, c in enumerate(classes)}
    samples = [(p, label2id[c]) for c in classes for p in sorted(glob(os.path.join(root, c, "*")))]
    return samples, classes


def make_batches(samples, batch_size, image_size, *, train, seed):
    """epoch -> iterator of (x (B, S, S, 3) float32 in [0, 1], y (B,) int32):
    PIL RGB resized to S x S, a left-right flip with probability 0.5 for
    training, the order and flips from numpy's default_rng((seed, epoch,
    train))."""

    def gen(epoch):
        rng = np.random.default_rng((seed, epoch, int(train)))
        order = rng.permutation(len(samples)) if train else np.arange(len(samples))
        for s in range(0, len(order), batch_size):
            xs, ys = [], []
            for i in order[s : s + batch_size]:
                path, label = samples[i]
                img = Image.open(path).convert("RGB").resize((image_size, image_size))
                if train and rng.random() < 0.5:
                    img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
                xs.append(np.asarray(img, np.float32) / 255.0)
                ys.append(label)
            yield np.stack(xs), np.asarray(ys, np.int32)

    return gen


def main(argv=None):
    """Run the CLI; returns (model, history)."""
    args = get_args(argv)
    device = resolve_device(args.device)
    samples, classes = load_imagefolder(args.data_path)
    print(f"{len(samples)} images, {len(classes)} classes: {classes}")
    order = np.random.default_rng(args.seed).permutation(len(samples))
    n_val = int(len(samples) * 0.2)
    val = [samples[i] for i in order[:n_val]]
    train = [samples[i] for i in order[n_val:]]

    cfg = swin.SwinConfig(img_size=args.image_size, num_classes=len(classes))
    model = swin.init(cfg, torch.Generator().manual_seed(args.seed))
    if not args.from_scratch:
        try:
            ckpt.load_hf_swin(args.model_name, model)
            print(f"initialized from {args.model_name}")
        except Exception as e:
            print(f"pretrained init unavailable ({type(e).__name__}); training from scratch")
            model = swin.init(cfg, torch.Generator().manual_seed(args.seed))
    model.to(device)

    steps = max(len(train) // args.batch_size, 1)
    model, history = train_classifier(
        model,
        make_batches(train, args.batch_size, args.image_size, train=True, seed=args.seed),
        make_batches(val, args.batch_size, args.image_size, train=False, seed=args.seed),
        epochs=args.epochs, lr=5e-5, grad_accum=4, steps_per_epoch=steps, amp=args.amp)
    print("final:", history[-1])
    # the reference's trainer.save_model + save_metrics (train.py:165-173)
    path = ckpt.save_checkpoint(args.output_dir, 0, model)
    with open(os.path.join(args.output_dir, "history.json"), "w") as f:
        json.dump({"history": history, "classes": classes}, f, indent=2)
    print(f"saved best checkpoint to {path}")
    return model, history


if __name__ == "__main__":
    main()

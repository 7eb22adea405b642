"""Pseudo-ground-truth distillation, a frozen ViT teacher into a UNet
student: the port's PGT entry point.

    python -m vit_ocm_wmsegmentation_tpu_torch.pgt --image_path <dataset root>

The repository's root ``PGT.py`` with its flags: the teacher, ViT-S/8 at
depth 12 (``--pretrained_weights``, a local checkpoint, or random weights
from seed 0), labels each batch of ``<root>/images`` on the device
(``train.supervised.teacher_pseudo_labels``: CLS attention on the
inference kernels, head average, smoothing, the Otsu blend threshold;
``--rand`` averages a random subset of heads per image, drawn from a seeded
``torch.Generator``); the UNet trains on those masks with the Dice loss.
Splits 0:200 / 200: / 200: (PGT.py:161-165). The test pass scores the
student against ``<root>/labels`` when there are labels (INTER_LINEAR, as
PGT.py:339), else against the teacher's masks. The device is ``--device``
(default ``cuda``); a missing device raises, the CPU is taken only when
asked for.
"""

from __future__ import annotations

import argparse
from glob import glob

import torch

from .models import probing, unet
from .models import vit as vit_mod
from .sw_processing import resolve_device
from .train import checkpoint as ckpt
from .train.supervised import (SegLoader, split_reference, teacher_pseudo_labels,
                               test_supervised, train_supervised)
from .utils.seeding import seeding


def parse_args(argv=None):
    parser = argparse.ArgumentParser("Pseudo-ground-truth UNet distillation (PyTorch/CUDA)")
    parser.add_argument("--arch", default="vit_small", type=str)
    parser.add_argument("--patch_size", default=8, type=int)
    parser.add_argument("--pretrained_weights", default="", type=str)
    parser.add_argument("--checkpoint_key", default="teacher", type=str)
    parser.add_argument("--image_path", required=True, type=str,
                        help="folder with images/ (labels/ optional, used for test metrics)")
    parser.add_argument("--epochs", default=30, type=int)
    parser.add_argument("--batch_size", default=3, type=int)
    parser.add_argument("--base_lr", default=1e-4, type=float)
    parser.add_argument("--ratio", default=1.0, type=float)
    parser.add_argument("--H", default=384, type=int)
    parser.add_argument("--name", default="pgt", type=str)
    parser.add_argument("--rand", action="store_true",
                        help="average a random head subset per image (PGT.py rand mode)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on; raises if it is missing")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns (test metrics, test loss, train losses, valid
    losses)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    seeding(42)
    tcfg = probing.finetune_vit_config(args.H, args.patch_size)
    teacher = vit_mod.init(tcfg, torch.Generator().manual_seed(0))
    if args.pretrained_weights:
        ckpt.load_vit_state(teacher, ckpt.load_torch_checkpoint(
            args.pretrained_weights, tcfg, args.checkpoint_key))
        print(f"Teacher weights loaded from {args.pretrained_weights}")
    else:
        print("There is no reference weights available for this model => We use random weights.")
    teacher.requires_grad_(False).to(device)

    images = sorted(glob(args.image_path + "/images/*"))
    labels = sorted(glob(args.image_path + "/labels/*")) or None
    (tr_x, _), (va_x, _), (te_x, te_y) = split_reference(images, labels or images, "pgt",
                                                         args.ratio)
    print(f"Dataset Size:\nTrain: {len(tr_x)} - Valid: {len(va_x)}")
    model = unet.init(torch.Generator().manual_seed(1), device)
    generator = torch.Generator().manual_seed(7) if args.rand else None

    def pseudo_fn(x):
        return teacher_pseudo_labels(teacher, x, generator)

    train_loader = SegLoader(tr_x, None, args.H, args.batch_size, shuffle=True, device=device)
    valid_loader = SegLoader(va_x, None, args.H, args.batch_size, device=device)
    model, tl, vl = train_supervised(
        unet.apply, model, train_loader, valid_loader,
        epochs=args.epochs, lr=args.base_lr, checkpoint_path=f"files/{args.name}",
        pseudo_label_fn=pseudo_fn)
    te_labels = te_y if labels else [None] * len(te_x)
    avg, loss = test_supervised(unet.apply, model, te_x, te_labels, args.H, f"results/{args.name}",
                                pseudo_label_fn=pseudo_fn, mask_nearest=False)
    return avg, loss, tl, vl


if __name__ == "__main__":
    main()

"""The fully supervised UNet baseline: the port's unet entry point.

    python -m vit_ocm_wmsegmentation_tpu_torch.unet --image_path <dataset root>

The repository's root ``unet.py`` with its flags: the 4-level UNet at
``--H`` x ``--W`` (512^2), Dice loss, Adam 1e-4 and the plateau schedule,
150 epochs of batch 8 on the reference's 0:25 / 25:30 / 30: split of
``<root>/images`` and ``<root>/labels``; the best-validation model in
``files/<name>/ckpt_epoch_0``, the test metrics and triptychs in
``results/<name>/`` (GT masks resized with INTER_LINEAR, as unet.py:390
does). The device is ``--device`` (default ``cuda``); a missing device
raises, the CPU is taken only when asked for.
"""

from __future__ import annotations

import argparse
from glob import glob

import torch

from .models import unet
from .sw_processing import resolve_device
from .train.supervised import SegLoader, split_reference, test_supervised, train_supervised
from .utils.seeding import seeding


def parse_args(argv=None):
    parser = argparse.ArgumentParser("UNet supervised baseline (PyTorch/CUDA)")
    parser.add_argument("--image_path", required=True, type=str)
    parser.add_argument("--H", default=512, type=int)
    parser.add_argument("--W", default=512, type=int)
    parser.add_argument("--ratio", default=1.0, type=float)
    parser.add_argument("--epochs", default=150, type=int)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--base_lr", default=1e-4, type=float)
    parser.add_argument("--name", default="unet", type=str)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on; raises if it is missing")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns (test metrics, test loss, train losses, valid
    losses)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    seeding(42)
    images = sorted(glob(args.image_path + "/images/*"))
    labels = sorted(glob(args.image_path + "/labels/*"))
    (tr_x, tr_y), (va_x, va_y), (te_x, te_y) = split_reference(images, labels, "unet", args.ratio)
    print(f"Dataset Size:\nTrain: {len(tr_x)} / {len(tr_y)} - Valid: {len(va_x)} / {len(va_y)}")
    model = unet.init(torch.Generator().manual_seed(0), device)
    size = (args.H, args.W)
    train_loader = SegLoader(tr_x, tr_y, size, args.batch_size, shuffle=True, device=device)
    valid_loader = SegLoader(va_x, va_y, size, args.batch_size, device=device)
    model, tl, vl = train_supervised(
        unet.apply, model, train_loader, valid_loader,
        epochs=args.epochs, lr=args.base_lr, checkpoint_path=f"files/{args.name}")
    avg, loss = test_supervised(unet.apply, model, te_x, te_y, size, f"results/{args.name}",
                                mask_nearest=False)
    return avg, loss, tl, vl


if __name__ == "__main__":
    main()

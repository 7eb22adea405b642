"""Supervised finetuning of a LinearProbing head on a (pretrained) ViT: the
port's finetune entry point.

    python -m vit_ocm_wmsegmentation_tpu_torch.finetune --image_path <dataset root>

The repository's root ``finetune.py`` with its flags: ViT-S/8 at depth 12
and a 1- or 2-layer PixelShuffle decoder (``--layer_num``, default 2),
trained with the Dice loss on labeled images (``<root>/images``,
``<root>/labels``; the reference's splits 0:50 / 50:70 / 70:) by Adam and
the plateau schedule, the best-validation model saved to
``files/<name>/ckpt_epoch_0``, then the test pass: metrics and
image|GT|prediction triptychs in ``results/<name>/``. ``--finetune False``
freezes the encoder. The training steps run the ViT on the training
kernels, validation and test on the inference kernels. ``--pretrained_weights``
is a local checkpoint (its positional table interpolated at run time);
without it the weights are random from seed 0. The device is ``--device``
(default ``cuda``); a missing device raises, the CPU is taken only when
asked for.
"""

from __future__ import annotations

import argparse
from glob import glob

import torch

from .models import probing
from .sw_processing import resolve_device
from .train import checkpoint as ckpt
from .train.supervised import SegLoader, split_reference, test_supervised, train_supervised
from .utils.seeding import seeding


def str2bool(v) -> bool:
    """'False', '0', 'no', 'n', 'f' and '' parse false (the JAX package's
    ``cli.str2bool``)."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() not in ("", "false", "0", "no", "n", "f")


def parse_args(argv=None):
    parser = argparse.ArgumentParser("LinearProbing finetune (PyTorch/CUDA)")
    parser.add_argument("--arch", default="vit_small", type=str)
    parser.add_argument("--patch_size", default=8, type=int)
    parser.add_argument("--image_size", default=384, type=int)
    parser.add_argument("--pretrained_weights", default="", type=str)
    parser.add_argument("--checkpoint_key", default="teacher", type=str)
    parser.add_argument("--image_path", required=True, type=str,
                        help="dataset root with images/ and labels/")
    parser.add_argument("--epochs", default=30, type=int)
    parser.add_argument("--batch_size", default=3, type=int)
    parser.add_argument("--base_lr", default=1e-4, type=float)
    parser.add_argument("--ratio", default=1.0, type=float)
    parser.add_argument("--layer_num", default=2, type=int, choices=[1, 2])
    parser.add_argument("--finetune", default=True, type=str2bool,
                        help="False freezes the encoder (probing only)")
    parser.add_argument("--name", default="ft", type=str)
    parser.add_argument("--H", default=None, type=int,
                        help="working size; defaults to --image_size")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on; raises if it is missing")
    args = parser.parse_args(argv)
    if args.H is None:
        args.H = args.image_size
    return args


def main(argv=None):
    """Run the CLI; returns (test metrics [jaccard, f1, recall, precision,
    acc, roc], test loss, train losses, valid losses)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    seeding(42)
    cfg = probing.finetune_vit_config(args.H, args.patch_size)
    model = probing.init(cfg, torch.Generator().manual_seed(0), layer_num=args.layer_num)
    if args.pretrained_weights:
        try:
            ckpt.load_vit_state(model.encoder, ckpt.load_torch_checkpoint(
                args.pretrained_weights, cfg, args.checkpoint_key))
            print(f"Pretrained weights found at {args.pretrained_weights} and loaded")
        except Exception as e:
            print(f"could not load pretrained weights ({e}); using random encoder")
    model.encoder.requires_grad_(bool(args.finetune))
    model.to(device)

    images = sorted(glob(args.image_path + "/images/*"))
    labels = sorted(glob(args.image_path + "/labels/*"))
    (tr_x, tr_y), (va_x, va_y), (te_x, te_y) = split_reference(images, labels, "finetune",
                                                               args.ratio)
    print(f"Dataset Size:\nTrain: {len(tr_x)} / {len(tr_y)} - Valid: {len(va_x)} / {len(va_y)}")
    train_loader = SegLoader(tr_x, tr_y, args.H, args.batch_size, shuffle=True, device=device)
    valid_loader = SegLoader(va_x, va_y, args.H, args.batch_size, device=device)
    model, tl, vl = train_supervised(
        probing.apply, model, train_loader, valid_loader,
        epochs=args.epochs, lr=args.base_lr, checkpoint_path=f"files/{args.name}")
    avg, loss = test_supervised(probing.apply, model, te_x, te_y, args.H, f"results/{args.name}")
    return avg, loss, tl, vl


if __name__ == "__main__":
    main()

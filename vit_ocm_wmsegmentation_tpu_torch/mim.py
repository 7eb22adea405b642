"""Masked-image-modeling pretraining of the ViT on OCM patches, on one device.

    python -m vit_ocm_wmsegmentation_tpu_torch.mim --image_path <dir> [flags]

The port's counterpart of the repository's root ``mim.py``: the same flags
and config keys (``--opts KEY VALUE`` last), plus ``--device`` (default
``cuda``; a missing device raises, the CPU is used only with
``--device cpu``). ``--opts AMP_OPT_LEVEL O1`` trains in bf16 with f32
master weights. Checkpoints ``ckpt_epoch_<n>`` go to the templated
``cfg.OUTPUT``; with TRAIN.AUTO_RESUME (the default) a second call into the
same output resumes from the newest. Not ported yet, and refused:
``--wandb``, ``--eval_dataset_path``, ``--roi_masking``.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from .data.datasets import build_simmim_loader
from .sw_processing import resolve_device
from .train.mim_trainer import train_mim
from .utils.config import get_config
from .utils.logger import create_logger


def parse_option(argv=None):
    parser = argparse.ArgumentParser("MIM Pretraining")
    parser.add_argument("--opts", default=None, nargs="+",
                        help="Modify config options by adding 'KEY VALUE' pairs.")
    parser.add_argument("--arch", default="vit_small", type=str,
                        choices=["vit_tiny", "vit_small", "vit_base"])
    parser.add_argument("--patch_size", default=8, type=int)
    parser.add_argument("--pretrained_weights", default="", type=str)
    parser.add_argument("--checkpoint_key", default="teacher", type=str)
    parser.add_argument("--image_path", default="", type=str)
    parser.add_argument("--image_size", default=384, type=int)
    parser.add_argument("--output_dir", default="output/mim/", type=str)
    parser.add_argument("--output", default="output", type=str)
    parser.add_argument("--epochs", default=30, type=int)
    parser.add_argument("--warmup_epochs", default=20, type=int)
    parser.add_argument("--num_workers", default=1, type=int)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--mask_patch_size", default=16, type=int)
    parser.add_argument("--mask_ratio", default=0.5, type=float)
    parser.add_argument("--tag", default="AM", type=str)
    parser.add_argument("--wandb", default=False)
    parser.add_argument("--loss_operation", default="max", type=str)
    parser.add_argument("--eval_dataset_path", default="", type=str)
    parser.add_argument("--crop", type=int, default=1)
    parser.add_argument("--median_filter", type=int, default=1)
    parser.add_argument("--roi_masking", default=False, type=bool)
    parser.add_argument("--early_stopping", default=False, type=bool)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on; raises if it is missing")
    args = parser.parse_args(argv)
    return args, get_config(args)


def main(argv=None):
    """Train; returns (model, per-epoch mean losses)."""
    args, cfg = parse_option(argv)
    device = resolve_device(args.device)
    if cfg.WANDB:
        raise NotImplementedError("--wandb is not ported yet")
    if cfg.eval_dataset_path:
        raise NotImplementedError("--eval_dataset_path (per-epoch evaluation) is not ported yet")
    logger = create_logger(cfg.DATA.OUTPUT_DIR, name=f"{cfg.MODEL.NAME}_{cfg.MODEL.PATCH_SIZE}")
    # the reference's seeding (utils.py:21-27); the model's init draws from
    # its own generator seeded with cfg.SEED
    random.seed(cfg.SEED)
    os.environ["PYTHONHASHSEED"] = str(cfg.SEED)
    np.random.seed(cfg.SEED)
    torch.manual_seed(cfg.SEED)
    loader = build_simmim_loader(
        cfg.DATA.IMAGE_PATH, cfg.DATA.BATCH_SIZE, cfg.DATA.IMG_SIZE, cfg.DATA.MASK_PATCH_SIZE,
        cfg.MODEL.PATCH_SIZE, cfg.DATA.MASK_RATIO, roi_masking=bool(cfg.roi_masking),
        seed=cfg.SEED)
    logger.info(f"Creating model:{cfg.MODEL.NAME}/{cfg.MODEL.PATCH_SIZE}")
    return train_mim(cfg, loader, device=device, logger=logger)


if __name__ == "__main__":
    main()

"""Masked-image-modeling pretraining of the ViT on OCM patches.

    python -m vit_ocm_wmsegmentation_tpu_torch.mim --image_path <dir> [flags]
    torchrun --nproc_per_node N -m vit_ocm_wmsegmentation_tpu_torch.mim --image_path <dir> [flags]

The port's counterpart of the repository's root ``mim.py``: the same flags
and config keys (``--opts KEY VALUE`` last), plus ``--device`` (default
``cuda``; a missing device raises, the CPU is used only with
``--device cpu``). ``--opts AMP_OPT_LEVEL O1`` trains in bf16 with f32
master weights. Checkpoints ``ckpt_epoch_<n>`` go to the templated
``cfg.OUTPUT``; with TRAIN.AUTO_RESUME (the default) a second call into the
same output resumes from the newest. ``--wandb`` writes the scalars and the
per-epoch mask panels to files under ``--output_dir``
(``utils/wandb_shim.py``; no network), ``--eval_dataset_path`` scores the
encoder on a labeled set after every epoch (``evaluation.validate`` with
``--method``'s config key, ``--crop``, ``--median_filter``),
``--roi_masking`` masks only the image's foreground ROIs, and ``--opts
DATA.DEVICE_AUG True`` runs the augmentation on the device (the host loader
is kept, with a warning, under ``--roi_masking``). ``--trace_dir DIR`` writes
a ``torch.profiler`` Chrome trace of steps 2-5 to ``DIR/trace.json``.

Under torchrun the ranks form one process group (NCCL on the cards, gloo
with ``--device cpu``) and train together, as the root ``mim.py`` takes
every device: data parallel over all ranks, each rank drawing the same
global batch from the same seeded loader and keeping its rows;
``--opts TRAIN.FSDP True`` shards the parameters and Adam moments over them,
``TRAIN.PP_STAGES S`` pipelines the block stack over S stages
(``TRAIN.PP_MICROBATCHES``). Rank 0 logs to the console, writes the
checkpoints and the W&B files, and runs the eval; every rank writes its
``log_rank<N>.txt``.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from . import evaluation
from .data.datasets import build_eval_samples, build_simmim_device_loader, build_simmim_loader
from .parallel.mesh import init_distributed, make_mesh
from .sw_processing import resolve_device
from .train.mim_trainer import train_mim
from .utils.config import get_config
from .utils.logger import create_logger
from .utils.wandb_shim import get_wandb


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
    parser.add_argument("--trace_dir", default="", type=str,
                        help="write a torch.profiler Chrome trace of training steps 2-5, with "
                             "the step's and the loader's spans, to DIR/trace.json; rank 0 "
                             "traces")
    args = parser.parse_args(argv)
    return args, get_config(args)


def main(argv=None):
    """Train; returns (model, per-epoch mean losses)."""
    args, cfg = parse_option(argv)
    device = resolve_device(args.device)
    rank, world = init_distributed("nccl" if device.type == "cuda" else "gloo")
    logger = create_logger(cfg.DATA.OUTPUT_DIR, dist_rank=rank,
                           name=f"{cfg.MODEL.NAME}_{cfg.MODEL.PATCH_SIZE}")
    # the reference's seeding (utils.py:21-27); the model's init draws from
    # its own generator seeded with cfg.SEED
    random.seed(cfg.SEED)
    os.environ["PYTHONHASHSEED"] = str(cfg.SEED)
    np.random.seed(cfg.SEED)
    torch.manual_seed(cfg.SEED)
    # every rank knows whether W&B is on; rank 0 alone writes its files
    wandb, use_wandb = get_wandb(bool(cfg.WANDB) and rank == 0, output_dir=cfg.DATA.OUTPUT_DIR)
    if use_wandb:
        wandb.init(project="mim", name=f"{cfg.TAG}_{cfg.DATA.IMG_SIZE}_{cfg.DATA.BATCH_SIZE}B",
                   config=dict(cfg))

    device_aug = bool(cfg.DATA.DEVICE_AUG) and not cfg.roi_masking
    if cfg.DATA.DEVICE_AUG and not device_aug:
        logger.warning("DATA.DEVICE_AUG ignored: roi_masking needs host CC labeling, "
                       "falling back to the host augmentation loader")
    build = build_simmim_device_loader if device_aug else build_simmim_loader
    extra = {"device": device} if device_aug else {"roi_masking": bool(cfg.roi_masking)}
    loader = build(cfg.DATA.IMAGE_PATH, cfg.DATA.BATCH_SIZE, cfg.DATA.IMG_SIZE,
                   cfg.DATA.MASK_PATCH_SIZE, cfg.MODEL.PATCH_SIZE, cfg.DATA.MASK_RATIO,
                   seed=cfg.SEED, **extra)
    logger.info(f"Creating model:{cfg.MODEL.NAME}/{cfg.MODEL.PATCH_SIZE}")

    eval_fn = None
    if cfg.eval_dataset_path:
        samples = build_eval_samples(cfg.eval_dataset_path, cfg.DATA.IMG_SIZE, crop=int(cfg.crop))

        def eval_fn(encoder, epoch):
            evaluation.validate(encoder, samples, method=cfg.method, crop=int(cfg.crop),
                                median_size=int(cfg.median_filter), logger=logger,
                                wandb=wandb if use_wandb else None, epoch=epoch)

    out = train_mim(cfg, loader, eval_fn, device=device, logger=logger,
                    use_wandb=bool(cfg.WANDB), wandb=wandb if use_wandb else None,
                    mesh=make_mesh() if world > 1 else None, trace_dir=args.trace_dir)
    if use_wandb:
        wandb.finish()
    return out


if __name__ == "__main__":
    main()

"""Labeled evaluation of attention segmentation: the port's eval entry point.

    python -m vit_ocm_wmsegmentation_tpu_torch.eval \\
        --eval_dataset_path <dir with images/ and labels/> --method ours

Runs one of the eight methods of ``evaluation.METHODS`` on every labeled
image and logs Dice, accuracy, F1, precision, recall and Jaccard per image
and on average, as the repository's root ``eval.py`` does, with its flags.
``--crop 4`` or ``16`` takes the grid-crop variant, ``--median_filter``
the median filter of the attention, ``--batch_size`` batches the ViT for
the thresholding and k-means methods, ``--bf16 1`` runs the ViT in
bfloat16, ``--infer_mlp`` and ``--quant int8`` select its inference routes
(models.vit.InferRoutes), ``--wandb`` writes scalars and image panels to
files under ``--output_dir`` (utils/wandb_shim.py; no network). The device
is ``--device`` (default ``cuda``); a missing device raises, the CPU is
taken only when asked for. The weights come from ``--pretrained_weights``,
a local checkpoint, or else are random from seed 0; nothing is downloaded.
"""

from __future__ import annotations

import argparse

import torch

from . import evaluation
from .data.datasets import build_eval_samples
from .models import vit
from .sw_processing import load_model, resolve_device
from .utils.imageio import create_dir
from .utils.logger import create_logger
from .utils.seeding import seeding
from .utils.wandb_shim import get_wandb


def parse_args(argv=None):
    parser = argparse.ArgumentParser("Labeled evaluation of attention segmentation (PyTorch/CUDA)")
    parser.add_argument("--arch", default="vit_small", type=str, choices=sorted(vit.ARCHS))
    parser.add_argument("--patch_size", default=8, type=int)
    parser.add_argument("--pretrained_weights", default="", type=str)
    parser.add_argument("--checkpoint_key", default="teacher", type=str)
    parser.add_argument("--eval_dataset_path", default="", type=str)
    parser.add_argument("--image_size", default=384, type=int, nargs="+")
    parser.add_argument("--output_dir", default="results/eval/")
    parser.add_argument("--threshold", type=float, default=0.1)
    parser.add_argument("--crop", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--wandb", default=False)
    parser.add_argument("--tag", default="k-means")
    parser.add_argument("--method", default="ours", choices=list(evaluation.METHODS))
    parser.add_argument("--median_filter", default=1, type=int)
    # flags the reference's eval.py parses and never reads (eval.py:38-45),
    # kept so that its command lines run unchanged
    parser.add_argument("--region_query", type=bool, default=False, help=argparse.SUPPRESS)
    parser.add_argument("--query_analysis", type=bool, default=False, help=argparse.SUPPRESS)
    parser.add_argument("--query_rate", type=int, default=10, help=argparse.SUPPRESS)
    parser.add_argument("--save_query", type=bool, default=False, help=argparse.SUPPRESS)
    parser.add_argument("--save_feature", type=bool, default=False, help=argparse.SUPPRESS)
    parser.add_argument("--bf16", default=0, type=int,
                        help="run the ViT in bfloat16 (f32 softmax statistics and accumulation; "
                             "the attention maps leave it in f32); 0 = float32 like the reference")
    parser.add_argument("--infer_mlp", default="auto", choices=list(vit.INFER_MLP_CHOICES),
                        help="inference MLP route: auto = lnout (the cross-layer fused MLP "
                             "kernel); kernel = the fused MLP kernel per block; none = the stock "
                             "MLP (exact erf)")
    parser.add_argument("--quant", default="none", choices=list(vit.QUANT_CHOICES),
                        help="inference quantization: int8 runs the projection matmuls (and the "
                             "stock MLP's) as dynamic W8A8 products on the int8 GEMM kernel")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on; raises if it is missing")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns (acc, f1, loss), the averages validate() logs."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    create_dir(args.output_dir)
    logger = create_logger(args.output_dir, name=f"{args.arch}_{args.patch_size}")
    seeding(0)
    wandb, use_wandb = get_wandb(bool(args.wandb), output_dir=args.output_dir)
    if use_wandb:
        wandb.init(project="temp2", name=f"{args.method}_{args.crop}", config=vars(args))

    image_size = args.image_size[0] if isinstance(args.image_size, list) else args.image_size
    if not args.eval_dataset_path:
        raise SystemExit("Please use the `--eval_dataset_path` argument to indicate the dataset path.")
    samples = build_eval_samples(args.eval_dataset_path, image_size, crop=int(args.crop))
    print(f"images: {len(samples)}")

    model = load_model(args.arch, args.patch_size, args.pretrained_weights, args.checkpoint_key,
                       device=device, quant=args.quant)
    logger.info(f"Creating model:{args.arch}/{args.patch_size}")
    acc, f1, loss = evaluation.validate(
        model, samples, method=args.method, crop=args.crop,
        median_size=int(args.median_filter), logger=logger,
        wandb=wandb if use_wandb else None, batch_size=int(args.batch_size),
        dtype=torch.bfloat16 if int(args.bf16) else torch.float32,
        routes=vit.infer_routes(args.infer_mlp, args.quant, model.cfg),
    )
    if use_wandb:
        wandb.finish()
    return acc, f1, loss


if __name__ == "__main__":
    main()

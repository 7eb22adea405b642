"""Self-attention maps of a DINO ViT on OCM images: the port's analysis CLI.

    python -m vit_ocm_wmsegmentation_tpu_torch.analyse_attention \\
        --image_path <image or directory of .jpg> --output_dir <dir>

The repository's root ``analyse_attention.py`` with its flags and its
files: per image ``img.png``, ``attn-head{j}.png``, ``attn-average.png``,
the Otsu masks and blends of the reference's threshold()
(``utils/imageio.save_threshold_outputs``); ``--save_feature`` the last
block's key features under ``features/``; ``--region_query`` the Yen mask,
its ROIs and the attention of their centroids as queries; ``--query_analysis``
the attention of a grid of queries under ``analysis/``; ``--crop 4`` or
``16`` (or any ``--window_stride``) the grid-crop variant under
``croped_<crop>/``. ``--infer_mlp`` and ``--quant int8`` select the ViT's
inference routes (models.vit.InferRoutes), ``--bf16 1`` runs the ViT in
bfloat16, and ``--device`` (default ``cuda``) is where it runs; a missing
device raises, the CPU is taken only when asked for. The weights come from
``--pretrained_weights``, a local checkpoint, or else are random from seed
0; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np
import torch
from PIL import Image

from . import pipeline as pl
from .models import vit
from .ops import stitch as st
from .ops.filters import median_filter
from .ops.morphology import get_rois, region_centroids
from .ops.resize import resize_linear_cv2, smooth_attention, upsample_nearest
from .ops.threshold import yen_binary_u8
from .sw_processing import load_model, resolve_device
from .utils.imageio import create_dir, imsave, save_threshold_outputs


def parse_args(argv=None):
    parser = argparse.ArgumentParser("Visualize Self-Attention maps")
    parser.add_argument("--arch", default="vit_small", type=str, choices=sorted(vit.ARCHS))
    parser.add_argument("--patch_size", default=8, type=int)
    parser.add_argument("--pretrained_weights", default="", type=str)
    parser.add_argument("--checkpoint_key", default="teacher", type=str)
    parser.add_argument("--image_path", default=None, type=str)
    parser.add_argument("--image_size", default=(384, 384), type=int, nargs="+")
    parser.add_argument("--output_dir", default="results/attention/")
    parser.add_argument("--threshold", type=float, default=0.1)
    parser.add_argument("--crop", type=int, default=1, help="Amount of croping (4 or 16)")
    parser.add_argument("--window_stride", type=int, default=0)
    # the reference's type=bool flags: any non-empty string, "False" too, is true
    parser.add_argument("--region_query", type=bool, default=False)
    parser.add_argument("--query_analysis", type=bool, default=False)
    parser.add_argument("--query_rate", type=int, default=10)
    parser.add_argument("--save_query", type=bool, default=False)
    parser.add_argument("--save_feature", type=bool, default=False)
    parser.add_argument("--infer_mlp", default="auto", choices=list(vit.INFER_MLP_CHOICES),
                        help="inference MLP route: auto = lnout (the cross-layer fused MLP "
                             "kernel); kernel = the fused MLP kernel per block; none = the stock "
                             "MLP (exact erf)")
    parser.add_argument("--quant", default="none", choices=list(vit.QUANT_CHOICES),
                        help="inference quantization: int8 runs the projection matmuls (and the "
                             "stock MLP's) as dynamic W8A8 products on the int8 GEMM kernel")
    parser.add_argument("--bf16", default=0, type=int,
                        help="run the ViT in bfloat16; 0 = float32 like the reference")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on; raises if it is missing")
    return parser.parse_args(argv)


def _size(args):
    return tuple(args.image_size) if len(args.image_size) == 2 else (args.image_size[0],) * 2


def _load_inputs(path, size_hw):
    """(model input f32 (1, H, W, 3) from a BILINEAR resize, gray uint8 from
    a BICUBIC resize then L): the reference's two resizes (:102-106,
    :118-122)."""
    img = Image.open(path).convert("RGB")
    model_in = np.asarray(
        img.resize((size_hw[1], size_hw[0]), Image.Resampling.BILINEAR), np.float32) / 255.0
    gray = np.array(
        img.resize((size_hw[1], size_hw[0]), Image.Resampling.BICUBIC).convert("L"), np.uint8)
    return model_in[None], gray


def _model_input(model, x):
    p = next(model.parameters())
    return torch.from_numpy(x).to(p.device, p.dtype)


def _query_maps(model, x, queries, routes):
    """Head-averaged last-block attention of the query tokens over the
    patches, (Q, gh, gw) in f32."""
    cfg = model.cfg
    gh, gw = x.shape[1] // cfg.patch_size, x.shape[2] // cfg.patch_size
    with pl.exact_matmuls():
        rows = vit.query_attention_rows(model, x, queries, routes)
    return rows[0, :, :, 1:].float().mean(dim=0).reshape(len(queries), gh, gw)


@torch.inference_mode()
def analyse_single(args, model, img_path, routes=vit.InferRoutes()):
    """The reference's single-image analysis (analyse_attention.py:79-164)."""
    cfg = model.cfg
    p = cfg.patch_size
    size = _size(args)
    x_np, gray_np = _load_inputs(img_path, size)
    x = _model_input(model, x_np)
    image_name = os.path.basename(img_path).rsplit(".", 1)[0]
    outdir = os.path.join(args.output_dir, image_name)
    create_dir(outdir)
    device = x.device
    gray = torch.from_numpy(gray_np).to(device)

    heads = pl.attention_heads(model, x, routes)[0].float()  # (nh, H, W)
    avg = median_filter(heads.mean(dim=0), 1)

    # the input min-max normalized, as torchvision's save_image(normalize=True)
    disp = torch.from_numpy(x_np[0])
    disp = (disp - disp.min()) / max(float(disp.max() - disp.min()), 1e-12)
    imsave(os.path.join(outdir, "img.png"), disp)
    for j in range(heads.shape[0]):
        imsave(os.path.join(outdir, f"attn-head{j}.png"), heads[j])

    if args.save_feature:
        with pl.exact_matmuls():
            feats = vit.last_block_key_features(model, x, routes)  # (1, gh, gw, D)
        up = resize_linear_cv2(feats[0].float().permute(2, 0, 1), size)  # (D, H, W)
        fdir = os.path.join(outdir, "features")
        create_dir(fdir)
        for f in range(1, up.shape[0]):
            imsave(os.path.join(fdir, f"{f}.png"), up[f], cmap="gray")

    if args.threshold is None:
        return
    smoothed = smooth_attention(avg[::p, ::p], p, size)
    imsave(os.path.join(outdir, "attn-average.png"), smoothed)
    save_threshold_outputs(outdir, gray, smoothed)

    gh, gw = size[0] // p, size[1] // p
    if args.region_query:
        binary = yen_binary_u8(gray)
        imsave(os.path.join(outdir, "YEN_th.png"), binary, cmap="gray")
        labels = get_rois(binary)
        points = region_centroids(labels)
        print(f"Number of objects after morphology cleaning: {labels.max()}")
        if not points:
            print("No query points found.")
        else:
            # the reference's query index x//p * gw + y//p (analyse_attention.py:192)
            # transposes row and column and leaves out the +1 of the CLS
            # token; both quirks are kept, and the index is clamped at gh*gw
            queries = [int(px // p) * gw + int(py // p) for px, py in points]
            queries = [min(q, gh * gw) for q in queries]
            maps = upsample_nearest(_query_maps(model, x, queries, routes), p)
            if args.save_query:
                qdir = os.path.join(outdir, "queries")
                create_dir(qdir)
                for q in range(len(queries)):
                    imsave(os.path.join(qdir, f"attn-average-query-{q}.png"), maps[q])
            avg_q = maps.mean(dim=0)
            imsave(os.path.join(outdir, "attn-average-queried.png"), avg_q)
            med = median_filter(avg_q, 1)
            imsave(os.path.join(outdir, "attn-average-queried-median.png"), med)
            smooth_q = smooth_attention(med[::p, ::p], p, size)
            save_threshold_outputs(outdir, gray, smooth_q, name="attn-average-queried-threshold")

    if args.query_analysis:
        adir = os.path.join(outdir, "analysis")
        create_dir(adir)
        # analyse_attention.py:232-234 as it is, with its square-only stride:
        # its `w_featmap` is the grid's row count despite the name, so the
        # query is i*gh*rate + j*rate, and a non-square grid is strided as
        # the reference strides it
        queries = [i * gh * args.query_rate + j * args.query_rate
                   for i in range(gh // args.query_rate) for j in range(gw // args.query_rate)]
        if not queries:
            # query_rate beyond the grid: the reference's loops run no time
            # and it writes nothing
            return
        rows = _query_maps(model, x, queries, routes)
        for q, qidx in enumerate(queries):
            imsave(os.path.join(adir, f"attn-average-{qidx}.png"), rows[q])


@torch.inference_mode()
def analyse_croped(args, model, img_path, routes=vit.InferRoutes()):
    """The reference's grid-crop analysis (analyse_attention.py:167-198):
    the image resized, cut into a sqrt(crop) x sqrt(crop) grid, each crop's
    CLS attention, the maps put back together, smoothed and thresholded."""
    cfg = model.cfg
    p = cfg.patch_size
    size = _size(args)
    g = int(np.sqrt(args.crop))
    crop_hw = (size[0] // g, size[1] // g)
    img = Image.open(img_path).convert("RGB").resize((size[1], size[0]))
    image_name = os.path.basename(img_path).rsplit(".", 1)[0]
    outdir = os.path.join(args.output_dir, image_name, f"croped_{args.crop}")
    create_dir(outdir)

    crops = []
    for i in range(g):
        for j in range(g):
            box = (j * crop_hw[1], i * crop_hw[0], (j + 1) * crop_hw[1], (i + 1) * crop_hw[0])
            c = img.crop(box).resize((crop_hw[1], crop_hw[0]), Image.Resampling.BILINEAR)
            crops.append(np.asarray(c, np.float32) / 255.0)
    batch = _model_input(model, np.stack(crops))  # (T, h, w, 3)
    with pl.exact_matmuls():
        grids = vit.cls_attention_grid(model, batch, routes)  # (T, nh, gh, gw)
    maps = upsample_nearest(grids.float().mean(dim=1), p)
    recon = st.concat_crops(maps)

    gray_np = np.array(Image.open(img_path).convert("RGB").resize(
        (size[1], size[0]), Image.Resampling.BICUBIC).convert("L"), np.uint8)
    Image.fromarray(gray_np).save(os.path.join(outdir, "img.png"))
    print("img.png saved.")
    if args.threshold is not None:
        smoothed = smooth_attention(recon[::p, ::p], p, size)
        imsave(os.path.join(outdir, "attn-average.png"), smoothed)
        save_threshold_outputs(outdir, torch.from_numpy(gray_np).to(recon.device), smoothed)


def list_inputs(image_path: str) -> list[str]:
    """The root CLI's inputs: the file itself, or a directory's .jpg files."""
    if os.path.isfile(image_path):
        return sorted(glob(image_path))
    return sorted(glob(image_path + "/*.jpg"))


def main(argv=None):
    """Run the CLI; returns the list of processed image paths."""
    args = parse_args(argv)
    if len(args.image_size) == 1:
        args.image_size = [args.image_size[0]] * 2
    device = resolve_device(args.device)
    model = load_model(args.arch, args.patch_size, args.pretrained_weights, args.checkpoint_key,
                       device=device, dtype=torch.bfloat16 if args.bf16 else None,
                       quant=args.quant)
    routes = vit.infer_routes(args.infer_mlp, args.quant, model.cfg)

    if args.image_path is None:
        raise SystemExit("Please use the `--image_path` argument to indicate the path of the image.")
    paths = list_inputs(args.image_path)
    if not paths:
        raise SystemExit(f"no images found at {args.image_path}")

    start = time.time()
    for path in paths:
        if args.crop > 1 or args.window_stride > 0:
            # the reference's window_stride is vestigial: its Croped_Dataset
            # ignores it (the sliding-window call is commented out,
            # analyse_attention.py:262) and takes the grid path with crop
            # rate sqrt(crop), crop 1 included, as one crop. The sliding
            # window is the serving CLI's (sw_processing.py)
            if args.crop not in (1, 4, 16):
                print("crop must be 1, 4 or 16")
            else:
                analyse_croped(args, model, path, routes)
        else:
            analyse_single(args, model, path, routes)
    dt = time.time() - start
    print(f"Execution time: {int(dt // 60)}m {int(dt % 60)}s")
    return paths


if __name__ == "__main__":
    main()

"""Sliding-window mosaic segmentation: the port's serving entry point.

    python -m vit_ocm_wmsegmentation_tpu_torch.sw_processing \\
        --image_path <image or directory> --output_dir out/ --bf16 1

``--image_path`` may be one image or a directory. One image is decoded,
segmented and written with its three artifacts: ``attention_map_sw.jpg``
(the attention map in viridis), ``otsu_sw_heatmap.jpg`` (the Otsu mask of
the attention heatmap) and ``otsu_sw.jpg`` (the mask), all PNG bytes. A
directory is served as a three-stage pipeline: a prefetch thread decodes
mosaic i+2 and uploads it on a side stream, the main thread issues the
compute of mosaic i+1, and writer threads (``--writers``) encode mosaic i
into ``<output_dir>/<name>/`` (``--save mask`` writes the mask only).
Mosaics above ``pipeline.STREAM_AUTO_MP`` megapixels take the band-streamed
path (``--streamed``). ``--infer_mlp`` and ``--quant int8`` select the
ViT's inference routes (models.vit.InferRoutes). The flags follow the repository's root
``sw_processing.py`` where they apply. The device is ``--device`` (default
``cuda``); a missing device raises, the CPU is taken only when asked for.
``--trace_dir DIR`` writes a ``torch.profiler`` Chrome trace of the second
mosaic, with the pipeline's spans, to ``DIR/trace.json``.

Under ``torchrun --nproc_per_node N -m vit_ocm_wmsegmentation_tpu_torch.sw_processing``
the ranks form one process group (NCCL on the cards, gloo with ``--device
cpu``) and, with ``--mesh 1`` (the default, as the root flag), each mosaic's
tiles (each band's row of tiles when streamed) shard over them: every rank
decodes the same mosaic, runs the ViT on its share and gathers the maps, and
rank 0 alone writes the files, which equal the one-process CLI's.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np
import torch
from PIL import Image

from . import pipeline as pl
from .data.prefetch import prefetch
from .models import vit
from .ops import threshold as th
from .parallel.mesh import describe, init_distributed, is_distributed, make_mesh
from .train.checkpoint import load_torch_checkpoint
from .utils import profiling
from .utils.imageio import attention_lut_index, create_dir, imsave_fast

_IMAGE_EXT = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")
# (file name, colormap) of the attention map, the heatmap Otsu mask, the mask
ARTIFACTS = (("attention_map_sw.jpg", None), ("otsu_sw_heatmap.jpg", "gray"),
             ("otsu_sw.jpg", "gray"))


def parse_args(argv=None):
    parser = argparse.ArgumentParser("Sliding-window mosaic segmentation (PyTorch/CUDA)")
    parser.add_argument("--arch", default="vit_small", type=str, choices=sorted(vit.ARCHS))
    parser.add_argument("--patch_size", default=8, type=int)
    parser.add_argument("--pretrained_weights", default="", type=str)
    parser.add_argument("--checkpoint_key", default="teacher", type=str)
    parser.add_argument("--image_path", required=True, type=str)
    parser.add_argument("--image_size", default=(1152, 1152), type=int, nargs="+")
    parser.add_argument("--window_size", default=384, type=int)
    parser.add_argument("--stride", default=128, type=int)
    parser.add_argument("--output_dir", default="temp/")
    parser.add_argument("--bf16", default=0, type=int,
                        help="run the ViT in bfloat16 (f32 softmax statistics and "
                             "accumulation); 0 = float32 like the reference")
    parser.add_argument("--writers", default=0, type=int,
                        help="directory mode: PNG writer threads (0 = min(4, cpu_count-1))")
    parser.add_argument("--save", default="all", choices=["all", "mask"],
                        help="directory mode: artifacts per mosaic; 'mask' writes only "
                             "otsu_sw.jpg")
    parser.add_argument("--infer_mlp", default="auto", choices=list(vit.INFER_MLP_CHOICES),
                        help="inference MLP route: auto = lnout (the cross-layer fused MLP "
                             "kernel, the JAX package's shipped route); kernel = the fused MLP "
                             "kernel per block; none = the stock MLP (exact erf)")
    parser.add_argument("--quant", default="none", choices=list(vit.QUANT_CHOICES),
                        help="inference quantization: int8 runs the projection matmuls (and the "
                             "stock MLP's) as dynamic W8A8 products on the int8 GEMM kernel "
                             "(ops/quant.py); the weights are quantized once")
    parser.add_argument("--streamed", default="auto", choices=["auto", "0", "1"],
                        help="take the band-streamed path (segment_mosaic_streamed: one "
                             "f32 canvas on the device, one tile row at a time); auto = "
                             f"streamed above {pl.STREAM_AUTO_MP} MP")
    parser.add_argument("--band_chunk", default=None, type=int,
                        help="streamed mode: tile rows between two progress lines "
                             "(default pipeline.DEFAULT_BAND_CHUNK); the outputs do not "
                             "depend on it")
    parser.add_argument("--exact_stitch", default=0, type=int,
                        help="threshold the reference's re-stitched uint8 mosaic "
                             "bit-exactly instead of the original image")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on; raises if it is missing")
    parser.add_argument("--mesh", default=1, type=int,
                        help="under torchrun, shard each mosaic's tiles (fused) or each band's "
                             "tile row (streamed) over the group's ranks, masks equal to one "
                             "process's; 0 = every rank serves alone. Rank 0 writes the files")
    parser.add_argument("--trace_dir", default="", type=str,
                        help="write a torch.profiler Chrome trace of the second mosaic (of the "
                             "only one, if there is one) to DIR/trace.json, with the pipeline's "
                             "spans; rank 0 traces")
    return parser.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return dev


def load_model(arch: str, patch_size: int, pretrained_weights: str = "",
               checkpoint_key: str = "teacher", seed: int = 0, device=None, dtype=None,
               quant: str = "none"):
    """The ViT for ``arch``: a local checkpoint when given, else random
    weights from ``seed`` (no download is attempted), on ``device``, cast to
    ``dtype`` when given; with ``quant="int8"`` its int8 route's weights are
    quantized here, once (models.vit.int8_weights)."""
    if arch not in vit.ARCHS:
        raise SystemExit(f"unknown arch {arch!r}; choices: {sorted(vit.ARCHS)}")
    cfg = vit.ARCHS[arch](patch_size=patch_size)
    model = vit.init(cfg, torch.Generator().manual_seed(seed))
    if pretrained_weights and os.path.isfile(pretrained_weights):
        sd = load_torch_checkpoint(pretrained_weights, cfg, checkpoint_key)
        model.load_state_dict(sd, strict=False)
        print(f"Pretrained weights loaded from {pretrained_weights}")
    else:
        print("There is no reference weights available for this model => We use random weights.")
    if device is not None:
        model = model.to(device)
    if dtype is not None:
        model = pl.cast_params(model, dtype)
    if quant == "int8":
        vit.int8_weights(model)
    return model


def decode(path: str, size) -> np.ndarray:
    """The root CLI's decode: RGB, resize to (W, H), grayscale uint8."""
    img = Image.open(path).convert("RGB").resize((size[1], size[0]))
    return np.array(img.convert("L"), np.uint8)


def write(out_dir: str, arrays):
    """The artifacts of one mosaic, uint8 host arrays (mask,) or (mask,
    viridis indices, heatmap Otsu mask), as PNG bytes."""
    create_dir(out_dir)
    mask, *extras = arrays
    for (fname, cmap), arr in [*zip(ARTIFACTS[:2], extras), (ARTIFACTS[2], mask)]:
        imsave_fast(os.path.join(out_dir, fname), arr, cmap=cmap)


def streamed_route(flag: str, size) -> bool:
    """--streamed: 1 always, 0 never, auto above STREAM_AUTO_MP megapixels."""
    return flag == "1" or (flag == "auto" and size[0] * size[1] > pl.STREAM_AUTO_MP * 1e6)


def main(argv=None):
    """Run the CLI; returns {name: mask (H, W) uint8} for the processed
    mosaics (``""`` in single-image mode)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rank, _ = init_distributed("nccl" if device.type == "cuda" else "gloo")
    mesh = make_mesh() if args.mesh and is_distributed() else None
    main_rank = rank == 0
    if mesh is not None and main_rank:
        print(f"sharding tiles: {describe(mesh, device)}")
    size = tuple(args.image_size) if len(args.image_size) == 2 else (args.image_size[0],) * 2
    pl.validate_window_geometry(args.window_size, args.stride)
    if args.writers < 0:
        raise SystemExit(f"--writers must be >= 0, got {args.writers}")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    routes = vit.infer_routes(args.infer_mlp, args.quant)
    model = load_model(args.arch, args.patch_size, args.pretrained_weights,
                       args.checkpoint_key, device=device, dtype=dtype, quant=args.quant)
    streamed = streamed_route(args.streamed, size)
    cuda = device.type == "cuda"

    def progress(done, total):
        if main_rank:
            print(f"  band {done}/{total} issued", flush=True)

    @torch.inference_mode()
    def segment(gray_dev, mask_only):
        """Issue one mosaic's compute; returns its artifacts on the device."""
        if streamed:
            mask, attn = pl.segment_mosaic_streamed(
                model, gray_dev, args.window_size, args.stride, dtype=dtype,
                exact_stitch=bool(args.exact_stitch), band_chunk=args.band_chunk, routes=routes,
                mesh=mesh, progress=progress)
        else:
            mask, attn = pl.segment_mosaic(model, gray_dev, args.window_size, args.stride,
                                           dtype=dtype, exact_stitch=bool(args.exact_stitch),
                                           routes=routes, mesh=mesh)
        if mask_only:
            return (mask,)
        # the attention leaves the device as uint8 viridis indices
        return mask, attention_lut_index(attn), th.heatmap_otsu(attn)

    def to_host(outs):
        """Start the copies of ``outs`` into pinned host buffers behind the
        compute; returns (buffers, event the copies complete at)."""
        if not cuda:
            return [o.numpy() for o in outs], None
        hosts = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
        for h, o in zip(hosts, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return hosts, done

    def issue(i, gray_dev, mask_only):
        """Issue mosaic ``i``'s compute and its copies to the host; the
        traced mosaic of --trace_dir inside utils.profiling.trace."""
        if args.trace_dir and main_rank and i == traced:
            with profiling.trace(args.trace_dir):
                return to_host(segment(gray_dev, mask_only))
        return to_host(segment(gray_dev, mask_only))

    def write_back(out_dir, hosts, done):
        """Writer thread: wait for the copies, encode, return the mask."""
        if done is not None:
            done.synchronize()
        arrays = [np.asarray(h) for h in hosts]
        if main_rank:
            write(out_dir, arrays)
        return arrays[0].copy()  # the pinned buffers go back to the allocator

    route = "band-streamed" if streamed else "fused"
    traced = 0
    if not os.path.isdir(args.image_path):
        gray = torch.from_numpy(decode(args.image_path, size)).to(device)
        mask = write_back(args.output_dir, *issue(0, gray, mask_only=False))
        if main_rank:
            print(f"mosaic segmented on {device} ({route}); output in {args.output_dir}")
        return {"": mask}

    paths = sorted(p for p in glob(os.path.join(args.image_path, "*"))
                   if p.lower().endswith(_IMAGE_EXT))
    if not paths:
        raise SystemExit(f"no images found in {args.image_path}")
    traced = min(1, len(paths) - 1)
    mask_only = args.save == "mask"
    upload = torch.cuda.Stream(device) if cuda else None

    def produce():
        for p in paths:
            yield os.path.splitext(os.path.basename(p))[0], decode(p, size)

    def place(item):
        """Prefetch thread: upload on the side stream; the consumer waits on
        the returned event before it uses the mosaic."""
        name, gray = item
        if not cuda:
            return name, torch.from_numpy(gray).to(device), None
        with torch.cuda.stream(upload):
            dev = torch.from_numpy(gray).pin_memory().to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(upload)
        return name, dev, ready

    n_writers = args.writers or max(1, min(4, (os.cpu_count() or 2) - 1))
    futures, inflight, pending = {}, deque(), deque()
    t0, t_first = time.perf_counter(), None
    items = prefetch(produce(), depth=2, place=place)
    with ThreadPoolExecutor(max_workers=n_writers) as writers:
        def submit(name, hosts, done):
            futures[name] = writers.submit(write_back, os.path.join(args.output_dir, name),
                                           hosts, done)
            pending.append(futures[name])
            while len(pending) > 2 * n_writers:  # bound the writer backlog
                pending.popleft().result()

        try:
            for i, (name, gray, ready) in enumerate(items):
                if ready is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(ready)
                    gray.record_stream(stream)  # not reused before the compute is done
                inflight.append((name, *issue(i, gray, mask_only)))
                if len(inflight) > 1:
                    submit(*inflight.popleft())
                    if t_first is None:
                        t_first = time.perf_counter()
        finally:
            items.close()
        while inflight:
            submit(*inflight.popleft())
        masks = {name: f.result() for name, f in futures.items()}
    dt = time.perf_counter() - t0
    mp_one = size[0] * size[1] / 1e6
    steady = ""
    if t_first is not None and len(paths) > 1:
        rate = (len(paths) - 1) * mp_one / (time.perf_counter() - t_first)
        steady = f" ({rate:.2f} MP/s in steady state after the first mosaic)"
    if main_rank:
        print(f"segmented {len(paths)} mosaics ({len(paths) * mp_one:.2f} MP) on {device} "
              f"({route}) in {dt:.2f} s = {len(paths) * mp_one / dt:.2f} MP/s, host clock, "
              f"first mosaic's set-up included{steady}; output in {args.output_dir}")
    return masks


if __name__ == "__main__":
    main()

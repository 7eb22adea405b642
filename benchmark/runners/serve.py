"""The serving runner: a closed loop of uint8 mosaics through the port's
mosaic segmentation, as the port's ``sw_processing`` serves a folder.

A pool of distinct OCM-like mosaics is made from the seed and kept in
pinned host memory. A prefetch thread (the port's ``data.prefetch``, depth
from the traffic) uploads each next mosaic on a side stream; the loop takes
it from the queue, issues the segmentation (``pipeline.segment_mosaic`` or
``pipeline.segment_mosaic_streamed``, the traffic's ``route``), copies the
mask into pinned host memory behind the compute, and then waits for the
mosaic before it: a closed loop that keeps one mosaic queued on the device
behind the one that runs. (The CLI hands the wait to writer threads with a
deeper backlog; on the card that reads the same rate and latency, with
twice the spread, since the host issuing a mosaic, not the wait, keeps the
queue short.) A mosaic's latency runs from when the loop takes it, already
uploaded, to when its mask is in host memory. The window closes at the
first completion after ``seconds``; the rate is the megapixels of every mask
that reached the host over the whole window.

Correctness: a sample of the window's mosaics, drawn from the seed, keeps
its attention canvas beside its mask. After the window the plain reference
(``reference/vit.py``) judges them: the canvas against the reference's
(whole, or strips of tile rows drawn from the seed), as one relative gap
(``canvas_rel``) and as the worst relative gap over a tile's footprint
(``tile_rel``: a tile whose map is wrong barely moves the whole canvas's
gap); the mask against the reference's mask of its own canvas, and the mask
against the reference's threshold of the program's canvas.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

import numpy as np
import torch

from .. import inputs
from ..reference import vit as ref
from ..tracing import Capture, Phases, Spans
from ..weights import DTYPES, make_state

MP = 1e6


def program_segment(cell, state, device):
    """segment(img (H, W) uint8 on the device) -> (mask, attention) of the
    port, and the port's ViT module (for the traced run's ``vit`` span)."""
    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.models import vit

    c, t = cell.config, cell.traffic
    vcfg = vit.ViTConfig(patch_size=c["patch_size"], embed_dim=c["embed_dim"], depth=c["depth"],
                         num_heads=c["num_heads"], mlp_ratio=c["mlp_ratio"],
                         qkv_bias=c["qkv_bias"], ln_eps=c["ln_eps"],
                         pretrain_img_size=c["img_size"])
    with torch.device("meta"):
        model = vit.ViT(vcfg)
    model.load_state_dict(state, assign=True)
    model.requires_grad_(False)
    dtype = DTYPES[cell.precision]
    model = pl.cast_params(model, dtype)
    routes = vit.infer_routes(c["infer_mlp"], c["quant"])
    fn = {"fused": pl.segment_mosaic, "streamed": pl.segment_mosaic_streamed}[t["route"]]

    def segment(img):
        return fn(model, img, t["window"], t["stride"], dtype=dtype, routes=routes)

    return segment, vit


def reference_segment(cell, state, device, precision="fp8"):
    """The plain reference in the program's place, in ``precision`` (the
    control): the same signature as :func:`program_segment`."""
    t = cell.traffic

    def segment(img):
        attn = ref.attention_canvas(state, cell.config, img, t["window"], t["stride"], precision)
        return ref.threshold_multiplicative(img, attn), attn

    return segment, None


@contextlib.contextmanager
def vit_span(vit_module, spans):
    """In a traced run, the port's ViT call inside a ``vit`` span, so that the
    trace tells the ViT's kernels from the pipeline's around it."""
    if vit_module is None or not spans.on:
        yield
        return
    if not hasattr(vit_module, "cls_attention_grid"):
        # post_dev_ms_per_mp reads this span: it must not go silent unseen
        raise RuntimeError("the port's models.vit has no cls_attention_grid to hold a vit span")
    inner = vit_module.cls_attention_grid

    def wrapped(*a, **k):
        with spans("vit"):
            return inner(*a, **k)

    vit_module.cls_attention_grid = wrapped
    try:
        yield
    finally:
        vit_module.cls_attention_grid = inner


class Loop:
    """The closed serving loop over a pool of host mosaics (module docstring)."""

    def __init__(self, segment, pool, device, depth, spans, keep=()):
        from vit_ocm_wmsegmentation_tpu_torch.data.prefetch import prefetch

        self.segment, self.pool, self.device, self.spans = segment, pool, device, spans
        self.cuda = device.type == "cuda"
        self.keep = set(keep)
        self.kept = {}  # iteration -> (pool index, mask (H, W) uint8 numpy, attention host)
        self.records = []  # (iteration, t_take, t_done)
        self.inflight = collections.deque()
        size = pool.shape[1:]
        self.ring = [torch.empty(size, dtype=torch.uint8, pin_memory=self.cuda)
                     for _ in range(3)]
        self.attn_bufs = {i: torch.empty(size, dtype=torch.float32, pin_memory=self.cuda)
                          for i in self.keep}
        self.upload = torch.cuda.Stream(device) if self.cuda else None
        self.items = prefetch(((i, i % len(pool)) for i in itertools.count()), depth, self.place)
        self.n = 0

    def place(self, item):
        i, k = item
        if not self.cuda:
            return i, k, self.pool[k], None
        with self.spans("upload"), torch.cuda.stream(self.upload):
            dev = self.pool[k].to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.upload)
        return i, k, dev, ready

    def take_one(self):
        i, k, img, ready = next(self.items)
        t_take = time.perf_counter()
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            img.record_stream(stream)
        with self.spans("segment"):
            mask, attn = self.segment(img)
        with self.spans("to_host"):
            host = self.ring[self.n % len(self.ring)]
            host.copy_(mask, non_blocking=self.cuda)
            attn_host = None
            if i in self.keep:
                attn_host = self.attn_bufs[i]
                attn_host.copy_(attn, non_blocking=self.cuda)
            done = None
            if self.cuda:
                done = torch.cuda.Event()
                done.record()
        self.n += 1
        self.inflight.append((i, k, t_take, host, attn_host, done))

    def finish_one(self):
        i, k, t_take, host, attn_host, done = self.inflight.popleft()
        with self.spans("wait"):
            if done is not None:
                done.synchronize()
        t_done = time.perf_counter()
        self.records.append((i, t_take, t_done))
        if attn_host is not None:
            self.kept[i] = (k, host.numpy().copy(), attn_host)
        return t_done

    def run(self, count=None, until=None):
        """Take ``count`` mosaics, or mosaics until the host clock passes
        ``until``; then wait for every one in flight. Returns the time the
        last mask reached the host."""
        taken = 0
        t_last = time.perf_counter()
        while (count is None or taken < count) and (until is None or time.perf_counter() < until):
            self.take_one()
            taken += 1
            if len(self.inflight) > 1:
                t_last = self.finish_one()
        while self.inflight:
            t_last = self.finish_one()
        return t_last

    def close(self):
        self.items.close()
        self.items._thread.join(timeout=30)


def _share_differing(a, b) -> float:
    return float((a != b).sum()) / a.numel()


def tile_rel(prog, refc, y_lo, window, stride, shape) -> float:
    """The worst relative gap ||prog - ref|| / ||ref|| over the footprints
    (window x window) of the tiles of a mosaic of ``shape`` (H, W), each cut
    to the compared rows [y_lo, y_lo + rows) that ``prog`` and ``refc``
    (rows, W) hold; tiles whose footprint misses them are left out."""
    def box_sums(m):  # inclusive 2-D prefix sums, a zero row and column first
        c = m.double().cumsum(0).cumsum(1)
        return torch.nn.functional.pad(c, (1, 0, 1, 0))

    d, r = box_sums((prog - refc).square()), box_sums(refc.square())
    rows = prog.shape[0]
    dev = prog.device
    ys = torch.tensor(ref.tile_starts(shape[0], window, stride), device=dev) - y_lo
    xs = torch.tensor(ref.tile_starts(shape[1], window, stride), device=dev)
    y0, y1 = ys.clamp(0, rows), (ys + window).clamp(0, rows)
    keep = y1 > y0
    y0, y1 = y0[keep], y1[keep]
    x0, x1 = xs, xs + window

    def sums(c):
        return (c[y1][:, x1] - c[y0][:, x1] - c[y1][:, x0] + c[y0][:, x0]).clamp_min(0)

    return float((sums(d) / sums(r)).sqrt().max())


@torch.no_grad()
def judge(cell, seed, kept, pool, device) -> dict:
    """The compared numbers (worst over the sample) of the kept mosaics."""
    t, lim = cell.traffic, cell.limits
    state = make_state(cell.config, seed, device)
    rng = np.random.default_rng((seed, 2))
    out = {"canvas_rel": 0.0, "tile_rel": 0.0, "mask_own_px": 0.0}
    if t["route"] == "fused":
        out["mask_ref_px"] = 0.0
    for _, (k, mask_p, attn_p) in sorted(kept.items()):
        img = pool[k].to(device)
        attn_p = attn_p.to(device)
        mask_p = torch.from_numpy(mask_p).to(device)
        own = ref.threshold_multiplicative(img, attn_p)
        out["mask_own_px"] = max(out["mask_own_px"], _share_differing(own, mask_p))
        if t["route"] == "fused":
            canvas = ref.attention_canvas(state, cell.config, img, t["window"], t["stride"])
            rel = float(torch.linalg.vector_norm(attn_p - canvas)
                        / torch.linalg.vector_norm(canvas))
            tiles = tile_rel(attn_p, canvas, 0, t["window"], t["stride"], img.shape)
            mask_r = ref.threshold_multiplicative(img, canvas)
            out["mask_ref_px"] = max(out["mask_ref_px"], _share_differing(mask_r, mask_p))
        else:
            n_rows = len(ref.tile_starts(img.shape[0], t["window"], t["stride"]))
            num = den = tiles = 0.0
            for _ in range(lim["strips"]):
                first = int(rng.integers(0, n_rows - lim["strip_rows"] + 1))
                (y0, y1), c = ref.canvas_rows(state, cell.config, img, t["window"], t["stride"],
                                              first, first + lim["strip_rows"] - 1)
                num += float(torch.linalg.vector_norm(attn_p[y0:y1] - c)) ** 2
                den += float(torch.linalg.vector_norm(c)) ** 2
                tiles = max(tiles, tile_rel(attn_p[y0:y1], c, y0, t["window"], t["stride"],
                                            img.shape))
            rel = (num / den) ** 0.5
        out["canvas_rel"] = max(out["canvas_rel"], rel)
        out["tile_rel"] = max(out["tile_rel"], tiles)
    return out


def run(cell, seed, seconds, trace, device, tmpdir, segment_factory=None, judge_within=None):
    """One run of a serving cell. ``segment_factory(cell, state, device)``
    replaces the program (controls and fault tests); ``judge_within``
    overrides the cell's span of window mosaics the sample is drawn from.
    Returns the run's record (see run.py)."""
    t, lim = cell.traffic, cell.limits
    spans, phases = Spans(bool(trace)), Phases()
    from vit_ocm_wmsegmentation_tpu_torch import pipeline  # noqa: F401

    phases.mark("port_imports")
    state = make_state(cell.config, seed, device)
    segment, vit_module = (segment_factory or program_segment)(cell, state, device)
    del state
    phases.mark("weights_and_model")
    pool_dev = inputs.mosaic_pool(t["size"], t["blob"], t["pool"], seed, device)
    pool = pool_dev.cpu().pin_memory() if device.type == "cuda" else pool_dev
    del pool_dev
    phases.mark("mosaics")
    # a traced run judges mosaics of its traced part: stopping the profiler
    # can take the rest of the window
    within = judge_within or lim["judge_within"]
    if trace:
        within = min(within, t["trace_mosaics"])
    w0 = t["warmup"]
    rng = np.random.default_rng((seed, 1))
    keep = sorted(w0 + int(j) for j in rng.choice(within, size=min(lim["sample"], within),
                                                   replace=False))
    loop = Loop(segment, pool, device, t["prefetch_depth"], spans, keep)
    mp = t["size"] * t["size"] / MP
    view = None
    try:
        loop.run(count=w0)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        phases.mark("warmup")
        t0 = time.perf_counter()
        with vit_span(vit_module, spans):
            if trace:
                with Capture(tmpdir) as cap:
                    loop.run(count=t["trace_mosaics"])
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                n_traced = t["trace_mosaics"]
            t_end = loop.run(until=t0 + seconds)
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    finally:
        loop.close()
    window = [r for r in loop.records if r[0] >= w0]
    lat = [r[2] - r[1] for r in window]
    kept = dict(loop.kept)
    del loop, segment
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        view = cap.view({"mosaics": n_traced, "mp": n_traced * mp})
    numbers = judge(cell, seed, kept, pool, device) if kept else {}
    missing = len(keep) - len(kept)
    metrics = {"seg_mp_per_s": len(window) * mp / (t_end - t0),
               "peak_mem_gib": peak / 2**30}
    if len(lat) >= 1:
        metrics["seg_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    return {"metrics": metrics, "attempted": len(window), "failed": 0, "numbers": numbers,
            "unjudged": missing, "memory_peak_bytes": peak, "view": view, "t0": t0,
            "phases": phases.done}

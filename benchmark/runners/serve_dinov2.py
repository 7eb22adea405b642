"""The serving runner of a DINOv2 configuration: the closed loop of
``runners/serve.py`` (its ``Loop``, ``tile_rel`` and judge) with this
model's program, plain reference (``reference/dinov2.py``) and weights.

Weights from the seed, in DINOv2's state-dict layout (:func:`layout`), on the
device: one normal draw for every matrix, token, bias and LayerNorm
parameter, one uniform draw for the LayerScale gammas. Matrices, embeddings,
the CLS, register and mask tokens trunc-normal(std) (truncated at +-2);
biases N(0, bias_std); LayerNorm scales 1 + N(0, bias_std); each
LayerScale gamma per channel uniform in [gamma_low, gamma_high] (a served
model's are per-channel and far from the hub's init of 1, and a gamma of 1
dropped would hide in the tolerance). The program and the reference receive
the same state dict.

The program is the port's ``pipeline.segment_mosaic`` on the configuration's
``models.vit.ViTConfig`` (``vit.infer_routes`` of the configuration's
``infer_mlp`` and ``quant`` for that model); a port without the DINOv2
fields fails at set-up. ``fault_factory`` plants ``faults.py``'s serving
faults in this program, for ``calibrate_dinov2.py`` and the tests.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import inputs
from ..faults import SERVE_FAULTS, _half_vit
from ..reference import dinov2 as ref
from ..reference import vit as ref_vit
from ..tracing import Capture, Phases, Spans
from ..weights import DTYPES
from .serve import MP, Loop, _share_differing, tile_rel


def layout(cfg: dict):
    """[(name, shape, kind)] of the model's tensors in DINOv2's keys, kind
    one of "normal", "bias", "scale", "gamma"."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    hidden = cfg["ffn_hidden"]
    n_pos = (cfg["img_size"] // p) ** 2 + 1
    out = [("patch_embed.proj.weight", (d, 3, p, p), "normal"),
           ("patch_embed.proj.bias", (d,), "bias"),
           ("cls_token", (1, 1, d), "normal"),
           ("pos_embed", (1, n_pos, d), "normal"),
           ("register_tokens", (1, cfg["num_register_tokens"], d), "normal"),
           ("mask_token", (1, d), "normal")]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,), "scale"), (b + "norm1.bias", (d,), "bias"),
                (b + "attn.qkv.weight", (3 * d, d), "normal"),
                (b + "attn.qkv.bias", (3 * d,), "bias"),
                (b + "attn.proj.weight", (d, d), "normal"), (b + "attn.proj.bias", (d,), "bias"),
                (b + "ls1.gamma", (d,), "gamma"),
                (b + "norm2.weight", (d,), "scale"), (b + "norm2.bias", (d,), "bias"),
                (b + "mlp.w12.weight", (2 * hidden, d), "normal"),
                (b + "mlp.w12.bias", (2 * hidden,), "bias"),
                (b + "mlp.w3.weight", (d, hidden), "normal"),
                (b + "mlp.w3.bias", (d,), "bias"),
                (b + "ls2.gamma", (d,), "gamma")]
    return out + [("norm.weight", (d,), "scale"), ("norm.bias", (d,), "bias")]


def make_state(cfg: dict, seed: int, device, dtype=None):
    """The state dict of ``cfg``'s model from ``seed`` on ``device``, cast to
    ``dtype`` (the configuration's ``weights.dtype`` when None)."""
    init = cfg["weights"]
    dtype = DTYPES[init["dtype"]] if dtype is None else dtype
    entries = layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = [e for e in entries if e[2] != "gamma"]
    gammas = [e for e in entries if e[2] == "gamma"]
    z = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=gen, device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in gammas), generator=gen, device=device)
    lo, hi = init["gamma_low"], init["gamma_high"]
    state, off = {}, 0
    for name, shape, kind in normal:
        n = math.prod(shape)
        t = z[off : off + n].reshape(shape)
        off += n
        if kind == "normal":
            t = torch.clamp(t * init["std"], -2.0, 2.0)
        else:
            t = t * init["bias_std"] + (1.0 if kind == "scale" else 0.0)
        state[name] = t.to(dtype)
    del z
    off = 0
    for name, shape, _ in gammas:
        n = math.prod(shape)
        state[name] = (lo + (hi - lo) * u[off : off + n].reshape(shape)).to(dtype)
        off += n
    return state


def vit_config(vit, c: dict):
    """The port's ViTConfig of configuration ``c``."""
    return vit.ViTConfig(patch_size=c["patch_size"], embed_dim=c["embed_dim"], depth=c["depth"],
                         num_heads=c["num_heads"], mlp_ratio=c["mlp_ratio"],
                         qkv_bias=c["qkv_bias"], ln_eps=c["ln_eps"],
                         pretrain_img_size=c["img_size"],
                         num_register_tokens=c["num_register_tokens"], ffn=c["ffn"],
                         layerscale=c["layerscale"], pos_interp=c["pos_interp"])


def program_segment(cell, state, device):
    """segment(img (H, W) uint8 on the device) -> (mask, attention) of the
    port, and the port's ViT module (for the faults)."""
    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.models import vit

    c, t = cell.config, cell.traffic
    vcfg = vit_config(vit, c)
    if vcfg.ffn_hidden != c["ffn_hidden"]:
        raise ValueError(f"the port's SwiGLU width {vcfg.ffn_hidden} != {c['ffn_hidden']}")
    routes = vit.infer_routes(c["infer_mlp"], c["quant"], vcfg)
    with torch.device("meta"):
        model = vit.ViT(vcfg)
    model.load_state_dict(state, assign=True)
    model.requires_grad_(False)
    dtype = DTYPES[cell.precision]
    model = pl.cast_params(model, dtype)
    if t["route"] != "fused":
        raise ValueError(f"route {t['route']!r}: this runner serves the fused route")

    def segment(img):
        return pl.segment_mosaic(model, img, t["window"], t["stride"], dtype=dtype, routes=routes)

    return segment, vit


def reference_segment(cell, state, device, precision="fp8"):
    """The plain reference in the program's place, in ``precision`` (the
    control): the same signature as :func:`program_segment`."""
    t = cell.traffic

    def segment(img):
        attn = ref.attention_canvas(state, cell.config, img, t["window"], t["stride"], precision)
        return ref_vit.threshold_multiplicative(img, attn), attn

    return segment, None


def fault_factory(fault: str):
    """A segment factory with ``fault`` planted (faults.py's serving faults:
    ``stale``, ``half_batch``, ``alter_answer``) in this runner's program."""
    if fault not in SERVE_FAULTS:
        raise ValueError(f"fault {fault!r} not in {SERVE_FAULTS}")

    def factory(cell, state, device):
        seg, vit_module = program_segment(cell, state, device)
        last = []

        def segment(img):
            if fault == "half_batch":
                with _half_vit(vit_module):
                    return seg(img)
            mask, attn = seg(img)
            if fault == "alter_answer":
                mask = mask.clone()
                rows = max(1, mask.shape[0] // 100)
                mask[:rows] = 255 - mask[:rows]
                return mask, attn
            prev = last[0] if last else (mask, attn)
            last[:] = [(mask, attn)]
            return prev

        return segment, None

    return factory


@torch.no_grad()
def judge(cell, seed, kept, pool, device) -> dict:
    """The compared numbers (worst over the sample) of the kept mosaics:
    ``canvas_rel``, ``tile_rel``, ``mask_ref_px`` and ``mask_own_px``, as
    runners/serve.py's judge of a fused cell."""
    t = cell.traffic
    state = make_state(cell.config, seed, device)
    out = {"canvas_rel": 0.0, "tile_rel": 0.0, "mask_own_px": 0.0, "mask_ref_px": 0.0}
    for _, (k, mask_p, attn_p) in sorted(kept.items()):
        img = pool[k].to(device)
        attn_p = attn_p.to(device)
        mask_p = torch.from_numpy(mask_p).to(device)
        own = ref_vit.threshold_multiplicative(img, attn_p)
        out["mask_own_px"] = max(out["mask_own_px"], _share_differing(own, mask_p))
        canvas = ref.attention_canvas(state, cell.config, img, t["window"], t["stride"])
        rel = float(torch.linalg.vector_norm(attn_p - canvas) / torch.linalg.vector_norm(canvas))
        tiles = tile_rel(attn_p, canvas, 0, t["window"], t["stride"], img.shape)
        mask_r = ref_vit.threshold_multiplicative(img, canvas)
        out["mask_ref_px"] = max(out["mask_ref_px"], _share_differing(mask_r, mask_p))
        out["canvas_rel"] = max(out["canvas_rel"], rel)
        out["tile_rel"] = max(out["tile_rel"], tiles)
    return out


def run(cell, seed, seconds, trace, device, tmpdir, segment_factory=None, judge_within=None):
    """One run of a DINOv2 serving cell, as runners/serve.py's ``run``.
    ``segment_factory(cell, state, device)`` replaces the program (controls
    and faults); ``judge_within`` overrides the cell's span of window mosaics
    the sample is drawn from. Returns the run's record (see run.py)."""
    t, lim = cell.traffic, cell.limits
    spans, phases = Spans(bool(trace)), Phases()
    from vit_ocm_wmsegmentation_tpu_torch import pipeline  # noqa: F401

    phases.mark("port_imports")
    state = make_state(cell.config, seed, device)
    segment, _ = (segment_factory or program_segment)(cell, state, device)
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phases.mark("weights_and_model")
    pool_dev = inputs.mosaic_pool(t["size"], t["blob"], t["pool"], seed, device)
    pool = pool_dev.cpu().pin_memory() if device.type == "cuda" else pool_dev
    del pool_dev
    phases.mark("mosaics")
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
    metrics = {"seg_mp_per_s": len(window) * mp / (t_end - t0), "peak_mem_gib": peak / 2**30}
    if lat:
        metrics["seg_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    return {"metrics": metrics, "attempted": len(window), "failed": 0, "numbers": numbers,
            "unjudged": len(keep) - len(kept), "memory_peak_bytes": peak, "view": view, "t0": t0,
            "phases": phases.done}

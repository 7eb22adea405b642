"""The multi-rank dry run: every sharded path of the port held against one
rank on the same inputs.

    python -m vit_ocm_wmsegmentation_tpu_torch.parallel.dryrun --world 4 --device cpu
    python -m vit_ocm_wmsegmentation_tpu_torch.parallel.dryrun --world 2 --full

Counterpart of ``__graft_entry__.py::dryrun_multichip``. :func:`spawn`
starts ``world`` processes that form one process group (a ``file://``
store, a timeout on every collective and on the whole run) and returns each
rank's result. :func:`dryrun_multichip` runs, on every rank:

* one MIM step (fwd + bwd + clip + AdamW) on a dp x tp mesh (data world/2 x
  model 2; the MIM ViT with ViT-S's 6 heads of 64 there, since its 3 heads
  of 128 do not divide over 2 ranks and a rank keeps whole heads; its
  reference runs the same stock routes on one rank), on a pure
  data-parallel mesh (the training kernels on each rank), under FSDP (and
  the sharded leaves' local fraction, 1/world), and pipelined (4 stages and
  2 microbatches at world >= 4, else 2 stages and 4 microbatches), in f32
  and in AMP bf16, each against the single-rank step on the same weights
  and batch (the dry run's ``> 0.5`` mask, so the shards hold unequal mask
  counts). AdamW's epsilon is 1e-3 (as in tests/test_torch_parallel_train.py),
  so that a parameter's first update follows its gradient, not only the
  gradient's sign, and the parameter check sees a gradient's error. f32:
  loss within 1e-5 relative, gradient norm within 1e-4 relative, every
  gradient tensor within 1e-4 of its own max|g|, every parameter within
  1e-4 (TOL). AMP: within 5e-3, 2e-2, 0.15 and 2.5 learning rates (the JAX
  package's pp AMP test; the gradients' bound is tests/test_torch_train.py's
  for AMP). The f32 dp x tp step alone holds its gradients at TP_GRADS:
  the masked L1 has a kink at each zero residual, and the split's other
  summation order flips the sign of a residual that lies within rounding
  of 0 (ROADMAP Queue 3). A second f32 dp x tp step, with every residual's
  sign taken from the single-rank step (:func:`_l1_signs`), is held at TOL
  on everything: the witness that the flips are the whole difference;
* the fused mosaic in f32 and bf16 and the streamed mosaic in f32, the tiles
  sharded over the group, each against the single-rank call: the mask bit
  for bit, the attention within 5e-3 on the 0-255 scale.

``full=True`` takes the card's geometry (the MIM step at 16 x 384^2, the
mosaic of ViT-S/8 at 1152^2 and the streamed one at 2048^2); the default
is the tiny geometry of the JAX dry run (48^2 images, 96^2 mosaic with
window 48 and stride 16, the MIM ViT of width 384 and depth 4). Any
failure raises.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import os
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np
import torch

from .. import pipeline as pl
from ..models import simmim, vit
from ..ops import flash_attention as fa
from ..ops import fused_mlp as fm
from ..ops import threshold as th
from ..sw_processing import resolve_device
from ..train.mim_trainer import make_train_step
from ..train.optim import Optimizer
from ..utils.config import default_config
from . import mesh as pm
from . import pp

# the kernel wrappers of the sharded paths (PERF.md rows 1-3, 3h, 5, 6, 8, 4)
WRAPPERS = {"attention_qkv": fa.attention_qkv, "fused_mlp_block_lnout": fm.fused_mlp_block_lnout,
            "fused_mlp_block": fm.fused_mlp_block, "fused_mlp_block_h1": fm.fused_mlp_block_h1,
            "flash_attention": fa.flash_attention, "flash_attention_bwd": fa.flash_attention_bwd,
            "fused_mlp_bwd": fm.fused_mlp_bwd, "histogram_u8_kernel": th.histogram_u8_kernel}
LR = 1e-4
EPS = 1e-3  # AdamW's epsilon (module docstring)
# loss: relative; gradient norm: relative; gradients: max|sharded - one rank|
# / max|one rank| per tensor; parameters: max|d| after the update
TOL = {"f32": {"loss": 1e-5, "gnorm": 1e-4, "grads": 1e-4, "params": 1e-4},
       "bf16": {"loss": 5e-3, "gnorm": 2e-2, "grads": 0.15, "params": 2.5 * LR}}
# the f32 dp x tp step's gradients with their own residual signs: 2.4 x the
# card's 4.20e-3 (pos_embed, 16 x 384^2, PERF.md PR 20); DP, FSDP and PP read
# below 1e-6 there
TP_GRADS = 1e-2
ATTN_TOL = 5e-3  # mosaic attention, 0-255 scale
TP_HEADS = 6  # the dp x tp step's MIM ViT (module docstring)
# (MIM image size and batch, mosaic size, window, stride, streamed size)
GEOMETRY = {False: dict(img=48, batch=8, mosaic=96, window=48, stride=16, streamed=96),
            True: dict(img=384, batch=16, mosaic=1152, window=384, stride=128, streamed=2048)}


# ---------------------------------------------------------------------------
# process groups of spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, args, rank, world, backend, device, tmp, threads, timeout_s):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        pm.init_distributed(backend, f"file://{os.path.join(tmp, 'store')}", rank, world,
                            device, timeout_s)
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    finally:
        pm.shutdown()


def spawn(fn, world: int, *args, backend: str = "gloo", device=None, threads: int | None = 1,
          timeout_s: float = 600.0):
    """Run ``fn(*args)`` in ``world`` new processes (the ``spawn`` start
    method; ``fn`` must be importable) that form one process group of
    ``backend``, each on ``device`` (None: NCCL ranks take card ``rank``).
    Each sets ``threads`` torch threads (None leaves the default). Returns
    the ranks' results, in rank order. Raises RuntimeError with the failing
    ranks' tracebacks as soon as one fails (the others are killed), and
    TimeoutError after ``timeout_s``."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, args, r, world, backend, device, tmp,
                                                      threads, timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} still running after "
                                       f"{timeout_s} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"error{r}.txt")
            if os.path.exists(path):
                errors.append(f"rank {r}:\n{open(path).read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r} exited with {p.exitcode}")
        if errors:
            raise RuntimeError(f"{fn.__name__} failed on {world} ranks:\n" + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world)]


# ---------------------------------------------------------------------------
# the dry run of one rank
# ---------------------------------------------------------------------------


def launch_counts() -> dict:
    return {n: w.launches for n, w in WRAPPERS.items()}


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mim_inputs(g):
    rng = np.random.default_rng(0)
    x = rng.random((g["batch"], g["img"], g["img"], 3), dtype=np.float32)
    n = g["img"] // 8
    mask = (rng.random((g["batch"], n, n)) > 0.5).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(mask)


def _mim_model(g, device, heads=3):
    cfg = dataclasses.replace(simmim.mim_vit_config(g["img"], 8), num_heads=heads)
    return simmim.init(cfg, torch.Generator().manual_seed(0), device)


def _optimizer(model):
    cfg = default_config()
    cfg.TRAIN.OPTIMIZER.EPS = EPS
    return Optimizer(cfg, model, lambda t: LR)


def _record_grads(opt):
    """Keep a copy of the gradients each optimizer step is given (the
    rank's reduced pieces, before the clip scales them in place)."""
    seen = {}
    step = opt.step

    def recording(grads):
        seen.update(zip(opt.names, (g.detach().clone() for g in grads)))
        return step(grads)

    opt.step = recording
    return seen


@contextlib.contextmanager
def _l1_signs(seen: list, fixed=None):
    """simmim.masked_l1 that appends sign(x - x_rec) on the masked pixels to
    ``seen``; with ``fixed`` (signs of this rank's rows), |x - x_rec| read
    as (x - x_rec) * fixed: the same loss with those signs at every
    residual, and their derivative everywhere (profile_grad64.l1_signs)."""
    masked_l1 = simmim.masked_l1

    def l1(x, x_rec, mask, p, pix_count=None):
        loss, pix_mask = masked_l1(x, x_rec, mask, p, pix_count)
        seen.append((torch.sign(x - x_rec) * pix_mask).detach())
        if fixed is not None:
            count = pix_mask.float().sum() if pix_count is None else pix_count
            signed = (x - x_rec) * fixed.to(x.dtype) * pix_mask
            loss = signed.float().sum() / (count + 1e-5) / 3.0
        return loss, pix_mask

    with mock.patch.object(simmim, "masked_l1", l1):
        yield


def _single_step(g, amp, device, heads=3):
    """The single-rank step: {loss, gnorm, state, grads (on the CPU), the
    masked residuals' signs (on ``device``), bytes at rest}. The tp step's
    reference (``heads`` TP_HEADS) runs the same stock routes on one rank,
    the blocks of block_forward_tp over a 'model' axis of 1, so that the
    check isolates the split, as the JAX dry run compares two meshes on one
    route."""
    x, mask = _mim_inputs(g)
    model = _mim_model(g, device, heads)
    opt = _optimizer(model)
    grads = _record_grads(opt)
    routes = vit.TrainRoutes()
    if heads == TP_HEADS:
        routes = vit.TrainRoutes(tp=pm.TensorParallel(pm.Mesh(("data", "model"), (1, 1))))
    signs = []
    with _l1_signs(signs):
        loss, gnorm = make_train_step(model, opt, amp=amp, routes=routes)(x.to(device),
                                                                          mask.to(device))
    _sync(device)
    return {"loss": float(loss), "gnorm": float(gnorm),
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "grads": {k: v.cpu() for k, v in grads.items()}, "signs": signs[-1],
            "bytes": pm.bytes_at_rest(model, opt)}


def _modes(world):
    stages = 4 if world >= 4 else 2
    out = {"dp": ("data", world, 1), "fsdp": ("data", world, 1), "pp": ("pipe", world // stages,
                                                                       stages)}
    if world % 2 == 0:
        out = {"dp x tp": ("model", world // 2, 2), **out}
    return out


def _heads(spec):
    return TP_HEADS if spec[0] == "model" else 3


def _sharded_step(g, amp, device, mode, spec, signs=None, fix=False):
    """One sharded step on this rank: {loss, gnorm, whole state and
    gradients on the CPU, launches, bytes at rest, local fractions of the
    FSDP leaves}. With ``signs`` (the single-rank step's residual signs,
    the whole batch), also the count of this rank's masked residuals of
    another sign; with ``fix`` as well, the loss takes those signs."""
    kind, data, other = spec
    x, mask = _mim_inputs(g)
    model = _mim_model(g, device, _heads(spec))
    if kind == "pipe":
        mesh = pp.make_pp_mesh(data=data, pipe=other)
        layout = pp.pp_layout(mesh, model)
    else:
        mesh = pm.make_mesh(data=data, model=other)
        layout = pm.param_layout(mesh, model, fsdp=mode == "fsdp")
    full = {n: p.numel() for n, p in model.named_parameters()}
    layout.shard_module(model)
    opt = _optimizer(model)
    opt.norm = layout.norm_fn(opt.names)
    grads = _record_grads(opt)
    if kind == "pipe":
        step = pp.make_pp_train_step(model, opt, layout, 2 if other == 4 else 4, amp=amp)
    else:
        step = make_train_step(model, opt, amp=amp, layout=layout)
    xl, ml = pm.local_rows(x, mesh).to(device), pm.local_rows(mask, mesh).to(device)
    local_signs = None if signs is None else pm.local_rows(signs, mesh)
    _sync(device)
    reset_counts()
    seen = []
    with _l1_signs(seen, local_signs if fix else None):
        loss, gnorm = step(xl, ml)
    _sync(device)
    launches = launch_counts()
    fractions = {}
    if mode == "fsdp":
        params = dict(model.named_parameters())
        moments = {opt.names[i]: st for i, st in opt.opt.state_dict()["state"].items()}
        for n in ("encoder.blocks.0.attn.qkv.weight", "encoder.blocks.0.attn.qkv.bias"):
            fractions[n] = (params[n].numel() / full[n], moments[n]["exp_avg"].numel() / full[n])
    like = opt.params[0]
    full_grads = {n: layout.full_tensor(n, grads.get(n), like).cpu() for n in layout.full_shapes}
    out = {"loss": float(loss), "gnorm": float(gnorm),
           "state": {k: v.cpu() for k, v in layout.full_state(model).items()},
           "grads": full_grads, "launches": launches, "bytes": pm.bytes_at_rest(model, opt),
           "fractions": fractions}
    if signs is not None and not fix:
        out["flips"] = int((seen[-1] != local_signs).sum())
    return out


def _check_step(name, tag, got, ref, grads_tol=None):
    """The sharded step against the single-rank one: loss and gradient
    norm, every gradient tensor at its own scale (within ``grads_tol`` in
    place of TOL's when given), every parameter."""
    tol = dict(TOL[tag], **({} if grads_tol is None else {"grads": grads_tol}))
    loss, rloss, gnorm, rgnorm = got["loss"], ref["loss"], got["gnorm"], ref["gnorm"]
    if tag == "f32":
        rel = abs(loss - rloss) / max(1.0, abs(rloss))
        grel = abs(gnorm - rgnorm) / max(1.0, abs(rgnorm))
    else:
        rel, grel = abs(loss - rloss) / abs(rloss), abs(gnorm - rgnorm) / abs(rgnorm)
    gerr, gworst, perr, pworst = 0.0, "", 0.0, ""
    for k, want in ref["state"].items():
        gref = ref["grads"][k]
        e = float((got["grads"][k] - gref).abs().max()) / max(float(gref.abs().max()), 1e-30)
        if e > gerr:
            gerr, gworst = e, k
        d = float((got["state"][k] - want).abs().max())
        if d > perr:
            perr, pworst = d, k
    line = (f"{name} [{tag}]: loss {loss:.6f} vs {rloss:.6f} (rel {rel:.2e}), grad norm "
            f"{gnorm:.6f} vs {rgnorm:.6f} (rel {grel:.2e}), gradients max|d|/max|g| "
            f"{gerr:.2e} ({gworst}), params max|d| {perr:.2e} ({pworst})")
    if "flips" in got:
        line += f"; {got['flips']} masked residuals of another sign than one rank's"
    if not (rel <= tol["loss"] and grel <= tol["gnorm"] and gerr <= tol["grads"]
            and perr <= tol["params"]):
        raise AssertionError(f"{line} exceeds {tol}")
    return line


def _mosaic_inputs(g):
    rng = np.random.default_rng(0)
    fused = (rng.random((g["mosaic"], g["mosaic"])) * 255).astype(np.uint8)
    streamed = (rng.random((g["streamed"], g["streamed"])) * 255).astype(np.uint8)
    return torch.from_numpy(fused), torch.from_numpy(streamed)


def _mosaic_model(full, device):
    cfg = (vit.VIT_SMALL(patch_size=8) if full else
           vit.ViTConfig(patch_size=8, embed_dim=384, depth=4, num_heads=3, pretrain_img_size=48))
    return vit.init(cfg, torch.Generator().manual_seed(1), device)


def _check_mosaic(name, got, ref):
    (mask, attn), (rmask, rattn) = got, ref
    diff = int((mask != rmask).sum())
    err = float((attn - rattn).abs().max())
    line = (f"{name}: mask {'bit-equal' if diff == 0 else f'differs at {diff} px'} "
            f"(fg {float((mask > 0).float().mean()):.4f}), attention max|d| {err:.2e}")
    if diff or err > ATTN_TOL:
        raise AssertionError(line)
    return line


def _ref_signs(refs, g, device):
    """The tp reference's residual signs (rank 0's), on every rank."""
    shape = (g["batch"], g["img"], g["img"], 3)
    signs = refs[TP_HEADS]["signs"] if refs else torch.empty(shape, device=device)
    return pm.broadcast(signs, pm.make_mesh(), "data", 0)


def _dryrun_rank(full: bool, device):
    device = torch.device(device)
    rank, world = pm.process_rank(), pm.world_size()
    g = GEOMETRY[full]
    report = {"rank": rank, "world": world, "backend": pm.backend(),
              "device": str(device), "lines": [], "launches": {}, "bytes": {}, "fractions": {}}
    with pl.exact_matmuls():
        for amp, tag in ((False, "f32"), (True, "bf16")):
            modes = _modes(world)
            refs = {}
            if rank == 0:  # the single-rank steps, one for each head count
                refs = {h: _single_step(g, amp, device, h)
                        for h in sorted({_heads(spec) for spec in modes.values()})}
                report["bytes"][f"single [{tag}]"] = refs[3]["bytes"]
            for mode, spec in modes.items():
                tp32 = spec[0] == "model" and not amp
                signs = _ref_signs(refs, g, device) if tp32 else None
                got = _sharded_step(g, amp, device, mode, spec, signs)
                report["launches"][f"{mode} [{tag}]"] = got["launches"]
                report["bytes"][f"{mode} [{tag}]"] = got["bytes"]
                if mode == "fsdp":
                    report["fractions"][tag] = got["fractions"]
                    for n, (frac, mfrac) in got["fractions"].items():
                        want = 1.0 / world if n.endswith("weight") else 1.0
                        if frac != want or mfrac != want:
                            raise AssertionError(f"FSDP {n}: local fraction {frac}, moments "
                                                 f"{mfrac}, want {want}")
                shape = {"pipe": "data x pipe", "model": "data x model", "data": "data"}[spec[0]]
                name = f"{mode} ({shape} {spec[1]} x {spec[2]})"
                if rank == 0:
                    report["lines"].append(_check_step(name, tag, got, refs[_heads(spec)],
                                                       TP_GRADS if tp32 else None))
                if tp32:  # the witness: the same step with one rank's residual signs
                    got = _sharded_step(g, amp, device, mode, spec, signs, fix=True)
                    if rank == 0:
                        report["lines"].append(_check_step(f"{name}, one rank's residual signs",
                                                           tag, got, refs[TP_HEADS]))

    fused, streamed = _mosaic_inputs(g)
    base = _mosaic_model(full, device)
    mesh = pm.make_mesh()
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        model = pl.cast_params(copy.deepcopy(base), dtype)
        img = fused.to(device)
        kw = dict(window=g["window"], stride=g["stride"], dtype=dtype)
        ref = pl.segment_mosaic(model, img, **kw) if rank == 0 else None
        _sync(device)
        reset_counts()
        got = pl.segment_mosaic(model, img, mesh=mesh, **kw)
        _sync(device)
        report["launches"][f"fused mosaic [{tag}]"] = launch_counts()
        if rank == 0:
            report["lines"].append(_check_mosaic(f"fused {g['mosaic']}^2 mosaic [{tag}]", got, ref))
        del model
    model = base
    kw = dict(window=g["window"], stride=g["stride"], band_chunk=2)
    ref = pl.segment_mosaic_streamed(model, streamed, **kw) if rank == 0 else None
    _sync(device)
    reset_counts()
    got = pl.segment_mosaic_streamed(model, streamed, mesh=mesh, **kw)
    _sync(device)
    report["launches"]["streamed mosaic [f32]"] = launch_counts()
    if rank == 0:
        report["lines"].append(_check_mosaic(f"streamed {g['streamed']}^2 mosaic [f32]", got, ref))
    return report


def dryrun_multichip(world: int, backend: str = "gloo", device="cpu", *, full: bool = False,
                     threads: int | None = 1, timeout_s: float = 900.0):
    """The dry run (module docstring) on ``world`` spawned ranks of one
    ``backend`` group, all on ``device`` (``cuda:0`` puts every rank on one
    card: gloo then stages the collectives through host memory). Prints
    each check and each rank's kernel launches; returns the ranks' reports."""
    reports = spawn(_dryrun_rank, world, full, device, backend=backend, device=device,
                    threads=threads, timeout_s=timeout_s)
    staged = (" (card tensors staged through host memory)"
              if pm.staged_through_host(backend, device) else "")
    print(f"dryrun_multichip: world {world}, backend {backend}, device {device}{staged}")
    for line in reports[0]["lines"]:
        print(f"  {line}")
    for r in reports:
        for what, counts in r["launches"].items():
            print(f"  rank {r['rank']} launches, {what}: "
                  + " ".join(f"{k} {v}" for k, v in counts.items() if v))
    for what, n in reports[0]["bytes"].items():
        print(f"  rank 0 bytes at rest (params + optimizer state), {what}: {n}")
    return reports


def main(argv=None):
    parser = argparse.ArgumentParser("multi-rank dry run of the port's sharded paths")
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    parser.add_argument("--device", default="cuda:0",
                        help="every rank's device: cuda:0 shares one card over gloo "
                             "(raises without a card), or cpu")
    parser.add_argument("--full", action="store_true",
                        help="the card's geometry instead of the tiny one")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    dryrun_multichip(args.world, args.backend, str(device), full=args.full,
                     threads=1 if device.type == "cpu" else None)


if __name__ == "__main__":
    main()

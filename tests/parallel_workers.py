"""The ranks' side of the port's multi-process CPU tests
(tests/test_torch_parallel*.py).

Each function runs on every rank of a group that
``vit_ocm_wmsegmentation_tpu_torch.parallel.dryrun.spawn`` starts (gloo, a
``file://`` store, one torch thread) and returns what the test process
compares. Spawned processes import their function by module name, so these
live in a module of their own, and it imports no JAX: the JAX package's side
of each comparison runs in the test process.
"""

import os

import numpy as np
import torch

from vit_ocm_wmsegmentation_tpu_torch import build, mim, pipeline, sw_processing
from vit_ocm_wmsegmentation_tpu_torch.models import simmim, vit
from vit_ocm_wmsegmentation_tpu_torch.parallel import mesh as pm
from vit_ocm_wmsegmentation_tpu_torch.parallel import pp
from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step
from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer


# ---------------------------------------------------------------------------
# collectives, padding, the Megatron pair, sharded mosaics
# ---------------------------------------------------------------------------


def collectives():
    """The collectives on a 4-rank ('data', 'model') mesh of 2 x 2 and a
    4-rank data mesh: each rank contributes rank-made values."""
    r = pm.process_rank()
    out = {"rank": r}
    mesh = pm.make_mesh(data=2, model=2)
    out["coords"] = (mesh.index("data"), mesh.index("model"))
    t = torch.full((3,), float(r + 1))
    out["all_reduce_data"] = pm.all_reduce(t.clone(), mesh, "data")
    out["all_reduce_model"] = pm.all_reduce(t.clone(), mesh, "model")
    out["all_gather_dim1"] = pm.all_gather(torch.full((2, 1), float(r)), mesh, "data", dim=1)
    out["reduce_scatter"] = pm.reduce_scatter(torch.arange(8.0).reshape(4, 2) * (r + 1), mesh,
                                              "model", dim=0)
    out["broadcast"] = pm.broadcast(torch.full((2,), float(r)), mesh, "model", 1)
    # a bucketed all-reduce of many tensors of two dtypes, over buckets of
    # a few elements
    saved, pm.BUCKET_BYTES = pm.BUCKET_BYTES, 16
    try:
        ts = [torch.full((k + 1,), float(r + k)) for k in range(5)] + [
            torch.full((2,), r + 1, dtype=torch.float64)]
        out["all_reduce_tensors"] = pm.all_reduce_tensors(ts, pm.make_mesh(), "data")
    finally:
        pm.BUCKET_BYTES = saved
    # a ring of sends and receives along 'data' of a 4 x 1 mesh
    ring = pm.make_mesh()
    n, i = ring.axis_size("data"), ring.index("data")
    h = pm.send(torch.full((2,), float(i)), ring, "data", (i + 1) % n)
    out["ring_recv"] = pm.recv(torch.empty(2), ring, "data", (i - 1) % n)
    h.wait()
    # 49 tiles over 4 ranks: padded to 52, 13 a rank, gathered back
    tiles = torch.arange(49 * 2, dtype=torch.float32).reshape(49, 2)
    local = pm.local_rows(tiles, ring, pad=True)
    out["local_tiles"] = local.clone()
    out["gathered_tiles"] = pm.gather_rows(local * 2, ring, 49)
    # Megatron's pair over 'model': y = exit(enter(x) * w_r), w_r this rank's
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    w = torch.tensor([float(mesh.index("model") + 1), 3.0])
    tp = pm.TensorParallel(mesh)
    y = tp.exit(tp.enter(x) * w)
    (gx,) = torch.autograd.grad((y * torch.tensor([1.0, 10.0])).sum(), x)
    out["tp_y"], out["tp_gx"] = y.detach(), gx
    return out


def sharded_mosaics(state, cfg, mosaics, window, stride):
    """The port's fused and streamed mosaics on a 4-rank data mesh and on
    one rank (every rank computes both), for each mosaic."""
    model = vit.ViT(cfg)
    model.load_state_dict(state)
    mesh = pm.make_mesh()
    out = []
    for img in mosaics:
        img = torch.from_numpy(img)
        res = {}
        for name, fn, kw in (("fused", pipeline.segment_mosaic, {}),
                             ("streamed", pipeline.segment_mosaic_streamed, {"band_chunk": 2})):
            res[name] = fn(model, img, window, stride, mesh=mesh, **kw)
            res[name + "_single"] = fn(model, img, window, stride, **kw)
        out.append(res)
    return out


def build_at_once(build_dir, log):
    """build.library() on every rank at once, the compiler replaced by a
    stand-in that takes a moment, notes its call in ``log`` and writes the
    library; returns the library's path and the seconds this rank
    compiled."""
    import time

    def compile_(srcs, so):
        with open(log, "a") as f:
            f.write(f"{pm.process_rank()}\n")
        time.sleep(0.5)
        with open(so, "w") as f:
            f.write("built")
        return "ptxas report"

    build.BUILD_DIR, build._compile = build_dir, compile_
    build._declare, build.ctypes.CDLL = (lambda lib: lib), (lambda path: path)
    torch.cuda.is_available = lambda: True
    build.library()
    return build.build_info["path"], build.build_info["seconds"]


def collectives_and_mosaics(state, cfg, mosaics, window, stride):
    return collectives(), sharded_mosaics(state, cfg, mosaics, window, stride)


# ---------------------------------------------------------------------------
# the MIM steps
# ---------------------------------------------------------------------------


def _step(cfg_tree, vit_cfg, state, x, mask, mode, amp, data, other, microbatches, lr):
    """One step of ``mode`` on this rank's rows; (loss, grad norm, whole
    state, FSDP local fractions)."""
    model = simmim.SimMIM(vit_cfg)
    model.load_state_dict(state)
    if mode == "pp":
        mesh = pp.make_pp_mesh(data=data, pipe=other)
        layout = pp.pp_layout(mesh, model)
    else:
        mesh = pm.make_mesh(data=data, model=other)
        layout = pm.param_layout(mesh, model, fsdp=mode == "fsdp", min_shard=64)
    full = {n: p.numel() for n, p in model.named_parameters()}
    layout.shard_module(model)
    opt = Optimizer(cfg_tree, model, lambda t: lr)
    opt.norm = layout.norm_fn(opt.names)
    if mode == "pp":
        step = pp.make_pp_train_step(model, opt, layout, microbatches, amp=amp)
    else:
        step = make_train_step(model, opt, amp=amp, layout=layout)
    xl, ml = pm.local_rows(x, mesh), pm.local_rows(mask, mesh)
    loss, gnorm = step(xl, ml)
    fractions = {}
    if mode == "fsdp":
        params = dict(model.named_parameters())
        moments = {opt.names[i]: st["exp_avg"] for i, st in opt.opt.state_dict()["state"].items()}
        fractions = {n: (params[n].numel() / full[n], moments[n].numel() / full[n])
                     for n in full}
    return {"loss": float(loss), "gnorm": float(gnorm), "state": layout.full_state(model),
            "fractions": fractions, "local_mask": int(ml.sum())}


def train_steps(cfg_tree, vit_cfg, state, batches, cases, lr):
    """Each case (name, mode, amp, data, other, microbatches, batch index) on
    the group: a dict name -> this rank's result."""
    out = {}
    with pipeline.exact_matmuls():
        for name, mode, amp, data, other, micro, b in cases:
            x, mask = batches[b]
            out[name] = _step(cfg_tree, vit_cfg, state, x, mask, mode, amp, data, other, micro,
                              lr)
    return out


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def clis(mim_runs, sw_runs):
    """mim.main on each argv of ``mim_runs`` in turn, then
    sw_processing.main on each of ``sw_runs``; this rank's histories and
    masks."""
    hists = [mim.main(argv)[1] for argv in mim_runs]
    masks = [{k: np.asarray(v) for k, v in sw_processing.main(argv).items()} for argv in sw_runs]
    return {"rank": pm.process_rank(), "hists": hists, "masks": masks}


def torchrun_rank(rank, world, store, out_dir, result):
    """Process target started as torchrun starts one: RANK, WORLD_SIZE and
    LOCAL_RANK in the environment and nothing passed to init_distributed
    but the store. Saves what it saw; only rank 0 writes its file."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    first = pm.init_distributed("gloo", init_method=f"file://{store}")
    again = pm.init_distributed("gloo", init_method=f"file://{store}")
    pm.on_main_process(lambda: open(os.path.join(out_dir, f"main_{rank}.txt"), "w").write("x"))
    total = pm.all_reduce(torch.tensor([float(rank + 1)]), pm.make_mesh(), "data")
    torch.save({"first": first, "again": again, "main": pm.is_main_process(),
                "total": float(total)}, result)
    pm.shutdown()

"""MIM pretraining loop (the reference's mim.py:83-222), on one device or
over a process group.

Counterpart of ``vit_ocm_wmsegmentation_tpu/train/mim_trainer.py``:

* :func:`make_train_step` builds one step: forward and backward of the
  masked-L1 loss on the training kernels, the global norm of the gradients,
  then clip and AdamW (train/optim.py). It returns (loss, grad norm before
  clipping) as the JAX step reports them. On one CUDA device the step is
  captured once as a CUDA graph and replayed (:class:`GraphedStep`), so
  that the host's launches no longer set the step's pace;
* :func:`train_routes` reads the opt-in kernel routes TRAIN.MLP_REMAT
  ("kernel+gp"), TRAIN.LN_QKV ("kernel") and TRAIN.ATTN_SAVE_P ("on"), and
  the MLP remat routes TRAIN.MLP_REMAT "none", "gelu" and "gelu+ln" (the
  plain MLP in place of the fused MLP kernels, ``models.vit.mlp_remat``),
  into a ``models.vit.TrainRoutes``, as the JAX package's
  ``set_train_kernel_modes`` sets its globals;
* AMP (AMP_OPT_LEVEL other than "" and "O0") works as the JAX package's
  ``amp_cast``: the f32 master parameters are cast to bf16 copies inside the
  step and x to bf16, so forward and backward run in bf16 and the gradients
  return in f32 through the casts' backward, rounded to bf16 first (no
  torch.autocast, which would pick other ops' dtypes). The loss sums in f32;
* :func:`train_mim`: epochs, logging every PRINT_FREQ steps, a checkpoint
  every SAVE_FREQ epochs and at the last, AUTO_RESUME from the newest
  checkpoint with the optimizer state, early stopping on a stalled loss
  (mim.py:116-135), W&B scalars at each print point and each epoch the
  reference's six "Masks" panels from one more forward on the epoch's last
  batch (mim.py:204-220), and an ``eval_fn(encoder, epoch)`` after each
  epoch's checkpoint. Batches come as numpy arrays (the host loader) or as
  tensors on the device (``data.datasets.DeviceAugLoader``,
  DATA.DEVICE_AUG). Its library matmuls run under
  ``pipeline.exact_matmuls()`` (no TF32, f32 reductions of bf16 products);
* over a ``mesh`` (parallel/mesh.py; the MIM CLI makes one under torchrun):
  every rank draws the same global batch from the same seeded loader and
  keeps its rows of the 'data' axis, the split of the JAX package's
  ``batch_sharding`` (the host work is duplicated: ROADMAP later work).
  :func:`sharded_step` is the one step body of every sharded mode: the loss
  of the rank's rows over the whole batch's mask area (so the ranks' losses
  sum to the single-device loss whatever each shard's mask count), its
  gradients reduced by the rank's ``parallel.mesh.ParamLayout`` (one flat
  bucketed all-reduce over 'data' for data parallelism; all-gathered
  parameters and reduce-scattered gradients under TRAIN.FSDP; the Megatron
  split over 'model'), the global norm summed over the ranks, clip and AdamW
  on the rank's pieces. TRAIN.PP_STAGES > 1 takes parallel/pp.py's GPipe
  step on a ('data', 'pipe') mesh over the whole group. Logging, checkpoints
  (gathered to the plain single-device layout, tagged with ``pp_stages``
  under pipeline parallelism), W&B files and ``eval_fn`` belong to rank 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time

import torch

from ..models import simmim
from ..models.vit import MLP_REMAT_MODES, TrainRoutes
from ..ops.metrics import AverageMeter
from ..parallel import mesh as par
from ..pipeline import exact_matmuls
from ..utils import profiling
from ..utils.profiling import annotate
from . import checkpoint as ckpt
from .optim import Optimizer, global_norm
from .schedule import build_schedule


def amp_cast(params: dict) -> dict:
    """The AMP rule: bf16 compute copies of the f32 tensors of ``params``
    (name -> tensor), other dtypes unchanged. The casts' backward returns
    the gradients in f32 to the master weights. Shared by the MIM step and
    the Allen classifier's (train/classifier.py)."""
    return {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p for n, p in params.items()}


def sharded_step(model, optimizer, layout, loss_fn, *, amp: bool = False):
    """The step of a rank of a mesh: step(x, mask) on the rank's rows ->
    (loss, grad norm) of the whole batch, the same on every rank.
    ``loss_fn(live, x, mask, pix_count)`` computes the rank's share of the
    loss from ``live`` (name -> tensor the forward reads); ``layout``
    (parallel.mesh.ParamLayout) gathers FSDP pieces for the forward and
    reduces the gradients. The AMP cast follows the gather, so the bf16
    copies are of the whole f32 masters."""
    names, mesh = optimizer.names, layout.mesh
    p2 = model.cfg.patch_size ** 2

    def step(x, mask):
        pix = par.all_reduce((mask.sum() * p2).float(), mesh, "data")
        base = layout.compute_params(model, names)
        live = amp_cast(base) if amp else base
        loss = loss_fn(live, x.to(torch.bfloat16) if amp else x, mask, pix)
        grads = torch.autograd.grad(loss, [base[n] for n in names])
        grads = layout.reduce_grads(grads, names)
        gnorm = optimizer.norm(grads)
        optimizer.step(grads)
        return par.all_reduce(loss.detach().clone(), mesh, "data"), gnorm

    return step


def _step_body(model, optimizer, update, *, amp: bool, remat: bool, routes: TrainRoutes):
    """body(x, mask) -> (loss, grad norm): the one-device step's work in its
    ``mim.forward``, ``mim.backward`` and ``mim.optimizer`` spans, the
    gradients handed to ``update`` (``optimizer.step``, or for a graph the
    device part ``optimizer.apply``)."""

    def body(x, mask):
        with annotate("mim.forward"):
            if amp:
                live = amp_cast(dict(model.named_parameters()))
                loss, _, _ = torch.func.functional_call(
                    model, live, (x.to(torch.bfloat16), mask, remat, routes))
            else:
                loss, _, _ = model(x, mask, remat, routes)
        with annotate("mim.backward"):
            grads = torch.autograd.grad(loss, optimizer.params)
            loss = loss.detach()
        with annotate("mim.optimizer"):
            gnorm = global_norm(grads)
            update(grads)
        return loss, gnorm

    return body


class GraphedStep:
    """The one-device step on CUDA as one CUDA graph. Call 1 runs the eager
    step (it warms the allocator, cuBLAS, autograd and the kernel library,
    and makes AdamW's state). Call 2 copies x and mask into buffers of its
    own, captures the step's device work (AMP cast, forward, backward,
    global norm, clip and AdamW at the rate in the optimizer's device
    tensor) on a side stream and replays it; every later call copies its
    inputs in, sets its update's rate and replays. Each call applies one
    update and returns fresh tensors (the graph's own outputs are rewritten
    by the next replay). A call whose inputs differ in shape or dtype from
    the captured ones raises ValueError. ``captures`` and ``replays``
    count the graph's. The graph holds the parameters' and the optimizer
    state's storage: neither may be replaced once it is captured."""

    def __init__(self, eager, body, optimizer):
        self.eager, self.body, self.optimizer = eager, body, optimizer
        self.graph, self.captures, self.replays = None, 0, 0
        self._called = False

    def __call__(self, x, mask):
        if not self._called:
            self._called = True
            return self.eager(x, mask)
        if self.graph is not None and (x.shape, x.dtype, mask.shape, mask.dtype) != self._inputs:
            raise ValueError(f"inputs {tuple(x.shape)} {x.dtype}, {tuple(mask.shape)} "
                             f"{mask.dtype} differ from the captured step's {self._inputs}")
        with annotate("mim.step"):
            with annotate("mim.inputs"):
                if self.graph is None:
                    self._x, self._mask = torch.empty_like(x), torch.empty_like(mask)
                    self._inputs = (x.shape, x.dtype, mask.shape, mask.dtype)
                self._x.copy_(x)
                self._mask.copy_(mask)
                self.optimizer.next_update()
            if self.graph is None:
                with annotate("mim.capture"):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        self._out = self.body(self._x, self._mask)
                self.graph = graph
                self.captures += 1
            with annotate("mim.replay"):
                self.graph.replay()
                self.replays += 1
                return tuple(t.clone() for t in self._out)


def make_train_step(model, optimizer, *, amp: bool = False, remat: bool = False,
                    routes: TrainRoutes = TrainRoutes(), layout=None):
    """step(x (B, H, W, 3), mask (B, gh, gw)) -> (loss, grad norm), both
    0-dim f32 tensors on the model's device; updates model and optimizer in
    place (every ACCUMULATION_STEPS-th call applies an update). ``routes``
    selects the opt-in kernel routes (:func:`train_routes`). With a
    ``layout`` (parallel.mesh.ParamLayout of a ('data', 'model') mesh; the
    model and optimizer hold the rank's pieces) x and mask are the rank's
    rows and the step is :func:`sharded_step`; a 'model' axis above 1 runs
    the blocks tensor-parallel (models.vit.block_forward_tp). One device
    with a capturable optimizer (AdamW on CUDA) and no accumulation takes
    :class:`GraphedStep`; else every call runs eagerly. Under a profiler an
    eager call runs inside a ``mim.step`` span, its work under
    ``mim.forward``, ``mim.backward`` and ``mim.optimizer``; a graphed call
    under ``mim.inputs`` and ``mim.replay``, the capturing call's
    ``mim.capture`` around the three (utils.profiling)."""
    if layout is not None:
        if layout.mesh.axis_size("model") > 1:
            routes = dataclasses.replace(routes, tp=par.TensorParallel(layout.mesh))

        def loss_fn(live, x, mask, pix_count):
            return torch.func.functional_call(model, live, (x, mask, remat, routes),
                                              {"pix_count": pix_count})[0]

        return sharded_step(model, optimizer, layout, loss_fn, amp=amp)

    kw = dict(amp=amp, remat=remat, routes=routes)
    body = _step_body(model, optimizer, optimizer.step, **kw)

    def step(x, mask):
        with annotate("mim.step"):
            return body(x, mask)

    if optimizer.capturable and optimizer.k == 1:
        return GraphedStep(step, _step_body(model, optimizer, optimizer.apply, **kw), optimizer)
    return step


# the JAX package's choices (models/vit.py _*_CHOICES)
MLP_REMAT_CHOICES = ("auto", "none", "gelu", "gelu+ln", "kernel", "kernel+gp", "kernel+h1")
LN_QKV_CHOICES = ("auto", "none", "kernel")
ATTN_SAVE_P_CHOICES = ("auto", "on", "off")


def train_routes(cfg) -> TrainRoutes:
    """The effective routes of cfg.TRAIN.MLP_REMAT, LN_QKV and ATTN_SAVE_P.
    "auto" is the JAX package's shipped default (the MLP kernel saving h1,
    LN_QKV off, saved P off); bare "kernel" is "kernel+h1"; "none", "gelu"
    and "gelu+ln" take the MLP remat routes. Raises ValueError on a value
    the JAX package does not accept."""
    tr = cfg.TRAIN
    mlp, ln_qkv, save_p = (str(tr.get(k, "auto")) for k in ("MLP_REMAT", "LN_QKV", "ATTN_SAVE_P"))
    for key, val, choices in (("MLP_REMAT", mlp, MLP_REMAT_CHOICES),
                              ("LN_QKV", ln_qkv, LN_QKV_CHOICES),
                              ("ATTN_SAVE_P", save_p, ATTN_SAVE_P_CHOICES)):
        if val not in choices:
            raise ValueError(f"TRAIN.{key}={val!r} not in {choices}")
    return TrainRoutes(mlp_save_gp=mlp == "kernel+gp", ln_qkv=ln_qkv == "kernel",
                       attn_save_p=save_p == "on",
                       mlp=mlp if mlp in MLP_REMAT_MODES else "kernel")


def mlp_remat_name(routes: TrainRoutes) -> str:
    """The effective TRAIN.MLP_REMAT of ``routes``, as the log shows it."""
    if routes.mlp != "kernel":
        return routes.mlp
    return "kernel+gp" if routes.mlp_save_gp else "kernel+h1"


def _log_mask_panels(wandb, model, img, mask, epoch):
    """The reference's per-epoch panels (mim.py:204-220): input, mask,
    masked input, reconstruction, masked reconstruction and complete
    reconstruction of the batch's first image, channel 0, from one f32
    forward of the master weights."""
    with torch.no_grad():
        _, x_rec, pix_mask = model(img, mask)
    inp = img[0, :, :, 0].float().cpu().numpy()
    pm = pix_mask[0, :, :, 0].float().cpu().numpy()
    rec = x_rec[0, :, :, 0].float().cpu().numpy()
    masked_input = inp * (1 - pm)
    wandb.log({"Masks": [
        wandb.Image(inp, caption="Input"),
        wandb.Image(pm, caption="Mask"),
        wandb.Image(masked_input, caption="Masked Input"),
        wandb.Image(rec, caption="Reconstruction"),
        wandb.Image(rec * pm, caption="Masked Reconstruction"),
        wandb.Image(rec * pm + masked_input, caption="Complete Reconstruction"),
    ]}, step=epoch)


def _run_eval(eval_fn, model, epoch):
    """eval_fn(encoder, epoch) in inference mode, the model's training mode
    restored afterwards."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            eval_fn(model.encoder, epoch)
    finally:
        model.train(was_training)


def _plain_model(model, layout, vit_cfg, device):
    """The whole model in the single-device layout: ``model`` itself unless
    the rank holds pieces, else a copy gathered from every rank (a
    collective: every rank calls it)."""
    if layout is None or not layout.sharded:
        return model
    plain = simmim.SimMIM(vit_cfg).to(device)
    plain.load_state_dict(layout.full_state(model))
    return plain


def _layout(cfg, model, mesh, pp_stages, fsdp, logger):
    """This rank's parallel.mesh.ParamLayout over ``mesh`` (None without
    one), the module sharded in place."""
    if mesh is None:
        return None
    if pp_stages > 1:
        from ..parallel import pp

        layout = pp.pp_layout(mesh, model)
    else:
        layout = par.param_layout(mesh, model, fsdp, int(cfg.TRAIN.get("FSDP_MIN_SHARD", 4096)))
    if fsdp:
        logger.info(f"FSDP over mesh {mesh.shape}: params + optimizer moments sharded "
                    f"over 'data'")
    layout.shard_module(model)
    return layout


# the first and last step (from 1) that train_mim's ``trace_dir`` traces
TRACED_STEPS = (2, 5)


def train_mim(cfg, loader, eval_fn=None, *, device, logger=None, use_wandb=False, wandb=None,
              mesh=None, trace_dir=""):
    """Pretrain a SimMIM ViT, initialized from cfg.SEED, on ``loader``'s
    batches. ``eval_fn(encoder, epoch)``, when given, runs after each
    epoch's checkpoint on the encoder (a ``models.vit.ViT``); with
    ``use_wandb``, ``wandb`` (utils/wandb_shim) takes the scalars and the
    per-epoch mask panels. ``mesh`` (parallel.mesh.make_mesh) trains over
    its ranks, data parallel, tensor parallel over a 'model' axis, or FSDP
    with TRAIN.FSDP; TRAIN.PP_STAGES > 1 makes its own ('data', 'pipe')
    mesh over the whole group. Every rank calls this with the same
    arguments; ``eval_fn`` and ``wandb`` are used on rank 0 only. With a
    ``trace_dir``, rank 0 writes a Chrome trace of the steps TRACED_STEPS
    (the loader's batches included) to ``trace_dir/trace.json``
    (utils.profiling.trace). Returns
    (model in the single-device layout, history of per-epoch mean
    losses)."""
    from ..utils.logger import create_logger

    routes = train_routes(cfg)
    main = par.is_main_process()
    logger = logger or create_logger(cfg.OUTPUT, dist_rank=par.process_rank(),
                                     name=f"{cfg.MODEL.NAME}_{cfg.MODEL.PATCH_SIZE}")
    logger.info(f"train kernel routes: MLP_REMAT={mlp_remat_name(routes)} "
                f"LN_QKV={'kernel' if routes.ln_qkv else None} "
                f"ATTN_SAVE_P={routes.attn_save_p}")
    pp_stages = int(cfg.TRAIN.get("PP_STAGES", 1))
    fsdp = bool(cfg.TRAIN.get("FSDP", False))
    if fsdp and (pp_stages > 1 or mesh is None or mesh.axis_size("data") <= 1):
        # FSDP shards over the mesh's 'data' axis; pp brings its own mesh and
        # stage-held state, and one rank has nothing to shard over
        logger.warning(
            "TRAIN.FSDP=True ignored: "
            + ("pipeline parallelism (TRAIN.PP_STAGES>1) already shards state over 'pipe' "
               "and the two modes do not compose" if pp_stages > 1 else
               "no multi-rank 'data' axis (single device run)"))
        fsdp = False
    micro = 1
    if pp_stages > 1:
        from ..parallel import pp

        world = par.world_size()
        if world % pp_stages:
            raise ValueError(f"TRAIN.PP_STAGES={pp_stages} does not divide {world} ranks")
        mesh = pp.make_pp_mesh(data=world // pp_stages, pipe=pp_stages)
        micro = int(cfg.TRAIN.get("PP_MICROBATCHES", 0)) or pp_stages
        logger.info(f"pipeline parallelism: mesh={mesh.shape} microbatches={micro}")
    device = torch.device(device)
    vit_cfg = simmim.mim_vit_config(cfg.DATA.IMG_SIZE, cfg.MODEL.PATCH_SIZE)
    model = simmim.init(vit_cfg, torch.Generator().manual_seed(cfg.SEED), device)
    if cfg.PRETRAINED_WEIGHTS:
        try:
            ckpt.load_mim_or_vit_checkpoint(cfg.PRETRAINED_WEIGHTS, model,
                                            cfg.MODEL.CHECKPOINT_KEY)
        except Exception as e:  # the reference's lenient load
            logger.info(f"could not load pretrained weights: {e}; training from scratch")

    start_epoch = cfg.TRAIN.START_EPOCH
    # the reference declares TRAIN.AUTO_RESUME but never reads it
    # (config.py:105); here, as in the JAX package, it resumes the model and
    # the optimizer state from the newest ckpt_epoch_* in OUTPUT. Checkpoints
    # hold the plain single-device layout; a pipeline run's are tagged with
    # its stage count, and the optimizer state resumes only into a run of the
    # same count (no tag: 1), else the parameters alone
    resume = ckpt.latest_checkpoint(cfg.OUTPUT) if cfg.TRAIN.AUTO_RESUME else None
    state = ckpt.read_checkpoint(resume) if resume is not None else None
    if state is not None:
        model.load_state_dict(state["model"])
        start_epoch = int(state["epoch"]) + 1
    if mesh is not None:
        logger.info(par.describe(mesh, device))
    layout = _layout(cfg, model, mesh, pp_stages, fsdp, logger)

    n_iter = len(loader)
    optimizer = Optimizer(cfg, model, build_schedule(cfg, max(n_iter, 1)))
    if layout is not None:
        optimizer.norm = layout.norm_fn(optimizer.names)
    if state is not None:
        if "optimizer" in state and int(state.get("pp_stages", 1)) == pp_stages:
            if layout is None:
                optimizer.load_state_dict(state["optimizer"])
            else:
                layout.load_full_optimizer_state(optimizer, state["optimizer"])
            logger.info(f"auto-resumed from {resume} at epoch {start_epoch} "
                        f"(optimizer updates {optimizer.updates})")
        else:
            logger.info(f"auto-resumed params from {resume} at epoch {start_epoch} "
                        f"(stage count or mode changed; optimizer state restarted)")

    amp, remat = cfg.AMP_OPT_LEVEL not in ("", "O0"), bool(cfg.TRAIN.USE_CHECKPOINT)
    if pp_stages > 1:
        step = pp.make_pp_train_step(model, optimizer, layout, micro, amp=amp, remat=remat,
                                     routes=routes)
    else:
        step = make_train_step(model, optimizer, amp=amp, remat=remat, routes=routes,
                               layout=layout)
    data = mesh.axis_size("data") if mesh is not None else 1
    logger.info(f"number of params: {sum(p.numel() for p in model.parameters())}")
    logger.info(f"Start training on {device} (amp={amp}, remat={remat})")
    history, min_loss, consec = [], float("inf"), 0
    start_time = time.time()
    n_steps = 0
    with exact_matmuls(), contextlib.ExitStack() as tracing:
        for epoch in range(start_epoch, cfg.TRAIN.EPOCHS):
            loss_meter, norm_meter, batch_time = AverageMeter(), AverageMeter(), AverageMeter()
            epoch_start = end = time.time()
            # loss and grad norm stay on the device between log points
            pending = []

            def drain():
                if not pending:
                    return
                for dl, dg, bsz in pending:
                    loss_meter.update(float(dl), bsz)
                    norm_meter.update(float(dg))
                batch_time.update((time.time() - end) / len(pending), len(pending))
                pending.clear()

            for idx, (img, mask) in enumerate(loader.epoch(epoch)):
                lr = optimizer.lr()
                img, mask = torch.as_tensor(img), torch.as_tensor(mask)
                if mesh is not None:
                    img, mask = par.local_rows(img, mesh), par.local_rows(mask, mesh)
                img, mask = img.to(device), mask.to(device)
                loss, gnorm = step(img, mask)
                pending.append((loss, gnorm, img.shape[0] * data))
                if idx % cfg.PRINT_FREQ == 0:
                    drain()
                    end = time.time()
                    etas = batch_time.avg * (n_iter - idx)
                    logger.info(
                        f"Train: [{epoch}/{cfg.TRAIN.EPOCHS}][{idx}/{n_iter}]\t"
                        f"eta {datetime.timedelta(seconds=int(etas))} lr {lr:.6f}\t"
                        f"time {batch_time.val:.4f} ({batch_time.avg:.4f})\t"
                        f"loss {loss_meter.val:.4f} ({loss_meter.avg:.4f})\t"
                        f"grad_norm {norm_meter.val:.4f} ({norm_meter.avg:.4f})")
                    if use_wandb and main:
                        wandb.log({"epoch": epoch, "train_loss": loss_meter.val,
                                   "train_loss_avg": loss_meter.avg, "lr": lr}, step=epoch)
                n_steps += 1
                if trace_dir and main:
                    if n_steps == TRACED_STEPS[0] - 1:
                        tracing.enter_context(profiling.trace(trace_dir))
                    elif n_steps == TRACED_STEPS[1]:
                        tracing.close()
            drain()
            logger.info(f"EPOCH {epoch} training takes "
                        f"{datetime.timedelta(seconds=int(time.time() - epoch_start))}")
            panels = use_wandb and loss_meter.count > 0
            plain = (_plain_model(model, layout, vit_cfg, device)
                     if panels or eval_fn is not None else model)
            if panels and main:
                _log_mask_panels(wandb, plain, img, mask, epoch)
            if epoch % cfg.SAVE_FREQ == 0 or epoch == cfg.TRAIN.EPOCHS - 1:
                if layout is None:
                    ckpt.save_checkpoint(cfg.OUTPUT, epoch, model, optimizer)
                else:
                    model_state = layout.full_state(model)
                    opt_state = layout.full_optimizer_state(optimizer)
                    tag = {"pp_stages": pp_stages} if pp_stages > 1 else {}
                    if main:
                        ckpt.write_checkpoint(cfg.OUTPUT, epoch, model_state, opt_state, **tag)
            if eval_fn is not None and main:
                _run_eval(eval_fn, plain, epoch)

            loss = loss_meter.avg
            history.append(loss)
            if loss < min_loss:
                min_loss, consec = loss, 0
            else:
                consec += 1
            logger.info(f"consecutive epochs = {consec}")
            if cfg.early_stopping and consec >= 4 and min_loss - loss < 1e-3:
                logger.info("Loss has not changed significantly in 4 epochs. "
                            "Stopping training early.")
                break
    logger.info(f"Training time {datetime.timedelta(seconds=int(time.time() - start_time))}")
    return _plain_model(model, layout, vit_cfg, device), history

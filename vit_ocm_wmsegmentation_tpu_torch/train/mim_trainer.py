"""MIM pretraining loop (the reference's mim.py:83-222) on one device.

Counterpart of ``vit_ocm_wmsegmentation_tpu/train/mim_trainer.py``:

* :func:`make_train_step` builds one step: forward and backward of the
  masked-L1 loss on the training kernels, the global norm of the gradients,
  then clip and AdamW (train/optim.py). It returns (loss, grad norm before
  clipping) as the JAX step reports them;
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
  ``pipeline.exact_matmuls()`` (no TF32, f32 reductions of bf16 products).

Not ported yet, and refused: TRAIN.PP_STAGES > 1 and TRAIN.FSDP.
"""

from __future__ import annotations

import datetime
import time

import torch

from ..models import simmim
from ..models.vit import MLP_REMAT_MODES, TrainRoutes
from ..ops.metrics import AverageMeter
from ..pipeline import exact_matmuls
from . import checkpoint as ckpt
from .optim import Optimizer, global_norm
from .schedule import build_schedule


def make_train_step(model, optimizer, *, amp: bool = False, remat: bool = False,
                    routes: TrainRoutes = TrainRoutes()):
    """step(x (B, H, W, 3), mask (B, gh, gw)) -> (loss, grad norm), both
    0-dim f32 tensors on the model's device; updates model and optimizer in
    place (every ACCUMULATION_STEPS-th call applies an update). ``routes``
    selects the opt-in kernel routes (:func:`train_routes`)."""
    def step(x, mask):
        if amp:
            live = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                    for n, p in model.named_parameters()}
            loss, _, _ = torch.func.functional_call(model, live,
                                                    (x.to(torch.bfloat16), mask, remat, routes))
        else:
            loss, _, _ = model(x, mask, remat, routes)
        grads = torch.autograd.grad(loss, optimizer.params)
        gnorm = global_norm(grads)
        optimizer.step(grads)
        return loss.detach(), gnorm

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


def _refuse_unported(cfg):
    tr = cfg.TRAIN
    if int(tr.get("PP_STAGES", 1)) > 1:
        raise NotImplementedError("TRAIN.PP_STAGES > 1 (pipeline parallelism) is not ported yet")
    if bool(tr.get("FSDP", False)):
        raise NotImplementedError("TRAIN.FSDP is not ported yet")


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


def train_mim(cfg, loader, eval_fn=None, *, device, logger=None, use_wandb=False, wandb=None):
    """Pretrain a SimMIM ViT, initialized from cfg.SEED, on ``loader``'s
    batches. ``eval_fn(encoder, epoch)``, when given, runs after each
    epoch's checkpoint on the encoder (a ``models.vit.ViT``); with
    ``use_wandb``, ``wandb`` (utils/wandb_shim) takes the scalars and the
    per-epoch mask panels. Returns (model, history of per-epoch mean
    losses)."""
    from ..utils.logger import create_logger

    _refuse_unported(cfg)
    routes = train_routes(cfg)
    logger = logger or create_logger(cfg.OUTPUT, name=f"{cfg.MODEL.NAME}_{cfg.MODEL.PATCH_SIZE}")
    logger.info(f"train kernel routes: MLP_REMAT={mlp_remat_name(routes)} "
                f"LN_QKV={'kernel' if routes.ln_qkv else None} "
                f"ATTN_SAVE_P={routes.attn_save_p}")
    device = torch.device(device)
    vit_cfg = simmim.mim_vit_config(cfg.DATA.IMG_SIZE, cfg.MODEL.PATCH_SIZE)
    model = simmim.init(vit_cfg, torch.Generator().manual_seed(cfg.SEED), device)
    if cfg.PRETRAINED_WEIGHTS:
        try:
            ckpt.load_mim_or_vit_checkpoint(cfg.PRETRAINED_WEIGHTS, model,
                                            cfg.MODEL.CHECKPOINT_KEY)
        except Exception as e:  # the reference's lenient load
            logger.info(f"could not load pretrained weights: {e}; training from scratch")

    n_iter = len(loader)
    optimizer = Optimizer(cfg, model, build_schedule(cfg, max(n_iter, 1)))
    start_epoch = cfg.TRAIN.START_EPOCH
    # the reference declares TRAIN.AUTO_RESUME but never reads it
    # (config.py:105); here, as in the JAX package, it resumes the model and
    # the optimizer state from the newest ckpt_epoch_* in OUTPUT
    resume = ckpt.latest_checkpoint(cfg.OUTPUT) if cfg.TRAIN.AUTO_RESUME else None
    if resume is not None:
        start_epoch = ckpt.restore_checkpoint(resume, model, optimizer) + 1
        logger.info(f"auto-resumed from {resume} at epoch {start_epoch} "
                    f"(optimizer updates {optimizer.updates})")

    amp, remat = cfg.AMP_OPT_LEVEL not in ("", "O0"), bool(cfg.TRAIN.USE_CHECKPOINT)
    step = make_train_step(model, optimizer, amp=amp, remat=remat, routes=routes)
    logger.info(f"number of params: {sum(p.numel() for p in model.parameters())}")
    logger.info(f"Start training on {device} (amp={amp}, remat={remat})")
    history, min_loss, consec = [], float("inf"), 0
    start_time = time.time()
    with exact_matmuls():
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
                img, mask = torch.as_tensor(img).to(device), torch.as_tensor(mask).to(device)
                loss, gnorm = step(img, mask)
                pending.append((loss, gnorm, img.shape[0]))
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
                    if use_wandb:
                        wandb.log({"epoch": epoch, "train_loss": loss_meter.val,
                                   "train_loss_avg": loss_meter.avg, "lr": lr}, step=epoch)
            drain()
            logger.info(f"EPOCH {epoch} training takes "
                        f"{datetime.timedelta(seconds=int(time.time() - epoch_start))}")
            if use_wandb and loss_meter.count > 0:
                _log_mask_panels(wandb, model, img, mask, epoch)
            if epoch % cfg.SAVE_FREQ == 0 or epoch == cfg.TRAIN.EPOCHS - 1:
                ckpt.save_checkpoint(cfg.OUTPUT, epoch, model, optimizer)
            if eval_fn is not None:
                _run_eval(eval_fn, model, epoch)

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
    return model, history

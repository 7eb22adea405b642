"""GPipe pipeline parallelism over the ViT block stack.

Counterpart of ``vit_ocm_wmsegmentation_tpu/parallel/pp.py``. A ('data',
'pipe') mesh: the batch's rows shard over 'data' as in data parallelism,
and rank s along 'pipe' holds blocks [s * depth/stages, (s+1) *
depth/stages) of the encoder (:func:`pp_layout`); the other blocks'
tensors are empty on it. The embedding, the final LayerNorm and the
decoder run on every stage.

The block stack runs as one autograd Function (:func:`pp_run_blocks`). Its
forward is the fill-drain schedule over microbatches: stage 0 feeds
microbatch m from the embedding, every other stage receives it from the
stage before, runs its blocks on the training kernels
(``models.vit.run_blocks_train(lo, hi)``) and sends the activation on; the
last stage gathers the finished microbatches and broadcasts them to every
stage. Its backward runs the drain in reverse: the last stage takes the
gradient of its own copy of the broadcast tokens (every stage computes the
same replicated loss, so one copy and not a sum), and each stage sends the
gradient of its input to the stage before. Sends and receives pair up in
microbatch order, so no stage waits on a message that comes later.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models import simmim
from ..models import vit as vit_mod
from .mesh import Mesh, ParamLayout, _make, broadcast, recv, send

# the SimMIM tensors before the blocks: their gradient is computed on stage
# 0 only, where the embedding feeds the pipeline
_EMBED = ("encoder.patch_embed.", "encoder.cls_token", "encoder.pos_embed", "encoder.mask_token")


def make_pp_mesh(data: int = 1, pipe: int = -1) -> Mesh:
    """('data', 'pipe') mesh over the whole group; pipe=-1 takes the rest."""
    return _make(("data", "pipe"), (data, pipe))


def _block_index(name: str):
    parts = name.split(".")
    if "blocks" in parts:
        i = parts.index("blocks")
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            return i, int(parts[i + 1])
    return None


def stage_bounds(depth: int, stages: int, s: int):
    """Blocks [lo, hi) of stage s; raises ValueError unless stages divide
    the depth."""
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by pp stages {stages}")
    per = depth // stages
    return s * per, (s + 1) * per


def pp_layout(mesh: Mesh, model: simmim.SimMIM) -> ParamLayout:
    """This rank's layout: its stage's blocks, and every other tensor held
    whole, the embedding's gradient owned by stage 0 and the rest's by the
    last stage."""
    stages = mesh.axis_size("pipe")
    stage_bounds(model.cfg.depth, stages, 0)  # raises on an indivisible depth
    per = model.cfg.depth // stages
    stage, owner = {}, {}
    for n, _ in model.named_parameters():
        b = _block_index(n)
        if b is not None:
            stage[n] = b[1] // per
        else:
            owner[n] = 0 if n.startswith(_EMBED) else stages - 1
    return ParamLayout(mesh, model, stage=stage, grad_owner=owner)


class _Pipeline(torch.autograd.Function):
    """The fill-drain pipeline over this stage's blocks (module docstring).
    Inputs: the embedded tokens and this stage's block tensors (those the
    forward reads, so that their gradients flow back to them); returns the
    finished tokens on every stage."""

    @staticmethod
    def forward(ctx, tok, encoder, mesh, microbatches, lo, hi, remat, routes, *held):
        s, last = mesh.index("pipe"), mesh.axis_size("pipe") - 1
        chunks = tok.detach().chunk(microbatches)
        ins, outs, sends = [], [], []
        with torch.enable_grad():
            for c in chunks:
                x = c if s == 0 else recv(c, mesh, "pipe", s - 1)
                x = x.detach().requires_grad_()
                y = vit_mod.run_blocks_train(encoder, x, remat, routes, lo, hi)
                if s < last:
                    sends.append(send(y, mesh, "pipe", s + 1))
                ins.append(x)
                outs.append(y)
        for h in sends:
            h.wait()
        out = torch.cat([y.detach() for y in outs]) if s == last else torch.empty_like(tok)
        broadcast(out, mesh, "pipe", last)
        ctx.mesh, ctx.ins, ctx.outs = mesh, ins, outs
        ctx.save_for_backward(*held)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, ins, outs = ctx.mesh, ctx.ins, ctx.outs
        held = ctx.saved_tensors
        s, last = mesh.index("pipe"), mesh.axis_size("pipe") - 1
        g_last = g.chunk(len(outs)) if s == last else None
        grads = [None] * len(held)
        g_in, sends = [], []
        for m, (x, y) in enumerate(zip(ins, outs)):
            gy = g_last[m].contiguous() if s == last else recv(y, mesh, "pipe", s + 1)
            res = torch.autograd.grad(y, [x, *held], gy, allow_unused=True)
            if s > 0:
                sends.append(send(res[0], mesh, "pipe", s - 1))
            else:
                g_in.append(res[0])
            grads = [a if b is None else (b if a is None else a + b)
                     for a, b in zip(grads, res[1:])]
        for h in sends:
            h.wait()
        ctx.ins = ctx.outs = None
        gtok = torch.cat(g_in) if s == 0 else torch.zeros_like(g)
        grads = [torch.zeros_like(h) if d is None else d for h, d in zip(held, grads)]
        return (gtok, None, None, None, None, None, None, None, *grads)


def pp_run_blocks(encoder: vit_mod.ViT, tok, mesh: Mesh, microbatches: int, remat: bool = False,
                  routes: vit_mod.TrainRoutes = vit_mod.TrainRoutes()):
    """The block stack as a GPipe pipeline over 'pipe': tok (B, N, D) ->
    (B, N, D) on every stage, differentiable. Raises ValueError unless
    ``microbatches`` divide B."""
    b = tok.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by microbatches {microbatches}")
    lo, hi = stage_bounds(encoder.cfg.depth, mesh.axis_size("pipe"), mesh.index("pipe"))
    held = [t for blk in encoder.blocks[lo:hi] for t in blk.parameters()]
    return _Pipeline.apply(tok, encoder, mesh, microbatches, lo, hi, remat, routes, *held)


def pp_mim_loss(model: simmim.SimMIM, x, mask, mesh: Mesh, microbatches: int,
                remat: bool = False, routes: vit_mod.TrainRoutes = vit_mod.TrainRoutes(),
                pix_count=None):
    """simmim.mim_loss with the block stack pipelined over 'pipe'."""
    _, h, w, _ = x.shape
    p = model.cfg.patch_size
    tok = simmim.embed_tokens(model, x, mask)
    tok = pp_run_blocks(model.encoder, tok, mesh, microbatches, remat, routes)
    x_rec = simmim.decode_grid(model, simmim.tokens_to_grid(model, tok, h // p, w // p))
    return simmim.masked_l1(x, x_rec, mask, p, pix_count)[0]


class _PPLoss(nn.Module):
    """pp_mim_loss as a module's forward, so that ``functional_call`` can
    run it on the AMP step's bf16 copies of the parameters."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, mask, mesh, microbatches, remat, routes, pix_count):
        return pp_mim_loss(self.model, x, mask, mesh, microbatches, remat, routes, pix_count)


def make_pp_train_step(model: simmim.SimMIM, optimizer, layout: ParamLayout, microbatches: int,
                       *, amp: bool = False, remat: bool = False,
                       routes: vit_mod.TrainRoutes = vit_mod.TrainRoutes()):
    """Pipeline-parallel twin of ``train.mim_trainer.make_train_step``:
    step(x, mask) on this rank's rows -> (global loss, global grad norm).
    ``model`` holds this stage's tensors (``layout.shard_module``) and
    ``optimizer`` was built over them with ``norm=layout.norm_fn(...)``."""
    from ..train.mim_trainer import sharded_step

    wrapper = _PPLoss(model)
    mesh = layout.mesh

    def loss_fn(live, x, mask, pix_count):
        live = {f"model.{n}": t for n, t in live.items()}
        return torch.func.functional_call(
            wrapper, live, (x, mask, mesh, microbatches, remat, routes, pix_count))

    return sharded_step(model, optimizer, layout, loss_fn, amp=amp)

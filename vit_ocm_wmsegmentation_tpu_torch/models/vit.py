"""DINO Vision Transformer as an nn.Module, with the inference path of the
mosaic pipeline.

Counterpart of ``vit_ocm_wmsegmentation_tpu/models/vit.py``. The module's
state-dict keys are timm/DINO's (``blocks.{i}.attn.qkv.weight`` ...), so a
reference ``.pth`` loads with ``load_state_dict`` once
``train/checkpoint.clean_torch_state_dict`` has stripped its prefixes. The
submodules only hold parameters: the forward is written with the port's
functional layers and kernels.

Inference path (:func:`cls_attention_grid`, and the analysis API below
it: :func:`forward_features`, :func:`get_intermediate_layers`,
:func:`get_intermediate_feat`, :func:`query_attention_rows`,
:func:`last_block_key_features`): patch embed as patchify + one
matmul; blocks 0..L-2 with the attention kernel and the fused MLP kernels,
where each block's MLP kernel also emits the next block's normalized input
(the JAX package's cross-layer "LN-out" route) and the last of them takes
the plain fused MLP; the last block reduces to the CLS-row softmax.
:class:`InferRoutes` (the CLIs' ``--infer_mlp`` and ``--quant``) selects the
fused MLP kernel per block or the stock MLP instead, and the int8
projections of ``ops/quant.py``, route for route as the JAX package's
``set_infer_mlp`` / ``set_infer_quant`` do.

DINOv2 (:data:`DINOV2_VITG14_REG`; :attr:`ViTConfig.block_kind` "dinov2"):
register tokens after CLS, a SwiGLU FFN, LayerScale on both residuals and
the antialiased positional interpolation, under DINOv2's state-dict keys.
Its inference blocks run the products on cuBLAS and, between and after
them, ``ops/swiglu.py``'s gate and LayerScale residual, each residual
emitting the next LayerNorm's input (:func:`_run_blocks_v2`); the CLS row
attends over the registers too, and the map keeps the patch columns.

Training path (:func:`run_blocks_train`, the JAX package's
``_scan_blocks(train=True)``): every block on the differentiable kernel
routes, the folded flash attention and the fused MLP block with its
backward kernel (``MLP_REMAT="kernel"``), optionally under
``torch.utils.checkpoint``. :class:`TrainRoutes` selects the opt-in kernel
routes the JAX package's ``set_train_kernel_modes`` sets as module globals:
the saved-P attention backward, the gelu / gelu' residuals of the MLP
block, and LN1 fused into the qkv projection; and the MLP remat routes
``MLP_REMAT`` "none", "gelu" and "gelu+ln", which the JAX package computes
in XLA, not in a kernel: the plain MLP (:func:`mlp_remat`), the three
differing only in what the backward keeps from the forward.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import nn as tnn
from ..ops import attention as att
from ..ops import flash_attention as fa
from ..ops import fused_mlp as fm
from ..ops import ln_linear as lnl
from ..ops import quant as qz
from ..ops import swiglu as sw
from ..ops.resize import bicubic_matrix
from ..utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 8
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    # image size the positional-embedding table is sized for (DINO pretrains
    # at 224; other sizes interpolate, vision_transformer.py:176)
    pretrain_img_size: int = 224
    # DINOv2 (facebookresearch/dinov2 models/vision_transformer.py): register
    # tokens between the CLS token and the patches, without positional
    # embedding; the FFN, "mlp" (fc1 -> GELU -> fc2) or "swiglu" (w12 ->
    # silu(a) * b -> w3, layers/swiglu_ffn.py); LayerScale on both residual
    # branches (ls1.gamma, ls2.gamma); the positional table's interpolation,
    # "dino" (bicubic A=-0.75, the scale from the grid plus 0.1) or
    # "antialias" (torch's antialiased bicubic to the grid's size, DINOv2's
    # interpolate_antialias=True, interpolate_offset=0). The defaults are DINO's.
    num_register_tokens: int = 0
    ffn: str = "mlp"
    layerscale: bool = False
    pos_interp: str = "dino"

    def __post_init__(self):
        if self.ffn not in ("mlp", "swiglu"):
            raise ValueError(f"ViTConfig.ffn {self.ffn!r} not in ('mlp', 'swiglu')")
        if self.pos_interp not in ("dino", "antialias"):
            raise ValueError(f"ViTConfig.pos_interp {self.pos_interp!r} not in "
                             f"('dino', 'antialias')")

    @property
    def pos_grid(self) -> int:
        return self.pretrain_img_size // self.patch_size

    @property
    def num_prefix_tokens(self) -> int:
        """Tokens before the patches: CLS and the registers."""
        return 1 + self.num_register_tokens

    @property
    def block_kind(self) -> str:
        """"dino" (pre-norm, GELU MLP, plain residuals) or "dinov2" (a
        SwiGLU FFN or LayerScale residuals)."""
        return "dinov2" if self.ffn == "swiglu" or self.layerscale else "dino"

    @property
    def ffn_hidden(self) -> int:
        """The FFN's hidden width: mlp_ratio * D, or for SwiGLU DINOv2's
        2/3 of it rounded up to a multiple of 8 (SwiGLUFFNFused)."""
        hidden = self.embed_dim * self.mlp_ratio
        return hidden if self.ffn == "mlp" else (int(hidden * 2 / 3) + 7) // 8 * 8

    @property
    def num_pos_tokens(self) -> int:
        return self.pos_grid * self.pos_grid + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


# factory configs mirroring vit_tiny/small/base (vision_transformer.py:259-279)
VIT_TINY = partial(ViTConfig, embed_dim=192, depth=12, num_heads=3)
VIT_SMALL = partial(ViTConfig, embed_dim=384, depth=12, num_heads=6)
VIT_BASE = partial(ViTConfig, embed_dim=768, depth=12, num_heads=12)
# DINOv2 ViT-g/14 with registers (dinov2/hub/backbones.py dinov2_vitg14_reg:
# vit_giant2, ffn_layer="swiglufused", num_register_tokens=4,
# interpolate_antialias=True, interpolate_offset=0.0; a 518^2 table)
DINOV2_VITG14_REG = partial(ViTConfig, patch_size=14, embed_dim=1536, depth=40, num_heads=24,
                            pretrain_img_size=518, num_register_tokens=4, ffn="swiglu",
                            layerscale=True, pos_interp="antialias")

ARCHS = {"vit_tiny": VIT_TINY, "vit_small": VIT_SMALL, "vit_base": VIT_BASE,
         "dinov2_vitg14_reg": DINOV2_VITG14_REG}


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.empty(cfg.embed_dim, 3, p, p))
        self.proj.bias = nn.Parameter(torch.empty(cfg.embed_dim))


class _Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.proj = nn.Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.fc1 = nn.Linear(d, cfg.ffn_hidden)
        self.fc2 = nn.Linear(cfg.ffn_hidden, d)


class _SwiGLU(nn.Module):
    """DINOv2's SwiGLUFFNFused: w12 (2H, D) holds both halves, w3 (D, H)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, h = cfg.embed_dim, cfg.ffn_hidden
        self.w12 = nn.Linear(d, 2 * h)
        self.w3 = nn.Linear(h, d)


class _LayerScale(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(cfg.embed_dim))


class _Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = _Attention(cfg)
        if cfg.layerscale:
            self.ls1 = _LayerScale(cfg)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.mlp = _SwiGLU(cfg) if cfg.ffn == "swiglu" else _Mlp(cfg)
        if cfg.layerscale:
            self.ls2 = _LayerScale(cfg)


class ViT(nn.Module):
    """Parameter container with the timm/DINO state-dict layout; a DINOv2
    configuration adds DINOv2's keys (``register_tokens``, ``mask_token``,
    ``blocks.{i}.ls{1,2}.gamma``, ``blocks.{i}.mlp.w12`` / ``w3``), so that a
    hub checkpoint loads with ``load_state_dict``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_pos_tokens, d))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        if cfg.block_kind == "dinov2":
            # DINOv2's iBOT mask token: in the state dict, unused at inference
            self.mask_token = nn.Parameter(torch.zeros(1, d))
        self.blocks = nn.ModuleList([_Block(cfg) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)


def _linears(blk):
    """The block's nn.Linear layers: qkv, proj and the FFN's two."""
    m = blk.mlp
    return (blk.attn.qkv, blk.attn.proj) + ((m.w12, m.w3) if hasattr(m, "w12") else (m.fc1, m.fc2))


def init(cfg: ViTConfig, generator: torch.Generator | None = None, device=None,
         requires_grad: bool = False) -> ViT:
    """A ViT with the reference's random init: trunc-normal(0.02) for the
    linear and patch-embed weights, positional embedding and CLS token;
    zeros for biases and LayerNorm biases, ones for LayerNorm scales. Drawn
    from ``generator`` on the CPU, then moved to ``device``. Parameters
    require gradients only with ``requires_grad`` (training). A DINOv2
    configuration takes DINOv2's init_weights for what it adds: the CLS and
    register tokens N(0, 1e-6), LayerScale at the hub's init_values 1, the
    mask token 0."""
    model = ViT(cfg)

    def tn(p):
        tnn.trunc_normal(p.data, generator=generator)

    with torch.no_grad():
        tn(model.patch_embed.proj.weight)
        model.patch_embed.proj.bias.zero_()
        if cfg.block_kind == "dinov2":
            model.cls_token.normal_(0.0, 1e-6, generator=generator)
        else:
            tn(model.cls_token)
        if cfg.num_register_tokens:
            model.register_tokens.normal_(0.0, 1e-6, generator=generator)
        tn(model.pos_embed)
        for blk in model.blocks:
            for lin in _linears(blk):
                tn(lin.weight)
                if lin.bias is not None:
                    lin.bias.zero_()
            for ln in (blk.norm1, blk.norm2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        model.norm.weight.fill_(1.0)
        model.norm.bias.zero_()
    model.requires_grad_(requires_grad)
    return model.to(device) if device is not None else model


def interpolate_pos_embed(pos, grid_hw):
    """Positional embeddings for a (gh, gw) patch grid, CLS row included:
    bicubic (A=-0.75) with the reference's ``+0.1`` on the scale factor
    (vision_transformer.py:176-196), as two matmuls. The source grid comes
    from the table's own size."""
    gh, gw = grid_hw
    g = math.isqrt(pos.shape[1] - 1)
    if gh == g and gw == g:
        return pos
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    d = pos.shape[-1]
    grid = patch_pos.reshape(g, g, d)
    my = torch.as_tensor(bicubic_matrix(g, gh, (gh + 0.1) / g), dtype=pos.dtype, device=pos.device)
    mx = torch.as_tensor(bicubic_matrix(g, gw, (gw + 0.1) / g), dtype=pos.dtype, device=pos.device)
    out = torch.einsum("oh,hwd->owd", my, grid)
    out = torch.einsum("ow,hwd->hod", mx, out)
    return torch.cat([cls_pos, out.reshape(1, gh * gw, d)], dim=1)


def interpolate_pos_embed_antialias(pos, grid_hw):
    """DINOv2's interpolate_pos_encoding (interpolate_antialias=True,
    interpolate_offset=0): the patch table in f32 through torch's
    antialiased bicubic (A=-0.5) to the (gh, gw) grid's size, the CLS row
    as it is, the result in the table's dtype; the table itself at its own
    grid."""
    gh, gw = grid_hw
    g = math.isqrt(pos.shape[1] - 1)
    if gh == g and gw == g:
        return pos
    d = pos.shape[-1]
    pos32 = pos.float()
    grid = pos32[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True)
    out = out.permute(0, 2, 3, 1).reshape(1, gh * gw, d)
    return torch.cat([pos32[:, :1], out], dim=1).to(pos.dtype)


def pos_embed_for(model: ViT, grid_hw):
    """The positional table for a (gh, gw) grid by the configuration's rule.
    A DINOv2 table ("antialias") is interpolated once per grid size and
    table, on the table's device, and kept on the model; tables that take
    gradients are interpolated every call."""
    pos = model.pos_embed
    if model.cfg.pos_interp == "dino":
        return interpolate_pos_embed(pos, grid_hw)
    if pos.requires_grad and torch.is_grad_enabled():
        return interpolate_pos_embed_antialias(pos, grid_hw)
    key = (tuple(grid_hw), pos.data_ptr(), pos._version, pos.dtype, pos.device)
    cache = model.__dict__.setdefault("_pos_cache", {})
    if key not in cache:
        cache.clear()
        with torch.no_grad():
            cache[key] = interpolate_pos_embed_antialias(pos, grid_hw)
    return cache[key]


def prepare_tokens(model: ViT, x, patch_hook=None):
    """(B, H, W, 3) image -> (B, 1 + R + gh*gw, D) tokens: CLS, then the R
    register tokens of a DINOv2 configuration (after the positional
    embedding, which they do not take), then the patches. ``patch_hook(tok)``
    transforms the (B, gh*gw, D) patch tokens before the CLS concat and the
    positional embedding (SimMIM's mask-token substitution,
    models/simmim.embed_tokens). The DINOv2 block kind runs inside the span
    ``vit.tokens``."""
    if model.cfg.block_kind == "dinov2":
        with annotate("vit.tokens"):
            return _prepare_tokens(model, x, patch_hook)
    return _prepare_tokens(model, x, patch_hook)


def _prepare_tokens(model: ViT, x, patch_hook):
    cfg = model.cfg
    b, h, w, _ = x.shape
    p, d = cfg.patch_size, cfg.embed_dim
    kernel = model.patch_embed.proj.weight.permute(2, 3, 1, 0).reshape(p * p * 3, d)
    tok = tnn.linear(tnn.patchify(x, p), kernel.T, model.patch_embed.proj.bias)
    if patch_hook is not None:
        tok = patch_hook(tok)
    cls = model.cls_token.to(tok.dtype).expand(b, 1, d)
    tok = torch.cat([cls, tok], dim=1)
    tok = tok + pos_embed_for(model, (h // p, w // p)).to(tok.dtype)
    if not cfg.num_register_tokens:
        return tok
    reg = model.register_tokens.to(tok.dtype).expand(b, cfg.num_register_tokens, d)
    return torch.cat([tok[:, :1], reg, tok[:, 1:]], dim=1)


def _mlp_args(blk):
    return (blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight, blk.mlp.fc1.bias,
            blk.mlp.fc2.weight, blk.mlp.fc2.bias)


INFER_MLP_CHOICES = ("auto", "none", "kernel", "lnout")
QUANT_CHOICES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class InferRoutes:
    """The inference path's routes, the JAX package's ``set_infer_mlp`` /
    ``set_infer_quant`` module globals carried as an argument:

    * mlp: "lnout" (the default: the cross-layer fused MLP kernel emitting the
      next block's LN input), "kernel" (the fused MLP kernel per block) or
      "none" (the stock MLP in plain torch, exact erf);
    * quant: None, or "int8" for the W8A8 projections of ops/quant.py.

    The "dinov2" block kind (:attr:`ViTConfig.block_kind`) reads "lnout" as
    its own kernel route, the products on cuBLAS and ops/swiglu.py's gate
    and LayerScale residual, each residual emitting the next LayerNorm's
    input; "none" as the plain torch chain; "kernel" and int8 raise (the
    fused GELU MLP kernel and the int8 projections take the DINO block).

    With int8 the routes follow the JAX package's table
    (``vit.py:536-560, 598-624, 671-684``): "lnout" quantizes the attention
    projections and keeps the fused MLP kernel in full precision (its gate
    does not read the quant mode); "kernel" and "none" take the stock MLP with
    both products in int8. The last block's CLS row is never quantized."""

    mlp: str = "lnout"
    quant: str | None = None

    def __post_init__(self):
        if self.mlp not in ("lnout", "kernel", "none"):
            raise ValueError(f"InferRoutes.mlp {self.mlp!r} not in ('lnout', 'kernel', 'none')")
        if self.quant not in (None, "int8"):
            raise ValueError(f"InferRoutes.quant {self.quant!r} not in (None, 'int8')")


def infer_routes(infer_mlp: str = "auto", quant: str = "none",
                 cfg: ViTConfig | None = None) -> InferRoutes:
    """InferRoutes from the CLIs' --infer_mlp and --quant for the model of
    ``cfg``: auto = lnout, the JAX package's shipped route, where a kernel
    route exists (the DINO block at a width in ops.fused_mlp.KERNEL_WIDTHS,
    the DINOv2 block at any), else the stock MLP ("none"). The DINOv2 block
    kind has no int8 route: quant="int8" raises here. Without ``cfg`` a
    width the kernels take is assumed."""
    if infer_mlp not in INFER_MLP_CHOICES:
        raise ValueError(f"infer mlp mode {infer_mlp!r} not in {INFER_MLP_CHOICES}")
    if quant not in QUANT_CHOICES:
        raise ValueError(f"infer quant mode {quant!r} not in {QUANT_CHOICES}")
    v2 = cfg is not None and cfg.block_kind == "dinov2"
    if v2 and quant == "int8":
        raise ValueError("--quant int8 takes the DINO block; the DINOv2 block kind "
                         "(SwiGLU FFN, LayerScale) has no int8 route")
    mlp = infer_mlp
    if infer_mlp == "auto":
        stock = cfg is not None and not v2 and cfg.embed_dim not in fm.KERNEL_WIDTHS
        mlp = "none" if stock else "lnout"
    return InferRoutes(mlp, None if quant == "none" else quant)


def _int8_key(model: ViT):
    return tuple((p.data_ptr(), p._version, p.dtype) for blk in model.blocks
                 for p in (blk.attn.qkv.weight, blk.attn.proj.weight, blk.mlp.fc1.weight,
                           blk.mlp.fc2.weight))


@torch.no_grad()
def int8_weights(model: ViT):
    """Per block, the int8 route's weights quantized once per model (the JAX
    package folds them as jit constants): "qkv", the qkv weight with 1/sqrt(d)
    folded into its q rows, and "qkv_bias", its f32 bias; "proj", "fc1",
    "fc2". Each is ops.quant.colwise_int8's (int8, scale) pair of the weight
    in its current dtype. Cached on the model; quantized again only when a
    weight was replaced, moved, cast or written to."""
    key = _int8_key(model)
    cached = model.__dict__.get("_int8_cache")
    if cached is not None and cached[0] == key:
        return cached[1]
    heads = model.cfg.num_heads
    out = []
    for blk in model.blocks:
        wq, bq = fa._scaled_qkv_weights(blk.attn.qkv.weight, blk.attn.qkv.bias, heads)
        out.append({"qkv": qz.colwise_int8(wq), "qkv_bias": bq,
                    "proj": qz.colwise_int8(blk.attn.proj.weight),
                    "fc1": qz.colwise_int8(blk.mlp.fc1.weight),
                    "fc2": qz.colwise_int8(blk.mlp.fc2.weight)})
    model.__dict__["_int8_cache"] = (key, out)
    return out


def _linear(x, weight, bias):
    """nn.linear of the JAX package: f32 accumulation, the bias added in f32,
    one cast to x's dtype."""
    y = x.float() @ weight.float().T
    return (y + bias.float() if bias is not None else y).to(x.dtype)


def swiglu_plain(m, h):
    """DINOv2's SwiGLU FFN in plain torch (layers/swiglu_ffn.py): w12, then
    silu(x1) * x2 of its two halves, then w3, each step in h's dtype."""
    a, b = F.linear(h, m.w12.weight, m.w12.bias).chunk(2, dim=-1)
    return F.linear(F.silu(a) * b, m.w3.weight, m.w3.bias)


def mlp_forward(blk, cfg: ViTConfig, x, int8=None):
    """The stock LN2 -> fc1 -> GELU -> fc2 branch of a block (the JAX
    package's ``_mlp_forward`` on inference), without the residual; a SwiGLU
    block's LN2 -> :func:`swiglu_plain`, without LayerScale. With ``int8`` (a
    block of :func:`int8_weights`) both products run as ops.quant.int8_dot;
    LN, GELU and the biases stay float."""
    h = tnn.layer_norm(x, blk.norm2.weight, blk.norm2.bias, cfg.ln_eps)
    m = blk.mlp
    if cfg.ffn == "swiglu":
        return swiglu_plain(m, h)
    if int8 is None:
        return _linear(tnn.gelu(_linear(h, m.fc1.weight, m.fc1.bias)), m.fc2.weight, m.fc2.bias)
    h = qz.int8_dot(h, int8["fc1"], m.fc1.bias.float(), x.dtype)
    return qz.int8_dot(tnn.gelu(h), int8["fc2"], m.fc2.bias.float(), x.dtype)


def _attention(blk, cfg: ViTConfig, h, int8):
    a = blk.attn
    return fa.mha_flash(h, a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias, cfg.num_heads,
                        quant=int8 is not None, int8=int8)


def _ls(blk, name, y):
    """y scaled by the block's LayerScale ``name`` ("ls1", "ls2"), if any."""
    ls = getattr(blk, name, None)
    return y if ls is None else y * ls.gamma.to(y.dtype)


def _ffn_rows(m, h):
    """The DINOv2 block's FFN over rows h (R, D) on the kernel route: the
    products on cuBLAS (f32 accumulation, the bias in the epilogue), the
    SwiGLU gate in ops/swiglu.py's kernel; a GELU MLP in plain torch."""
    if hasattr(m, "w12"):
        return F.linear(sw.swiglu_gate(F.linear(h, m.w12.weight, m.w12.bias)), m.w3.weight,
                        m.w3.bias)
    return F.linear(F.gelu(F.linear(h, m.fc1.weight, m.fc1.bias)), m.fc2.weight, m.fc2.bias)


def _gamma(blk, name, d, like):
    ls = getattr(blk, name, None)
    return ls.gamma if ls is not None else torch.ones(d, dtype=like.dtype, device=like.device)


def _run_blocks_v2(model: ViT, tok, hi: int, routes: InferRoutes, lo: int, emit):
    """Blocks [lo, hi) of the DINOv2 kind (x + ls1(attn(LN1 x)); x +
    ls2(ffn(LN2 x))), each FFN branch and its residual inside the span
    ``vit.ffn``; returns (tok, LN ``emit`` of tok or None). On "lnout" each
    residual is ops.swiglu.layerscale_norm, which emits the next LayerNorm's
    input (LN2 after the attention, the next block's LN1 after the FFN, and
    ``emit`` after block hi-1), so that only block lo's LN1 runs on its own.
    On "none" the plain torch chain."""
    cfg = model.cfg
    if routes.quant is not None:
        raise ValueError("the DINOv2 block kind has no int8 route")
    if routes.mlp == "kernel":
        raise ValueError("InferRoutes.mlp 'kernel' is the fused GELU MLP kernel of the DINO "
                         "block; the DINOv2 block kind takes 'lnout' (auto) or 'none'")
    b, n, d = tok.shape
    eps = cfg.ln_eps
    if hi <= lo:
        return tok, None
    if routes.mlp == "none":
        for i in range(lo, hi):
            blk = model.blocks[i]
            h = tnn.layer_norm(tok, blk.norm1.weight, blk.norm1.bias, eps)
            tok = tok + _ls(blk, "ls1", _attention(blk, cfg, h, None))
            with annotate("vit.ffn"):
                tok = tok + _ls(blk, "ls2", mlp_forward(blk, cfg, tok))
        z = None if emit is None else tnn.layer_norm(tok, emit.weight, emit.bias, eps)
        return tok, z
    first = model.blocks[lo].norm1
    rows = tok.reshape(b * n, d)
    h = tnn.layer_norm(rows, first.weight, first.bias, eps)
    for i in range(lo, hi):
        blk = model.blocks[i]
        y = _attention(blk, cfg, h.reshape(b, n, d), None).reshape(b * n, d)
        rows, h = sw.layerscale_norm(rows, y, _gamma(blk, "ls1", d, y), blk.norm2.weight,
                                     blk.norm2.bias, eps)
        with annotate("vit.ffn"):
            y = _ffn_rows(blk.mlp, h)
            nxt = model.blocks[i + 1].norm1 if i + 1 < hi else emit
            g2 = _gamma(blk, "ls2", d, y)
            if nxt is None:
                rows = (rows.float() + g2.float() * y.float()).to(rows.dtype)
            else:
                rows, h = sw.layerscale_norm(rows, y, g2, nxt.weight, nxt.bias, eps)
    return rows.reshape(b, n, d), None if emit is None else h.reshape(b, n, d)


def run_blocks(model: ViT, tok, hi: int, routes: InferRoutes = InferRoutes(), lo: int = 0,
               emit=None):
    """Blocks [lo, hi) on the inference routes (the JAX package's
    ``_scan_blocks(lo, hi)``). On "lnout" each block's MLP kernel emits the
    next block's normalized input z, so only block lo's LN1 runs on its own,
    and block hi-1 takes the plain fused MLP, so that no z leaks past hi; on
    "kernel" every block runs LN1 and the fused MLP kernel; on "none", and
    on "kernel" with int8, the stock MLP (:func:`mlp_forward`). The DINOv2
    block kind runs :func:`_run_blocks_v2`.

    With ``emit`` (a LayerNorm module: the next block's norm1, or the final
    norm) returns (tok, emit's LayerNorm of tok): the DINOv2 kind's last
    residual kernel emits it, the DINO kind computes it after the blocks."""
    cfg = model.cfg
    if cfg.block_kind == "dinov2":
        tok, z = _run_blocks_v2(model, tok, hi, routes, lo, emit)
        if emit is None:
            return tok
        return tok, z if z is not None else tnn.layer_norm(tok, emit.weight, emit.bias,
                                                           cfg.ln_eps)
    tok = _run_blocks_dino(model, tok, hi, routes, lo)
    if emit is None:
        return tok
    return tok, tnn.layer_norm(tok, emit.weight, emit.bias, cfg.ln_eps)


def _run_blocks_dino(model: ViT, tok, hi: int, routes: InferRoutes, lo: int):
    cfg = model.cfg
    if hi <= lo:
        return tok
    b, n, d = tok.shape
    q8 = int8_weights(model) if routes.quant == "int8" else None

    def int8_of(i):
        return q8[i] if q8 is not None else None

    if routes.mlp == "lnout":
        first = model.blocks[lo].norm1
        h = tnn.layer_norm(tok, first.weight, first.bias, cfg.ln_eps)
        for i in range(lo, hi):
            blk = model.blocks[i]
            tok = tok + _attention(blk, cfg, h, int8_of(i))
            rows = tok.reshape(b * n, d)
            if i + 1 < hi:
                nxt = model.blocks[i + 1].norm1
                rows, z = fm.fused_mlp_block_lnout(rows, *_mlp_args(blk), nxt.weight, nxt.bias,
                                                   cfg.ln_eps)
                h = z.reshape(b, n, d)
            else:
                rows = fm.fused_mlp_block(rows, *_mlp_args(blk), cfg.ln_eps)
            tok = rows.reshape(b, n, d)
        return tok
    for i in range(lo, hi):
        blk = model.blocks[i]
        h = tnn.layer_norm(tok, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
        tok = tok + _attention(blk, cfg, h, int8_of(i))
        if routes.mlp == "kernel" and q8 is None:
            tok = fm.fused_mlp_block(tok.reshape(b * n, d), *_mlp_args(blk),
                                     cfg.ln_eps).reshape(b, n, d)
        else:
            tok = tok + mlp_forward(blk, cfg, tok, int8_of(i))
    return tok


MLP_REMAT_MODES = ("none", "gelu", "gelu+ln")


def _mlp_stock(x, scale, bias, w1, b1, w2, b2, eps):
    """LN2 -> fc1 -> GELU -> fc2 of rows x (R, D), without the residual: the
    JAX package's ``_mlp_forward`` in the compute dtype (library products
    with f32 accumulation, exact-erf GELU)."""
    h = F.layer_norm(x, (x.shape[-1],), scale, bias, eps)
    return F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2)


class _MLPRemat(torch.autograd.Function):
    """:func:`_mlp_stock` with a backward that keeps less: h1 = fc1(ln2(x))
    and LayerNorm's row statistics always, ln2(x) unless ``drop_ln``; never
    gelu(h1), which the backward recomputes from h1 (and ln2(x) from x with
    ``drop_ln``). The backward runs the same library operations as stock
    autograd of :func:`_mlp_stock` (gelu_backward, the products of linear's
    backward, native_layer_norm_backward)."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, eps, drop_ln):
        d = x.shape[-1]
        h, mean, rstd = torch.native_layer_norm(x, (d,), scale, bias, eps)
        h1 = F.linear(h, w1, b1)
        y = F.linear(F.gelu(h1), w2, b2)
        ctx.save_for_backward(x, scale, bias, w1, w2, mean, rstd, h1, None if drop_ln else h)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, w1, w2, mean, rstd, h1, h = ctx.saved_tensors
        d = x.shape[-1]
        if h is None:  # "gelu+ln": ln2(x) again, the same bits as the forward's
            h = torch.native_layer_norm(x, (d,), scale, bias, ctx.eps)[0]
        g = F.gelu(h1)
        dg = dy @ w2
        dw2, db2 = dy.T @ g, dy.sum(0)
        del g
        dh1 = torch.ops.aten.gelu_backward(dg, h1)
        del dg
        dh = dh1 @ w1
        dw1, db1 = dh1.T @ h, dh1.sum(0)
        del dh1
        dx, dscale, dbias = torch.ops.aten.native_layer_norm_backward(
            dh, x, (d,), mean, rstd, scale, bias, [True, True, True])
        return dx, dscale, dbias, dw1, db1, dw2, db2, None, None


def mlp_remat(x, scale, bias, w1, b1, w2, b2, eps, mode):
    """The MLP branch of rows x (R, D), without the residual, on an MLP
    remat route (the JAX package's ``_mlp_forward`` under ``_MLP_POLICIES``,
    vit.py:415-456), the weights in nn.Linear's layouts:

    * "none": stock autograd, which keeps ln2(x), h1 and gelu(h1);
    * "gelu": gelu(h1) is not kept, the backward recomputes it from h1;
    * "gelu+ln": ln2(x) is not kept either, recomputed from x.

    The three compute the same function and, on one device, the same
    gradients; only the memory the backward holds differs."""
    if mode == "none":
        return _mlp_stock(x, scale, bias, w1, b1, w2, b2, eps)
    if mode not in ("gelu", "gelu+ln"):
        raise ValueError(f"MLP remat mode {mode!r} not in {MLP_REMAT_MODES}")
    return _MLPRemat.apply(x, scale, bias, w1, b1, w2, b2, eps, mode == "gelu+ln")


@dataclasses.dataclass(frozen=True)
class TrainRoutes:
    """The training path's opt-in kernel routes (the JAX package's
    fused_mlp.SAVE_GP, flash_attention.SAVE_P and vit.LN_QKV), each off by
    default as the JAX package ships them:

    * mlp_save_gp: the MLP block saves g = gelu(h1) and gelu'(h1) instead of
      h1, so its backward computes no erf or exp (MLP_REMAT="kernel+gp");
    * ln_qkv: LN1 fused into the qkv projection (:func:`ln_qkv_attention`,
      LN_QKV="kernel");
    * attn_save_p: the attention forward saves P and 1/denominator, its
      backward reads them instead of recomputing exp (ATTN_SAVE_P="on");
    * mlp: "kernel", or an MLP remat route ("none", "gelu", "gelu+ln") in
      place of the fused MLP kernels (mlp_save_gp then has no effect)."""

    mlp_save_gp: bool = False
    ln_qkv: bool = False
    attn_save_p: bool = False
    # the MLP branch: "kernel" (the fused MLP kernels, the default) or one
    # of the JAX package's XLA remat routes, "none", "gelu" or "gelu+ln"
    # (:func:`mlp_remat`)
    mlp: str = "kernel"
    # tensor parallelism: a parallel.mesh.TensorParallel over the mesh's
    # 'model' axis, or None; with it every block takes block_forward_tp and
    # the routes above do not apply
    tp: object = None

    def __post_init__(self):
        if self.mlp not in ("kernel",) + MLP_REMAT_MODES:
            raise ValueError(f"TrainRoutes.mlp {self.mlp!r} not in "
                             f"{('kernel',) + MLP_REMAT_MODES}")


def ln_qkv_attention(blk, cfg: ViTConfig, x, save_p: bool = False):
    """The attention branch with LN1 fused into the qkv projection (the JAX
    package's ``_ln_qkv_attention``): :func:`ops.ln_linear.ln_linear_trainable`
    (the product and the bias summed in f32 and rounded once), then the
    folded flash attention and the out projection."""
    b, n, d = x.shape
    a = blk.attn
    bias = a.qkv.bias
    if bias is None:
        bias = torch.zeros(3 * d, dtype=a.qkv.weight.dtype, device=x.device)
    qkv = lnl.ln_linear_trainable(x.reshape(b * n, d), blk.norm1.weight, blk.norm1.bias,
                                  a.qkv.weight, bias, cfg.ln_eps)
    return fa.attend_and_project(qkv.reshape(b, n, 3 * d), a.proj.weight, a.proj.bias,
                                 cfg.num_heads, save_p)


def block_forward_train(blk, cfg: ViTConfig, x, routes: TrainRoutes = TrainRoutes()):
    """One pre-norm block on the differentiable kernel routes
    (vision_transformer.py:94-114; the JAX package's
    ``_block_forward(train=True)`` with ``MLP_REMAT="kernel"``), the opt-in
    routes as ``routes`` selects them."""
    b, n, d = x.shape
    a = blk.attn
    if routes.ln_qkv:
        y = ln_qkv_attention(blk, cfg, x, routes.attn_save_p)
    else:
        h = tnn.layer_norm(x, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
        y = fa.mha_flash(h, a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias, cfg.num_heads,
                         prefer_folded=True, save_p=routes.attn_save_p)
    x = x + y
    if routes.mlp != "kernel":
        return x + mlp_remat(x.reshape(b * n, d), *_mlp_args(blk), cfg.ln_eps,
                             routes.mlp).reshape(b, n, d)
    out = fm.fused_mlp_block_trainable(x.reshape(b * n, d), *_mlp_args(blk), cfg.ln_eps,
                                       routes.mlp_save_gp)
    return out.reshape(b, n, d)


def block_forward_tp(blk, cfg: ViTConfig, x, tp):
    """One block under tensor parallelism over ``tp.size`` ranks (the
    Megatron split of parallel.mesh.vit_param_sharding: this rank holds
    cfg.num_heads / tp.size heads of qkv and their columns of proj, and
    its slice of fc1's rows and fc2's columns). The stock routes, as the JAX
    package takes for tp > 1: the materialized attention of ops/attention.mha
    and the plain MLP of :func:`_mlp_stock`, each row-split product's partial
    sums summed over the ranks before its bias and the residual. The fused
    MLP kernel cannot take the split: fc2's partial sums have to be summed
    before the residual and the next LayerNorm."""
    heads = cfg.num_heads // tp.size
    a, m = blk.attn, blk.mlp
    h = tp.enter(tnn.layer_norm(x, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps))
    y = att.mha(h, a.qkv.weight, a.qkv.bias, a.proj.weight, torch.zeros_like(a.proj.bias), heads)
    x = x + (tp.exit(y) + a.proj.bias.to(x.dtype))
    h = tp.enter(F.layer_norm(x, (x.shape[-1],), blk.norm2.weight, blk.norm2.bias, cfg.ln_eps))
    y = F.linear(F.gelu(F.linear(h, m.fc1.weight, m.fc1.bias)), m.fc2.weight)
    return x + (tp.exit(y) + m.fc2.bias.to(x.dtype))


def run_blocks_train(model: ViT, tok, remat: bool = False, routes: TrainRoutes = TrainRoutes(),
                     lo: int = 0, hi: int | None = None):
    """Blocks [lo, hi) (all by default) on the training route, the stream
    unpadded. ``remat`` (TRAIN.USE_CHECKPOINT) recomputes each block's
    activations in the backward (torch.utils.checkpoint), trading FLOPs for
    memory; ``routes`` selects the opt-in kernel routes, or with
    ``routes.tp`` the tensor-parallel blocks (:func:`block_forward_tp`)."""
    if routes.tp is not None:
        fwd, arg = block_forward_tp, routes.tp
    else:
        fwd, arg = block_forward_train, routes
    for blk in model.blocks[lo:hi]:
        if remat:
            tok = torch.utils.checkpoint.checkpoint(fwd, blk, model.cfg, tok, arg,
                                                    use_reentrant=False)
        else:
            tok = fwd(blk, model.cfg, tok, arg)
    return tok


@torch.inference_mode()
def cls_attention_grid(model: ViT, x, routes: InferRoutes = InferRoutes()):
    """Last-block CLS-row attention as a patch grid: (B, H, W, 3) ->
    (B, h, gh, gw), i.e. attn[:, :, 0, 1:] of the reference's last block
    (utils.py:229-233), without any N x N matrix. ``routes`` selects the
    inference routes of blocks 0..L-2; the CLS row is never quantized. With
    register tokens the row attends over CLS, registers and patches, and the
    grid keeps the patch columns (attn[:, :, 0, 1 + R:]). Runs inside the
    span ``vit.cls_attention_grid`` (utils.profiling)."""
    with annotate("vit.cls_attention_grid"):
        cfg = model.cfg
        b, hgt, wdt, _ = x.shape
        gh, gw = hgt // cfg.patch_size, wdt // cfg.patch_size
        h, last = _last_block_input(model, x, routes)
        row = att.cls_row_attention(h, last.attn.qkv.weight, last.attn.qkv.bias, cfg.num_heads)
        return row[:, :, cfg.num_prefix_tokens:].reshape(b, cfg.num_heads, gh, gw)


# ---------------------------------------------------------------------------
# The analysis API (vision_transformer.py:211-256 of the reference): the
# blocks before the ones a function reads run through run_blocks, so on the
# inference routes' kernels. Its outputs hold the CLS and the patch tokens
# (N+1), as the reference's: a DINOv2 model's register tokens are dropped
# from them (they stay in every computation's keys)
# ---------------------------------------------------------------------------


def _final_norm(model: ViT, tok):
    return tnn.layer_norm(tok, model.norm.weight, model.norm.bias, model.cfg.ln_eps)


def _drop_registers(model: ViT, t, dim: int):
    """t without the register tokens along ``dim`` (token order CLS,
    registers, patches)."""
    r = model.cfg.num_register_tokens
    if not r:
        return t
    n = t.shape[dim]
    return torch.cat([t.narrow(dim, 0, 1), t.narrow(dim, 1 + r, n - 1 - r)], dim=dim)


def _last_block_input(model: ViT, x, routes: InferRoutes):
    """LN1 of the last block over the tokens blocks [0, depth-1) give (the
    DINOv2 kind's last residual kernel emits it)."""
    cfg = model.cfg
    last = model.blocks[cfg.depth - 1]
    _, h = run_blocks(model, prepare_tokens(model, x), cfg.depth - 1, routes, emit=last.norm1)
    return h, last


@torch.inference_mode()
def forward_features(model: ViT, x, routes: InferRoutes = InferRoutes()):
    """Every block and the final LayerNorm: (B, H, W, 3) -> (B, N+1, D)
    (the reference's forward_feats, :218-223; DINOv2's x_norm_clstoken and
    x_norm_patchtokens, its x_norm_regtokens dropped)."""
    _, z = run_blocks(model, prepare_tokens(model, x), model.cfg.depth, routes, emit=model.norm)
    return _drop_registers(model, z, 1)


@torch.inference_mode()
def forward_cls(model: ViT, x, routes: InferRoutes = InferRoutes()):
    """The CLS embedding (B, D), the reference's ``forward`` (:211-216)."""
    return forward_features(model, x, routes)[:, 0]


@torch.inference_mode()
def get_intermediate_layers(model: ViT, x, n: int = 1, routes: InferRoutes = InferRoutes()):
    """The final-normed tokens of the last n blocks (:248-256), stacked
    (n, B, N+1, D). Blocks [0, depth-n) run as one span of run_blocks, then
    each of the last n as a span of its own, so on "lnout" the last block of
    every span takes the plain fused MLP kernel."""
    cfg = model.cfg
    tok = run_blocks(model, prepare_tokens(model, x), cfg.depth - n, routes)
    outs = []
    for i in range(cfg.depth - n, cfg.depth):
        tok = run_blocks(model, tok, i + 1, routes, lo=i)
        outs.append(_drop_registers(model, _final_norm(model, tok), 1))
    return torch.stack(outs)


@torch.inference_mode()
def get_intermediate_feat(model: ViT, x, n: int = 1, routes: InferRoutes = InferRoutes()):
    """The reference's get_intermediate_feat (:225-237): for the last n
    blocks, (feats (n, B, N+1, D) final-normed, attns (n, B, h, N+1, N+1)
    materialized probabilities, qkvs (n, 3, B, h, N+1, head_dim)). Blocks
    [0, depth-n) take the inference routes; the last n the stock
    materialized attention (ops.attention.mha) and the stock MLP, as the
    JAX package computes them outside its kernels."""
    cfg = model.cfg
    tok = run_blocks(model, prepare_tokens(model, x), cfg.depth - n, routes)
    feats, attns, qkvs = [], [], []
    for i in range(cfg.depth - n, cfg.depth):
        blk = model.blocks[i]
        a = blk.attn
        h = tnn.layer_norm(tok, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
        y, attn, qkv = att.mha(h, a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
                               cfg.num_heads, return_attn=True)
        tok = tok + _ls(blk, "ls1", y)
        tok = tok + _ls(blk, "ls2", mlp_forward(blk, cfg, tok))
        feats.append(_drop_registers(model, _final_norm(model, tok), 1))
        attns.append(_drop_registers(model, _drop_registers(model, attn, 2), 3))
        qkvs.append(_drop_registers(model, qkv, 3))
    return torch.stack(feats), torch.stack(attns), torch.stack(qkvs)


@torch.inference_mode()
def get_last_selfattention(model: ViT, x, routes: InferRoutes = InferRoutes()):
    """The last block's materialized attention (B, h, N+1, N+1) (:239-246)."""
    return get_intermediate_feat(model, x, 1, routes)[1][0]


def _qk_rows(h, weight, bias, part):
    """One third of the qkv projection (part 0 = q, 1 = k) of h: the
    product accumulated in f32 and rounded to h's dtype, then its bias, as
    the JAX package adds it."""
    d = h.shape[-1]
    y = (h.float() @ weight[part * d : (part + 1) * d].float().T).to(h.dtype)
    return y + bias[part * d : (part + 1) * d].to(h.dtype) if bias is not None else y


@torch.inference_mode()
def query_attention_rows(model: ViT, x, queries, routes: InferRoutes = InferRoutes()):
    """Last-block attention rows of the query tokens ``queries`` (a
    sequence or int tensor of Q token indices), (B, h, Q, N+1), without the
    N x N matrix: softmax(q[queries] K^T / sqrt(d)) in f32, in h's dtype
    (the region-query and query-grid analysis modes,
    analyse_attention.py:183-247). Indices and columns count CLS and the
    patches; register tokens take part in the softmax, their columns
    dropped."""
    cfg = model.cfg
    h, last = _last_block_input(model, x, routes)
    idx = torch.as_tensor(queries, dtype=torch.long, device=h.device)
    idx = torch.where(idx > 0, idx + cfg.num_register_tokens, idx)
    q = _qk_rows(h[:, idx], last.attn.qkv.weight, last.attn.qkv.bias, 0)
    k = _qk_rows(h, last.attn.qkv.weight, last.attn.qkv.bias, 1)
    b, nq, _ = q.shape
    hd = cfg.head_dim
    q = q.reshape(b, nq, cfg.num_heads, hd).permute(0, 2, 1, 3)
    k = k.reshape(b, k.shape[1], cfg.num_heads, hd).permute(0, 2, 1, 3)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd**-0.5
    return _drop_registers(model, torch.softmax(logits, dim=-1).to(h.dtype), 3)


@torch.inference_mode()
def last_block_key_features(model: ViT, x, routes: InferRoutes = InferRoutes()):
    """The last block's per-patch key vectors, (B, gh, gw, D): the
    k-means feature-clustering method's input (eval.py:186-202), CLS row
    dropped."""
    cfg = model.cfg
    b, hgt, wdt, _ = x.shape
    h, last = _last_block_input(model, x, routes)
    k = _qk_rows(h, last.attn.qkv.weight, last.attn.qkv.bias, 1)
    return k[:, cfg.num_prefix_tokens:].reshape(b, hgt // cfg.patch_size, wdt // cfg.patch_size,
                                                cfg.embed_dim)

"""Fused LayerNorm -> linear: the CUDA kernels, their plain twins, and the
differentiable op of the training route TRAIN.LN_QKV="kernel".

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/ln_linear.py``:

* :func:`ln_linear` computes ``LN(x; scale, bias) @ w.T + b`` with one
  rounding of the f32 sum (replaces ``_ln_linear_fwd_kernel``);
* :func:`ln_linear_bwd` returns (dx, dscale, dbias, dw, db) from x and the
  cotangent, recomputing the row statistics (replaces
  ``_ln_linear_bwd_kernel``);
* :func:`ln_linear_trainable` wires both into a ``torch.autograd.Function``
  that saves only x and the parameters, as the JAX custom VJP does.

They launch the kernels of :func:`ln_linear_route` (forward) and
:func:`ln_linear_bwd_route` (backward) for CUDA tensors, never by a
fallback: float32 ``csrc/ln_linear.cu`` (register-tiled FFMA on the CUDA
cores behind a cp.async ring) both ways; bfloat16 ``csrc/ln_linear_wgmma.cu``
forward and ``csrc/ln_linear_bwd_wgmma.cu`` backward (both wgmma fed by
TMA); design notes in each source. CPU tensors take the plain
twins (``*_plain``); anything else raises. ``w`` comes in nn.Linear's (K, D)
layout, the transpose of the JAX package's (D, K). Each wrapper's
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import build
from .. import nn as tnn

KERNEL_WIDTHS = (192, 384)  # D values the kernels are instantiated for
COLUMN_CHUNK = 64  # K must be a multiple of this
LN_SPLITS = 16  # row splits of the backward's weight-gradient partials, at most
_BWD_MIN_TILE = 64  # rows of an ln_part row of the backward, both storage types


def ln_linear_plain(x, scale, bias, w, b, eps=1e-6):
    """Plain PyTorch twin of :func:`ln_linear`: xn rounded to x's dtype, the
    product and the bias summed in f32 and rounded once."""
    xn = tnn.layer_norm(x, scale, bias, eps).float()
    return (xn @ w.float().T + b.float()).to(x.dtype)


def ln_linear_bwd_plain(x, dy, scale, bias, w, eps=1e-6):
    """Plain PyTorch twin of :func:`ln_linear_bwd`, with the TPU kernel's
    rounding points: xn rounded to the storage type before dW's product, f32
    everywhere else."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    r = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + eps)
    xh = (x32 - mu) * r
    xn = (xh * scale.float() + bias.float()).to(dt).float()
    dy32 = dy.float()
    dxn = dy32 @ w.float()
    dxh = dxn * scale.float()
    dx = r * (dxh - dxh.mean(-1, keepdim=True) - xh * (dxh * xh).mean(-1, keepdim=True))
    return dx.to(dt), (dxn * xh).sum(0), dxn.sum(0), dy32.T @ xn, dy32.sum(0)


def ln_linear_route(x, w):
    """The kernel source a CUDA call of :func:`ln_linear` with these operands
    launches: float32 "ln_linear.cu", bfloat16 "ln_linear_wgmma.cu". Raises on
    shapes, dtypes and layouts no kernel takes; the device is the caller's
    check."""
    _check_shapes(x, w)
    return "ln_linear.cu" if x.dtype == torch.float32 else "ln_linear_wgmma.cu"


def ln_linear_bwd_route(x, w):
    """The kernel source a CUDA call of :func:`ln_linear_bwd` with these
    operands launches: float32 "ln_linear.cu", bfloat16
    "ln_linear_bwd_wgmma.cu" (its dx and weight-gradient kernels, then
    ln_linear.cu's fixed-order reductions). Raises as :func:`ln_linear_route`
    does."""
    _check_shapes(x, w)
    return "ln_linear.cu" if x.dtype == torch.float32 else "ln_linear_bwd_wgmma.cu"


def _check_shapes(x, w):
    """Raises on shapes, dtypes and layouts no kernel of either direction takes."""
    if x.dim() != 2 or x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"ln_linear: want (R, D) float32/bfloat16 x, got {tuple(x.shape)} {x.dtype}")
    d = x.shape[1]
    k = w.shape[0]
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"ln_linear: kernels built for D in {KERNEL_WIDTHS}, got D={d}")
    if k % COLUMN_CHUNK or tuple(w.shape) != (k, d):
        raise ValueError(f"ln_linear: want w (K, D) with K % {COLUMN_CHUNK} == 0, got "
                         f"{tuple(w.shape)} for D={d}")
    for what, t in (("x", x), ("w", w)):
        _check_operand("ln_linear", what, t, tuple(t.shape), x)


def bwd_workspace(r, d, k, dtype):
    """f32 values of the backward's two workspaces for r rows, the same for
    both storage types: ``part``, LN_SPLITS partials of [dW (K, D) | db (K)]
    (each kernel writes as many of them as fill the card: float32 two CTAs an
    SM of 128 x 128 tiles, bfloat16 one of 128 units x D); ``ln_part``, a row
    of [ds | dbb] (2 D) for each tile of _BWD_MIN_TILE rows (float32 a dx
    CTA, bfloat16 a consumer warpgroup of the 128-row dx CTA)."""
    if dtype not in build.DTYPE_CODES:
        raise ValueError(f"ln_linear_bwd: no kernel for {dtype}")
    return LN_SPLITS * (k * d + k), -(-r // _BWD_MIN_TILE) * 2 * d


def _check(name, x, w):
    """(R, D, K) of a kernel call; raises on anything the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    _check_shapes(x, w)
    return (*x.shape, w.shape[0])


def _check_operand(name, what, t, shape, x):
    if (tuple(t.shape) != shape or t.device != x.device or t.dtype != x.dtype
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name}: {what} must be a contiguous, 16-byte aligned {x.dtype} "
                         f"{shape} tensor on {x.device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} contiguous={t.is_contiguous()}")


def _f32_vector(name, t, size, device):
    if t.device != device or t.numel() != size:
        raise ValueError(f"ln_linear: {name} must hold {size} values on {device}")
    return t.reshape(-1).float().contiguous()


def ln_linear(x, scale, bias, w, b, eps=1e-6):
    """LN(x; scale, bias) @ w.T + b for x (R, D), w (K, D): (R, K) in x's
    dtype. CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return ln_linear_plain(x, scale, bias, w, b, eps)
    r, d, k = _check("ln_linear", x, w)
    s, bn = _f32_vector("scale", scale, d, x.device), _f32_vector("bias", bias, d, x.device)
    bf = _f32_vector("b", b, k, x.device)
    y = torch.empty((r, k), dtype=x.dtype, device=x.device)
    rc = build.library().vitocm_ln_linear(
        build.DTYPE_CODES[x.dtype], x.data_ptr(), s.data_ptr(), bn.data_ptr(), w.data_ptr(),
        bf.data_ptr(), y.data_ptr(), r, d, k, float(eps), build.stream_ptr(x.device))
    build.check(rc, "ln_linear")
    ln_linear.launches += 1
    return y


def ln_linear_bwd(x, dy, scale, bias, w, eps=1e-6):
    """Backward of :func:`ln_linear` from x and the cotangent dy (R, K):
    (dx in x's dtype, then f32 dscale, dbias, dw (K, D), db). CPU tensors
    take the plain twin; CUDA tensors launch the kernels of
    :func:`ln_linear_bwd_route` (dx, weight-gradient partials, their
    fixed-order reduction)."""
    if x.device.type == "cpu":
        return ln_linear_bwd_plain(x, dy, scale, bias, w, eps)
    r, d, k = _check("ln_linear_bwd", x, w)
    _check_operand("ln_linear_bwd", "dy", dy, (r, k), x)
    s, bn = _f32_vector("scale", scale, d, x.device), _f32_vector("bias", bias, d, x.device)
    width = k * d + k
    f32 = dict(dtype=torch.float32, device=x.device)
    part, ln_part = (torch.empty(n, **f32) for n in bwd_workspace(r, d, k, x.dtype))
    grads = torch.empty(width + 2 * d, **f32)
    dx, xn = torch.empty_like(x), torch.empty_like(x)  # xn: LN(x), from the dx kernel
    rc = build.library().vitocm_ln_linear_bwd(
        build.DTYPE_CODES[x.dtype], x.data_ptr(), dy.data_ptr(), s.data_ptr(), bn.data_ptr(),
        w.data_ptr(), dx.data_ptr(), xn.data_ptr(), part.data_ptr(), ln_part.data_ptr(),
        grads.data_ptr(), r, d, k, LN_SPLITS, float(eps), build.stream_ptr(x.device))
    build.check(rc, "ln_linear_bwd")
    ln_linear_bwd.launches += 1
    return (dx, grads[width:width + d], grads[width + d:], grads[:k * d].view(k, d),
            grads[k * d:width])


ln_linear.launches = 0
ln_linear_bwd.launches = 0


class _LNLinear(torch.autograd.Function):
    """ln_linear forward, ln_linear_bwd backward, both looked up in this
    module at call time so the twins can stand in for the route. Saves only
    x and the parameters; gradients come back in f32 and are cast to each
    primal's dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, w, b, eps):
        ctx.save_for_backward(x, scale, bias, w)
        ctx.eps, ctx.b_dtype = eps, b.dtype
        return ln_linear(x, scale, bias, w, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, w = ctx.saved_tensors
        dx, ds, dbb, dw, db = ln_linear_bwd(x, dy.contiguous(), scale, bias, w, ctx.eps)
        return (dx, ds.to(scale.dtype), dbb.to(bias.dtype), dw.to(w.dtype), db.to(ctx.b_dtype),
                None)


def ln_linear_trainable(x, scale, bias, w, b, eps=1e-6):
    """Differentiable :func:`ln_linear` for x (R, D), w (K, D), b (K)."""
    return _LNLinear.apply(x, scale, bias, w, b, eps)

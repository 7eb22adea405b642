"""The DINOv2 block's elementwise kernels: the SwiGLU gate and the LayerScale
residual with the LayerNorm after it.

The DINOv2 block (models/vit.py, block kind "dinov2") runs its four
products on cuBLAS, with the bias in the epilogue; between and after them:

* :func:`swiglu_gate`: x12 (R, 2H) -> silu(x12[:, :H]) * x12[:, H:] (R, H),
  in f32 and rounded once (dinov2/layers/swiglu_ffn.py's
  ``F.silu(x1) * x2``);
* :func:`layerscale_norm`: (x + gamma * y, LN(x + gamma * y)) of rows
  (R, D), the residual rounded once to the storage type and the LayerNorm
  (the next norm's scale and bias) read from the rounded residual: after
  the attention it emits LN2's input, after the FFN the next block's LN1
  input.

CUDA tensors launch ``csrc/swiglu.cu`` (``swiglu_gate_kernel``,
``layerscale_norm_kernel``), CPU tensors take the plain twins
(:func:`swiglu_gate_plain`, :func:`layerscale_norm_plain`); anything else
raises. :func:`gate_route` and :func:`lsnorm_route` name the source a CUDA
call launches. Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build
from .. import nn as tnn
from . import probes

LSNORM_D_MAX = 2048  # the widest row csrc/swiglu.cu's residual kernel holds in registers


def swiglu_gate_plain(x12):
    """Plain PyTorch twin of :func:`swiglu_gate`: silu(a) * b in f32, one
    rounding to x12's dtype."""
    a, b = x12.float().chunk(2, dim=-1)
    return (F.silu(a) * b).to(x12.dtype)


def layerscale_norm_plain(x, y, gamma, scale, bias, eps=1e-6):
    """Plain PyTorch twin of :func:`layerscale_norm`: out = x + gamma * y in
    f32 rounded to x's dtype, and LN(out) of the rounded out."""
    out = (x.float() + gamma.float() * y.float()).to(x.dtype)
    return out, tnn.layer_norm(out, scale, bias, eps)


def _storage(name, *ts):
    for t in ts:
        if t.dim() != 2 or t.dtype not in build.DTYPE_CODES or t.dtype != ts[0].dtype:
            raise ValueError(f"{name}: want (R, C) float32 or bfloat16 rows of one dtype, got "
                             f"{tuple(t.shape)} {t.dtype}")
    probes.check_layout(name, *ts)


def gate_route(x12) -> str:
    """The kernel source a CUDA call of :func:`swiglu_gate` launches:
    "swiglu.cu", for contiguous, 16-byte aligned (R, 2H) float32 or bfloat16
    rows with H a multiple of 8. Reads only shape, dtype and layout; raises
    ValueError on what the kernel does not take."""
    _storage("swiglu_gate", x12)
    if x12.shape[1] % 16:
        raise ValueError(f"swiglu_gate: want 2H columns with H a multiple of 8, got "
                         f"{x12.shape[1]}")
    return "swiglu.cu"


def lsnorm_route(x, y) -> str:
    """The kernel source a CUDA call of :func:`layerscale_norm` launches:
    "swiglu.cu", for x and y of one (R, D) shape, float32 or bfloat16,
    contiguous and 16-byte aligned, D a multiple of 8 up to LSNORM_D_MAX."""
    _storage("layerscale_norm", x, y)
    d = x.shape[1]
    if x.shape != y.shape or d % 8 or d > LSNORM_D_MAX:
        raise ValueError(f"layerscale_norm: want x and y of one (R, D) shape with D a multiple "
                         f"of 8 up to {LSNORM_D_MAX}, got {tuple(x.shape)} and {tuple(y.shape)}")
    return "swiglu.cu"


def swiglu_gate(x12):
    """silu(x12[:, :H]) * x12[:, H:] of (R, 2H) rows, (R, H) in x12's dtype.
    CPU tensors take the plain twin; CUDA tensors launch the kernel of
    :func:`gate_route`."""
    if x12.device.type == "cpu":
        return swiglu_gate_plain(x12)
    probes._check_cuda("swiglu_gate", x12)
    gate_route(x12)
    r, h2 = x12.shape
    g = torch.empty((r, h2 // 2), dtype=x12.dtype, device=x12.device)
    rc = build.library().vitocm_swiglu_gate(build.DTYPE_CODES[x12.dtype], x12.data_ptr(),
                                            g.data_ptr(), r, h2 // 2,
                                            build.stream_ptr(x12.device))
    build.check(rc, "swiglu_gate")
    swiglu_gate.launches += 1
    return g


def _f32_vector(name, t, d, device):
    if t.device != device or t.numel() != d:
        raise ValueError(f"layerscale_norm: {name} must hold {d} values on {device}")
    return t.reshape(-1).float().contiguous()


def layerscale_norm(x, y, gamma, scale, bias, eps=1e-6):
    """(out, z) of rows x, y (R, D): out = x + gamma * y rounded to x's
    dtype, z = LN(out) * scale + bias. CPU tensors take the plain twin; CUDA
    tensors launch the kernel of :func:`lsnorm_route`."""
    if x.device.type == "cpu":
        return layerscale_norm_plain(x, y, gamma, scale, bias, eps)
    probes._check_cuda("layerscale_norm", x, y)
    lsnorm_route(x, y)
    r, d = x.shape
    vecs = [_f32_vector(n, t, d, x.device) for n, t in (("gamma", gamma), ("scale", scale),
                                                         ("bias", bias))]
    out, z = torch.empty_like(x), torch.empty_like(x)
    rc = build.library().vitocm_layerscale_norm(
        build.DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), *(v.data_ptr() for v in vecs),
        out.data_ptr(), z.data_ptr(), r, d, eps, build.stream_ptr(x.device))
    build.check(rc, "layerscale_norm")
    layerscale_norm.launches += 1
    return out, z


swiglu_gate.launches = layerscale_norm.launches = 0

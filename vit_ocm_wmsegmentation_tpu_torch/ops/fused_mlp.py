"""Fused LayerNorm -> MLP -> residual block: the CUDA kernels and their twins.

Counterpart of the inference forward of
``vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py``:

* :func:`fused_mlp_block_lnout` returns ``(out, z)`` with
  ``out = x + W2 gelu(W1 LN(x) + b1) + b2`` and ``z = LN(out) s2 + b2'``,
  the next block's normalized input (replaces ``_mlp_fwd_lnout_kernel``);
* :func:`fused_mlp_block` returns ``out`` alone (replaces
  ``_mlp_fwd_kernel`` with no residual outputs);
* :func:`fused_mlp_block_h1` returns ``(out, h1)``, the pre-GELU hidden
  activation saved for the backward (``_mlp_fwd_kernel``, ``want="h1"``);
* :func:`fused_mlp_block_gp` returns ``(out, g, gp)``, gelu(h1) and
  gelu'(h1) saved for a backward without erf or exp (``_mlp_fwd_kernel``,
  ``want="gp"``, the JAX package's SAVE_GP route); its out is bit-equal to
  :func:`fused_mlp_block_h1`'s;
* :func:`fused_mlp_bwd` is the backward from x, h1 and the cotangent
  (replaces ``_mlp_bwd_kernel``), :func:`fused_mlp_bwd_gp` the backward
  from x, g, gp and the cotangent (``_mlp_bwd_kernel`` with ``gpp``);
  :func:`fused_mlp_block_trainable` wires either pair into a
  ``torch.autograd.Function``.

They launch the kernels of ``csrc/`` for CUDA tensors and their plain twins
for CPU tensors. Which kernel a CUDA call launches is fixed by its route
(:func:`mlp_route`, :func:`mlp_bwd_route`), never by a fallback: float32
takes ``fused_mlp.cu`` and ``fused_mlp_bwd.cu`` (CUDA cores); bfloat16 the
inference forward (lnout, plain) of ``fused_mlp_serve_wgmma.cu``, the
training forward (h1, gp) of ``fused_mlp_wgmma.cu`` and the backward of
``fused_mlp_bwd_wgmma.cu`` (wgmma fed by TMA); design notes in each source.
Weights come in nn.Linear's layout:
``w1`` = fc1.weight (H, D), ``w2`` = fc2.weight (D, H) -- the transpose of
the JAX package's (D, H) / (H, D). Each wrapper's ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import math

import torch

from .. import build
from .. import nn as tnn

KERNEL_WIDTHS = (192, 384)  # D values the kernels are instantiated for
HIDDEN_CHUNK = 32  # H must be a multiple of this in bfloat16 (the wgmma kernels' chunk)
F32_HIDDEN_CHUNK = 64  # ... and of this in float32 (the f32 kernels' masked last chunk)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


FWD_TILE = 128  # rows of a CTA of the bf16 training forward (fused_mlp_wgmma.cu)
MAX_FWD_PARTS = 4  # CTAs that share a tile of the bf16 training forward's last wave, at most
MLP_SPLITS = 16  # row splits of the backward's weight-gradient partials (at most, in bf16)
_BWD_MIN_TILE = 64  # rows of the backward's ln_part tile, both storage types


def _gelu_prime(h):
    """gelu'(h) = Phi(h) + h phi(h) in f32, the kernels' order of operations."""
    return 0.5 * (1.0 + torch.erf(h * _INV_SQRT2)) + h * (torch.exp(-0.5 * h * h) * _INV_SQRT2PI)


def _mlp_plain(x, scale, bias, w1, b1, w2, b2, eps, want=None):
    """out in x's dtype, with the kernel's rounding points: xn and g rounded
    to the storage type before each product, f32 accumulation; want="h1"
    also returns the pre-GELU h1 rounded to the storage type (GELU reads
    the unrounded value), want="gp" the rounded g and gelu'(h1)."""
    xn = tnn.layer_norm(x, scale, bias, eps).float()
    h1 = xn @ w1.float().T + b1.float()
    g = tnn.gelu(h1).to(x.dtype)
    y = g.float() @ w2.float().T + b2.float()
    out = (x.float() + y).to(x.dtype)
    if want == "h1":
        return out, h1.to(x.dtype)
    if want == "gp":
        return out, g, _gelu_prime(h1).to(x.dtype)
    return out


def fused_mlp_block_plain(x, scale, bias, w1, b1, w2, b2, eps=1e-6, want_h1=False):
    """Plain PyTorch twin of :func:`fused_mlp_block` and, with want_h1, of
    :func:`fused_mlp_block_h1`."""
    return _mlp_plain(x, scale, bias, w1, b1, w2, b2, eps, "h1" if want_h1 else None)


def fused_mlp_block_gp_plain(x, scale, bias, w1, b1, w2, b2, eps=1e-6):
    """Plain PyTorch twin of :func:`fused_mlp_block_gp`."""
    return _mlp_plain(x, scale, bias, w1, b1, w2, b2, eps, "gp")


def fused_mlp_block_lnout_plain(x, scale, bias, w1, b1, w2, b2, scale2, bias2, eps=1e-6):
    """Plain PyTorch twin of :func:`fused_mlp_block_lnout`; z is computed
    from the rounded out."""
    out = _mlp_plain(x, scale, bias, w1, b1, w2, b2, eps)
    return out, tnn.layer_norm(out, scale2, bias2, eps)


def mlp_route(x, w1, w2, want=None):
    """The kernel source a CUDA call with these operands launches, for every
    ``want`` (None: fused_mlp_block, fused_mlp_block_lnout; "h1", "gp": the
    training forward): bfloat16 "fused_mlp_serve_wgmma.cu" with no residual
    outputs and "fused_mlp_wgmma.cu" with them, float32 "fused_mlp.cu".
    Raises on shapes, dtypes and layouts no kernel takes; the device is the
    caller's check."""
    if x.dim() != 2 or x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"fused_mlp: want (R, D) float32/bfloat16 x, got {tuple(x.shape)} {x.dtype}")
    d = x.shape[1]
    hdim = w1.shape[0]
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"fused_mlp: kernel built for D in {KERNEL_WIDTHS}, got D={d}")
    if x.dtype == torch.float32:
        route = "fused_mlp.cu"
    else:
        route = "fused_mlp_serve_wgmma.cu" if want is None else "fused_mlp_wgmma.cu"
    chunk = F32_HIDDEN_CHUNK if route == "fused_mlp.cu" else HIDDEN_CHUNK
    if hdim % chunk or tuple(w1.shape) != (hdim, d) or tuple(w2.shape) != (d, hdim):
        raise ValueError(f"fused_mlp: want w1 (H, D) and w2 (D, H) with H % {chunk} == 0, "
                         f"got {tuple(w1.shape)} and {tuple(w2.shape)}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if (t.device != x.device or t.dtype != x.dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"fused_mlp: {name} must be contiguous, 16-byte aligned {x.dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device} "
                             f"contiguous={t.is_contiguous()}")
    return route


def mlp_bwd_route(x, do, h1, w1, w2, gp=None):
    """The kernel source a CUDA backward with these operands launches:
    float32 "fused_mlp_bwd.cu", bfloat16 "fused_mlp_bwd_wgmma.cu"; H as the
    forward's (:func:`mlp_route`). h1 is the saved pre-GELU activation or,
    with gp (the SAVE_GP route), the saved g. Raises on shapes, dtypes and
    layouts no kernel takes; the device is the caller's check."""
    mlp_route(x, w1, w2, "h1")
    r, d = x.shape
    hdim = w1.shape[0]
    hidden = (("h1", h1),) if gp is None else (("g", h1), ("gp", gp))
    for name, t, shape in (("do", do, (r, d)), *((n, t, (r, hdim)) for n, t in hidden)):
        if (tuple(t.shape) != shape or t.device != x.device or t.dtype != x.dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"fused_mlp_bwd: {name} must be a contiguous, 16-byte aligned "
                             f"{x.dtype} {shape} tensor on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return "fused_mlp_bwd.cu" if x.dtype == torch.float32 else "fused_mlp_bwd_wgmma.cu"


def fwd_split(r, sms):
    """(split_from, parts) of the bfloat16 training forward over r rows on a
    card of sms SMs: its ceil(r / FWD_TILE) tiles run one CTA an SM, and
    when they are more than one wave, each tile past the last whole wave
    runs as ``parts`` CTAs (at most MAX_FWD_PARTS, as many as the SMs hold),
    each over a share of the hidden chunks, so that the last wave takes a
    fraction of a tile's time. (tiles, 1) splits none."""
    tiles = -(-r // FWD_TILE)
    tail = tiles % sms
    parts = min(MAX_FWD_PARTS, sms // tail) if tiles > sms and tail else 1
    return (tiles - tail, parts) if parts > 1 else (tiles, 1)


def bwd_workspace(r, d, hdim, dtype, save_gp=False):
    """f32 values of the backward's two workspaces for r rows: ``part``, the
    MLP_SPLITS weight-gradient partials, then the dx kernel's dh1 (R, H)
    and, on the save-h1 route, g (R, H), which the weight kernel reads;
    ``ln_part``, one row for each tile of _BWD_MIN_TILE rows. float32: (2 H D
    + H + D) values a partial, dh1 and g in f32, rows of 2 D ([ds | dbb]);
    bfloat16: (2 H D + H) a partial, dh1 and g in bf16 (two to an f32 value),
    rows of 3 D ([db2 | ds | dbb])."""
    hidden = (1 if save_gp else 2) * r * hdim
    tiles = -(-r // _BWD_MIN_TILE)
    if dtype == torch.float32:
        return MLP_SPLITS * (2 * hdim * d + hdim + d) + hidden, tiles * 2 * d
    return MLP_SPLITS * (2 * hdim * d + hdim) + hidden // 2, tiles * 3 * d


def _check(x, w1, w2, want=None):
    """(R, D, H, route) of a kernel call; raises on anything no kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for device {x.device}")
    route = mlp_route(x, w1, w2, want)
    return (*x.shape, w1.shape[0], route)


def _f32_vector(name, t, size, device):
    if t.device != device or t.numel() != size:
        raise ValueError(f"fused_mlp: {name} must hold {size} values on {device}")
    return t.reshape(-1).float().contiguous()


def _launch(x, scale, bias, w1, b1, w2, b2, scale2, bias2, eps, lnout, want=None):
    """One forward launch; returns (out, z) with lnout, else (out, h1 or g,
    gp), the residuals None where ``want`` (None, "h1", "gp") asks for none."""
    r, d, hdim, route = _check(x, w1, w2, want)
    vec = lambda name, t, size=d: _f32_vector(name, t, size, x.device)  # noqa: E731
    args = [vec("scale", scale), vec("bias", bias), vec("b1", b1, hdim), vec("b2", b2)]
    args += [vec("scale2", scale2), vec("bias2", bias2)] if lnout else [None, None]
    hidden = lambda: torch.empty((r, hdim), dtype=x.dtype, device=x.device)  # noqa: E731
    out = torch.empty_like(x)
    z = torch.empty_like(x) if lnout else None
    h1 = hidden() if want is not None else None
    gp = hidden() if want == "gp" else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    s1, bn1, b1f, b2f, s2, bn2 = (ptr(t) for t in args)
    if route == "fused_mlp_serve_wgmma.cu":
        rc = build.library().vitocm_fused_mlp_serve(
            int(lnout), x.data_ptr(), s1, bn1, w1.data_ptr(), b1f, w2.data_ptr(), b2f, s2, bn2,
            out.data_ptr(), ptr(z), r, d, hdim, float(eps), build.stream_ptr(x.device))
    elif route == "fused_mlp_wgmma.cu":  # the training forward: its last wave's tiles split
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        split_from, parts = fwd_split(r, sms)
        ypart = None
        if parts > 1:
            ypart = torch.empty(((-(-r // FWD_TILE) - split_from) * parts * FWD_TILE, d),
                                dtype=torch.float32, device=x.device)
        rc = build.library().vitocm_fused_mlp_wgmma(
            x.data_ptr(), s1, bn1, w1.data_ptr(), b1f, w2.data_ptr(), b2f, out.data_ptr(),
            ptr(h1), ptr(gp), ptr(ypart), split_from, parts, r, d, hdim, float(eps),
            build.stream_ptr(x.device))
    else:
        rc = build.library().vitocm_fused_mlp(
            build.DTYPE_CODES[x.dtype], int(lnout), x.data_ptr(), s1, bn1, w1.data_ptr(), b1f,
            w2.data_ptr(), b2f, s2, bn2, out.data_ptr(), ptr(z), ptr(h1), ptr(gp), r, d, hdim,
            float(eps), build.stream_ptr(x.device))
    build.check(rc, "fused_mlp")
    return (out, z) if lnout else (out, h1, gp)


def fused_mlp_block(x, scale, bias, w1, b1, w2, b2, eps=1e-6):
    """x + gelu(LN(x; scale, bias) @ w1.T + b1) @ w2.T + b2 for x (R, D).
    CPU tensors take the plain twin; CUDA tensors launch the kernel of
    :func:`mlp_route` (bfloat16: fused_mlp_serve_wgmma.cu, float32: fused_mlp.cu)."""
    if x.device.type == "cpu":
        return fused_mlp_block_plain(x, scale, bias, w1, b1, w2, b2, eps)
    out, _, _ = _launch(x, scale, bias, w1, b1, w2, b2, None, None, eps, lnout=False)
    fused_mlp_block.launches += 1
    return out


def fused_mlp_block_lnout(x, scale, bias, w1, b1, w2, b2, scale2, bias2, eps=1e-6):
    """(out, z): out as :func:`fused_mlp_block`, z = LN(out)*scale2 + bias2.
    CPU tensors take the plain twin; CUDA tensors launch the kernel of
    :func:`mlp_route`."""
    if x.device.type == "cpu":
        return fused_mlp_block_lnout_plain(x, scale, bias, w1, b1, w2, b2, scale2, bias2, eps)
    out, z = _launch(x, scale, bias, w1, b1, w2, b2, scale2, bias2, eps, lnout=True)
    fused_mlp_block_lnout.launches += 1
    return out, z


def fused_mlp_block_h1(x, scale, bias, w1, b1, w2, b2, eps=1e-6):
    """(out, h1): out as :func:`fused_mlp_block`, h1 = LN(x) @ w1.T + b1
    (R, H) rounded to x's dtype, the residual of the backward. CPU tensors
    take the plain twin; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_mlp_block_plain(x, scale, bias, w1, b1, w2, b2, eps, want_h1=True)
    out, h1, _ = _launch(x, scale, bias, w1, b1, w2, b2, None, None, eps, lnout=False, want="h1")
    fused_mlp_block_h1.launches += 1
    return out, h1


def fused_mlp_block_gp(x, scale, bias, w1, b1, w2, b2, eps=1e-6):
    """(out, g, gp): out as :func:`fused_mlp_block` (bit-equal to
    :func:`fused_mlp_block_h1`'s), g = gelu(h1) and gp = gelu'(h1) (R, H)
    rounded to x's dtype, the residuals of :func:`fused_mlp_bwd_gp`. CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_mlp_block_gp_plain(x, scale, bias, w1, b1, w2, b2, eps)
    out = _launch(x, scale, bias, w1, b1, w2, b2, None, None, eps, lnout=False, want="gp")
    fused_mlp_block_gp.launches += 1
    return out


def _mlp_bwd_plain(x, do, g, gp, scale, bias, w1, w2, eps):
    """The backward's arithmetic from g (in the storage type) and gp (f32):
    xn and dh1 rounded to the storage type before their products, f32
    everywhere else."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    r = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + eps)
    xh = (x32 - mu) * r
    xn = (xh * scale.float() + bias.float()).to(dt).float()
    g = g.float()
    do32 = do.float()
    dh1 = ((do32 @ w2.float()) * gp).to(dt).float()
    dxn = dh1 @ w1.float()
    dxh = dxn * scale.float()
    dx_ln = r * (dxh - dxh.mean(-1, keepdim=True) - xh * (dxh * xh).mean(-1, keepdim=True))
    return ((do32 + dx_ln).to(dt), (dxn * xh).sum(0), dxn.sum(0), dh1.T @ xn, dh1.sum(0),
            do32.T @ g, do32.sum(0))


def fused_mlp_bwd_plain(x, do, h1, scale, bias, w1, w2, eps=1e-6):
    """Plain PyTorch twin of :func:`fused_mlp_bwd`, with the TPU kernel's
    rounding points: g = gelu(h1) rounded to the storage type, gelu'(h1) in
    f32, then :func:`_mlp_bwd_plain`."""
    h = h1.float()
    return _mlp_bwd_plain(x, do, tnn.gelu(h).to(x.dtype), _gelu_prime(h), scale, bias, w1, w2,
                          eps)


def fused_mlp_bwd_gp_plain(x, do, g, gp, scale, bias, w1, w2, eps=1e-6):
    """Plain PyTorch twin of :func:`fused_mlp_bwd_gp`: the saved g and gp."""
    return _mlp_bwd_plain(x, do, g, gp.float(), scale, bias, w1, w2, eps)


def fused_mlp_bwd(x, do, h1, scale, bias, w1, w2, eps=1e-6):
    """Backward of :func:`fused_mlp_block` from x, the saved h1 and the
    cotangent do of out: (dx in x's dtype, then f32 dscale, dbias, dw1 (H, D),
    db1, dw2 (D, H), db2). CPU tensors take the plain twin; CUDA tensors
    launch the kernels (dx, weight-gradient partials, their reduction)."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, do, h1, scale, bias, w1, w2, eps)
    out = _launch_bwd(x, do, h1, None, scale, bias, w1, w2, eps)
    fused_mlp_bwd.launches += 1
    return out


def fused_mlp_bwd_gp(x, do, g, gp, scale, bias, w1, w2, eps=1e-6):
    """Backward of :func:`fused_mlp_block` from x, the saved g and gp of
    :func:`fused_mlp_block_gp` and the cotangent do: the gradients of
    :func:`fused_mlp_bwd`, with no erf or exp in the kernels. CPU tensors
    take the plain twin; CUDA tensors launch the kernels."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_gp_plain(x, do, g, gp, scale, bias, w1, w2, eps)
    out = _launch_bwd(x, do, g, gp, scale, bias, w1, w2, eps)
    fused_mlp_bwd_gp.launches += 1
    return out


def _launch_bwd(x, do, h1, gp, scale, bias, w1, w2, eps):
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd: no kernel for device {x.device}")
    mlp_bwd_route(x, do, h1, w1, w2, gp)
    r, d = x.shape
    hdim = w1.shape[0]
    s1, bn1 = _f32_vector("scale", scale, d, x.device), _f32_vector("bias", bias, d, x.device)
    width = 2 * hdim * d + hdim + d
    f32 = dict(dtype=torch.float32, device=x.device)
    part, ln_part = (torch.empty(n, **f32)
                     for n in bwd_workspace(r, d, hdim, x.dtype, gp is not None))
    grads = torch.empty(width + 2 * d, **f32)
    dx, xn = torch.empty_like(x), torch.empty_like(x)  # xn: LN(x), from the dx kernel
    rc = build.library().vitocm_fused_mlp_bwd(
        build.DTYPE_CODES[x.dtype], x.data_ptr(), do.data_ptr(), h1.data_ptr(),
        gp.data_ptr() if gp is not None else None, s1.data_ptr(), bn1.data_ptr(),
        w1.data_ptr(), w2.data_ptr(), dx.data_ptr(), xn.data_ptr(), part.data_ptr(),
        ln_part.data_ptr(), grads.data_ptr(), r, d, hdim, MLP_SPLITS, float(eps),
        build.stream_ptr(x.device))
    build.check(rc, "fused_mlp_bwd")
    hd = hdim * d
    return (dx, grads[width:width + d], grads[width + d:], grads[:hd].view(hdim, d),
            grads[2 * hd:2 * hd + hdim], grads[hd:2 * hd].view(d, hdim),
            grads[2 * hd + hdim:width])


fused_mlp_block.launches = 0
fused_mlp_block_lnout.launches = 0
fused_mlp_block_h1.launches = 0
fused_mlp_block_gp.launches = 0
fused_mlp_bwd.launches = 0
fused_mlp_bwd_gp.launches = 0


class _FusedMLP(torch.autograd.Function):
    """fused_mlp_block_h1 forward and fused_mlp_bwd backward, or with
    save_gp fused_mlp_block_gp and fused_mlp_bwd_gp; all looked up in this
    module at call time, so the twins can stand in for a whole route.
    Parameter gradients come back in f32 and are cast to each primal's
    dtype, as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, eps, save_gp):
        if save_gp:
            out, *res = fused_mlp_block_gp(x, scale, bias, w1, b1, w2, b2, eps)
        else:
            out, *res = fused_mlp_block_h1(x, scale, bias, w1, b1, w2, b2, eps)
        ctx.save_for_backward(x, scale, bias, w1, w2, *res)
        ctx.eps, ctx.bias_dtypes = eps, (b1.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        x, scale, bias, w1, w2, *res = ctx.saved_tensors
        bwd = fused_mlp_bwd_gp if len(res) == 2 else fused_mlp_bwd
        dx, ds, dbb, dw1, db1, dw2, db2 = bwd(x, do.contiguous(), *res, scale, bias, w1, w2,
                                              ctx.eps)
        b1_dt, b2_dt = ctx.bias_dtypes
        return (dx, ds.to(scale.dtype), dbb.to(bias.dtype), dw1.to(w1.dtype), db1.to(b1_dt),
                dw2.to(w2.dtype), db2.to(b2_dt), None, None)


def fused_mlp_block_trainable(x, scale, bias, w1, b1, w2, b2, eps=1e-6, save_gp=False):
    """Differentiable :func:`fused_mlp_block` for x (R, D): the training
    route (the JAX package's MLP_REMAT="kernel"), saving h1 or, with
    save_gp, g and gp (MLP_REMAT="kernel+gp")."""
    return _FusedMLP.apply(x, scale, bias, w1, b1, w2, b2, eps, save_gp)

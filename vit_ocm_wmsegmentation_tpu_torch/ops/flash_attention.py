"""Flash attention: the CUDA kernels, their plain twins, and the MHSA block.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/flash_attention.py``:

* inference (:func:`mha_flash`): 1/sqrt(d) folded into the q columns of
  the qkv weight, the qkv projection as a library matmul,
  :func:`attention_qkv` on the fused (B, N, 3hd) tensor (replaces
  ``_attn_fwd_qkvflat_kernel``), the out projection as a library matmul;
* training (``mha_flash(prefer_folded=True)``): q, k, v split into the
  folded (B*h, N, d) layout and :func:`flash_attention_trainable`, whose
  forward :func:`flash_attention` returns (out, logsumexp) (replaces
  ``_attn_fwd_kernel`` on its lse route) and whose backward
  :func:`flash_attention_bwd` recomputes P from the logsumexp (replaces
  ``_attn_bwd_kernel``);
* training on the saved-P route (TRAIN.ATTN_SAVE_P on,
  ``flash_attention_trainable(save_p=True)``): the forward
  :func:`flash_attention_savep` also returns P = exp(s - row max) in the
  storage type and 1/denominator (``_attn_fwd_kernel``'s P output) and the
  backward :func:`flash_attention_bwd_savep` reads them instead of
  recomputing exp (replaces ``_attn_bwd_savep_kernel``).

Each wrapper launches its kernel for CUDA tensors (f32 storage:
``csrc/attention_qkv.cu`` and ``csrc/attention_bwd.cu``, register-tiled
FFMA behind a cp.async ring, and ``csrc/attention_savep.cu``, on the CUDA
cores; bf16: :func:`attention_qkv`
and :func:`flash_attention` on ``csrc/attention_qkv_wgmma.cu``,
:func:`flash_attention_bwd` on ``csrc/attention_bwd_wgmma.cu`` (wgmma fed
by TMA), the saved-P forward on ``csrc/attention_savep_wgmma.cu`` and its
backward on ``csrc/attention_savep_bwd_wgmma.cu`` (both wgmma fed by TMA);
design notes there) and takes its plain twin (``*_plain``) for CPU tensors;
anything else raises. :func:`attention_qkv_route`,
:func:`flash_attention_route`, :func:`flash_attention_bwd_route`,
:func:`flash_attention_savep_route` and :func:`flash_attention_bwd_savep_route`
name the source a CUDA call launches. Each wrapper's ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build
from . import quant as qz

HEAD_DIMS = (64, 128)  # the kernels' head dims (every DINO ViT; the MIM ViT)
# keys per online-softmax step of the twins and the bf16 kernels; the f32 kernels
# take 128 (d = 64) or 64, which in f32 changes only the order of the sums
KEY_TILE = 64
_DENOM_TINY = 1e-35


def _softmax_tiles(q, k, v, n, dtype):
    """The kernels' forward arithmetic on f32 (..., N, d) q (already scaled),
    k, v: keys in tiles of KEY_TILE, the last one masked at n; an online
    softmax shifted by the running row max; P rounded to ``dtype`` before
    P.V; the denominator summed from the rounded P. Only the order of the f32
    sums differs from the kernels. Returns (o, lse): o divided by the
    denominator clamped at 1e-35, lse = max + log(denominator), (..., N, 1)."""
    m = torch.full(q.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
    for k0 in range(0, n, KEY_TILE):
        k1 = min(k0 + KEY_TILE, n)
        s = q @ k[..., k0:k1, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new).to(dtype).float()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p @ v[..., k0:k1, :]
        m = m_new
    return o / torch.clamp_min(l, _DENOM_TINY), m + torch.log(l)


def attention_qkv_plain(qkv, num_heads: int, n: int):
    """Plain PyTorch twin of :func:`attention_qkv`, with the kernel's block
    decomposition and numerics (:func:`_softmax_tiles`)."""
    b, rows, cols = qkv.shape
    d = cols // 3 // num_heads
    t = qkv.float().reshape(b, rows, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # (3, B, h, N, d)
    o, _ = _softmax_tiles(t[0], t[1], t[2], n, qkv.dtype)
    return o.permute(0, 2, 1, 3).reshape(b, rows, num_heads * d).to(qkv.dtype)


def _check_dtype_device(name, t, want_dim, devices=("cuda",)):
    if t.device.type not in devices:
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if (t.dim() != want_dim or t.dtype not in build.DTYPE_CODES or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: want a contiguous, 16-byte aligned {want_dim}-D float32/"
                         f"bfloat16 tensor, got {tuple(t.shape)} {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def attention_qkv_route(qkv, num_heads: int, n: int) -> str:
    """The kernel source a CUDA call with this qkv launches: bfloat16
    "attention_qkv_wgmma.cu", float32 "attention_qkv.cu". Raises on shapes,
    dtypes and layouts neither takes; the device is the caller's check."""
    if (qkv.dim() != 3 or qkv.dtype not in build.DTYPE_CODES or not qkv.is_contiguous()
            or qkv.data_ptr() % 16):
        raise ValueError(f"attention_qkv: want a contiguous, 16-byte aligned 3-D float32/"
                         f"bfloat16 tensor, got {tuple(qkv.shape)} {qkv.dtype} "
                         f"contiguous={qkv.is_contiguous()}")
    _, rows, cols = qkv.shape
    d = cols // 3 // num_heads
    if cols != 3 * num_heads * d or d not in HEAD_DIMS:
        raise ValueError(f"attention_qkv: kernel needs head dim in {HEAD_DIMS}, got {cols} "
                         f"columns for {num_heads} heads")
    if not 1 <= n <= rows:
        raise ValueError(f"attention_qkv: n={n} outside [1, {rows}]")
    return "attention_qkv_wgmma.cu" if qkv.dtype == torch.bfloat16 else "attention_qkv.cu"


def attention_qkv(qkv, num_heads: int, n: int):
    """softmax attention straight from the fused qkv projection.

    qkv: (B, N, 3*h*d) contiguous, float32 or bfloat16, the q section
    already scaled by 1/sqrt(d); keys at rows >= n are masked. Returns
    (B, N, h*d), heads side by side. CPU tensors take the plain twin; CUDA
    tensors launch the kernel of :func:`attention_qkv_route` (d in
    HEAD_DIMS); anything else raises."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, n)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_qkv: no kernel for device {qkv.device}")
    route = attention_qkv_route(qkv, num_heads, n)
    b, rows, cols = qkv.shape
    d = cols // 3 // num_heads
    out = torch.empty((b, rows, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    lib, stream = build.library(), build.stream_ptr(qkv.device)
    if route == "attention_qkv_wgmma.cu":
        rc = lib.vitocm_attention_qkv_wgmma(qkv.data_ptr(), out.data_ptr(), b, rows, n, num_heads,
                                            d, stream)
    else:
        rc = lib.vitocm_attention_qkv(build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(), out.data_ptr(),
                                      b, rows, n, num_heads, d, stream)
    build.check(rc, "attention_qkv")
    attention_qkv.launches += 1
    return out


attention_qkv.launches = 0


def _scaled_qkv_weights(qkv_weight, qkv_bias, num_heads):
    """Fold the 1/sqrt(d) attention scale into the q rows of the (3D, D)
    qkv weight (and the q section of the bias) in f32, then cast the weight
    back; the bias stays f32, as the JAX package keeps it."""
    dm = qkv_weight.shape[1]
    scale = (dm // num_heads) ** -0.5
    colscale = torch.ones(3 * dm, dtype=torch.float32, device=qkv_weight.device)
    colscale[:dm] = scale
    wq = (qkv_weight.float() * colscale[:, None]).to(qkv_weight.dtype)
    bq = qkv_bias.float() * colscale if qkv_bias is not None else None
    return wq, bq


def _scale_q(q):
    """q * d^-0.5 in f32, rounded to q's dtype, as the JAX forward and
    backward both compute it before the kernel."""
    return (q.float() * q.shape[-1] ** -0.5).to(q.dtype)


def flash_attention_plain(q, k, v):
    """Plain PyTorch twin of :func:`flash_attention`, with the kernels'
    decomposition (:func:`_softmax_tiles`)."""
    o, lse = _softmax_tiles(_scale_q(q).float(), k.float(), v.float(), q.shape[1], q.dtype)
    return o.to(q.dtype), lse[..., 0]


def _check_folded(name, *ts, devices=("cuda",)):
    for t in ts:
        _check_dtype_device(name, t, 3, devices)
        if t.shape != ts[0].shape or t.dtype != ts[0].dtype or t.device != ts[0].device:
            raise ValueError(f"{name}: q, k, v, o, do must share shape, dtype and device; got "
                             f"{tuple(t.shape)} {t.dtype} against {tuple(ts[0].shape)} "
                             f"{ts[0].dtype}")
    if ts[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: kernel needs head dim in {HEAD_DIMS}, got {ts[0].shape[-1]}")


_FWD_SOURCES = {torch.float32: "attention_qkv.cu", torch.bfloat16: "attention_qkv_wgmma.cu"}
_BWD_SOURCES = {torch.float32: "attention_bwd.cu", torch.bfloat16: "attention_bwd_wgmma.cu"}
_FWD_SAVEP_SOURCES = {torch.float32: "attention_savep.cu",
                      torch.bfloat16: "attention_savep_wgmma.cu"}
_BWD_SAVEP_SOURCES = {torch.float32: "attention_savep.cu",
                      torch.bfloat16: "attention_savep_bwd_wgmma.cu"}


def flash_attention_route(q, *others) -> str:
    """The kernel source a CUDA call of :func:`flash_attention` with this q
    (and the k, v given after it) launches: bfloat16
    "attention_qkv_wgmma.cu", float32 "attention_qkv.cu". Reads only shapes,
    dtypes and layouts, so a CPU tensor stands for its CUDA copy; raises on
    what no kernel takes and on devices other than the two."""
    _check_folded("flash_attention", q, *others, devices=("cpu", "cuda"))
    return _FWD_SOURCES[q.dtype]


def flash_attention_bwd_route(q, *others) -> str:
    """The kernel source a CUDA call of :func:`flash_attention_bwd` with this
    q (and the k, v, o, do given after it) launches: bfloat16
    "attention_bwd_wgmma.cu" (its dk/dv and dq kernels, after
    attention_bwd.cu's row statistics), float32 "attention_bwd.cu". As
    :func:`flash_attention_route`, a CPU tensor stands for its CUDA copy."""
    _check_folded("flash_attention_bwd", q, *others, devices=("cpu", "cuda"))
    return _BWD_SOURCES[q.dtype]


def flash_attention_savep_route(q, *others) -> str:
    """The kernel source a CUDA call of :func:`flash_attention_savep` with
    this q (and the k, v given after it) launches: bfloat16
    "attention_savep_wgmma.cu", float32 "attention_savep.cu". As
    :func:`flash_attention_route`, a CPU tensor stands for its CUDA copy."""
    _check_folded("flash_attention_savep", q, *others, devices=("cpu", "cuda"))
    return _FWD_SAVEP_SOURCES[q.dtype]


def flash_attention_bwd_savep_route(q, *others) -> str:
    """The kernel source a CUDA call of :func:`flash_attention_bwd_savep`
    with this q (and the k, v, o, do given after it) launches: bfloat16
    "attention_savep_bwd_wgmma.cu" (its dk/dv and dq kernels, after
    attention_bwd.cu's row statistics), float32 "attention_savep.cu". As
    :func:`flash_attention_route`, a CPU tensor stands for its CUDA copy."""
    _check_folded("flash_attention_bwd_savep", q, *others, devices=("cpu", "cuda"))
    return _BWD_SAVEP_SOURCES[q.dtype]


def _stats_pitch(n: int) -> int:
    """Floats between the rows of the backward's (B*h, 2, pitch) row
    statistics: n rounded up to 4, so each row is 16-byte aligned for the
    kernels' copies (cp.async in f32, TMA in bf16)."""
    return -(-n // 4) * 4


def flash_attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v and its logsumexp for folded (B*h, N, d)
    q, k, v (q unscaled): returns (out (B*h, N, d) in q's dtype, lse (B*h, N)
    float32). CPU tensors take the plain twin; CUDA tensors launch the
    kernel of :func:`flash_attention_route` (d in HEAD_DIMS, contiguous
    float32/bfloat16)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _check_folded("flash_attention", q, k, v)
    bh, n, d = q.shape
    qs = _scale_q(q)
    out = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    rc = build.library().vitocm_flash_fwd(
        build.DTYPE_CODES[q.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, n, d, build.stream_ptr(q.device))
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def _bwd_from_probs(q, k, v, o, e, do):
    """(dq, dk, dv) from the f32 softmax probabilities e (B*h, N, N), with
    the TPU kernels' rounding points."""
    dt = q.dtype
    qs, kf, vf = _scale_q(q).float(), k.float(), v.float()
    dd = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = (e * (do.float() @ vf.transpose(-1, -2) - dd)).to(dt).float()
    dq = ((ds @ kf).to(dt).float() * q.shape[-1] ** -0.5).to(dt)
    dk = (ds.transpose(-1, -2) @ qs).to(dt)
    dv = (e.to(dt).float().transpose(-1, -2) @ do.float()).to(dt)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """Plain PyTorch twin of :func:`flash_attention_bwd`, with the TPU
    kernel's rounding points, the whole (N, N) score matrix at once."""
    lse = torch.nan_to_num(lse.float(), nan=0.0, posinf=0.0, neginf=0.0)
    e = torch.exp(_scale_q(q).float() @ k.float().transpose(-1, -2) - lse[..., None])
    return _bwd_from_probs(q, k, v, o, e, do)


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of :func:`flash_attention` from its saved out o and lse
    and the cotangent do, all folded (B*h, N, d) but lse (B*h, N) float32;
    dq is with respect to the unscaled q. CPU tensors take the plain twin;
    CUDA tensors launch the kernels of :func:`flash_attention_bwd_route`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    _check_folded("flash_attention_bwd", q, k, v, o, do)
    bh, n, d = q.shape
    if lse.shape != (bh, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: want a contiguous float32 lse of shape {(bh, n)}")
    qs = _scale_q(q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # lse, rowsum(do o)
    stats = torch.empty((bh, 2, _stats_pitch(n)), dtype=torch.float32, device=q.device)
    rc = build.library().vitocm_flash_bwd(
        build.DTYPE_CODES[q.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), bh, n, d, build.stream_ptr(q.device))
    build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def p_columns(n: int) -> int:
    """Columns of the saved P for n keys: n rounded up to the key tile, so
    every P row is 16-byte aligned; the padded columns hold 0."""
    return -(-n // KEY_TILE) * KEY_TILE


def flash_attention_savep_plain(q, k, v):
    """Plain PyTorch twin of :func:`flash_attention_savep`, with the TPU
    kernel's rounding points: P = exp(s - row max) rounded to the storage
    type, the denominator summed from the rounded P."""
    n = q.shape[1]
    s = _scale_q(q).float() @ k.float().transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(q.dtype)
    denom = p.float().sum(-1, keepdim=True)
    out = (p.float() @ v.float()) / denom
    return out.to(q.dtype), F.pad(p, (0, p_columns(n) - n)), (1.0 / denom)[..., 0]


def flash_attention_savep(q, k, v):
    """The forward of the saved-P route for folded (B*h, N, d) q, k, v (q
    unscaled): (out in q's dtype, P (B*h, N, p_columns(N)) in q's dtype, inv
    (B*h, N) float32), P * inv being the softmax. CPU tensors take the plain
    twin; CUDA tensors launch the kernel of :func:`flash_attention_savep_route`
    (d in HEAD_DIMS, contiguous float32/bfloat16)."""
    if q.device.type == "cpu":
        return flash_attention_savep_plain(q, k, v)
    _check_folded("flash_attention_savep", q, k, v)
    bh, n, d = q.shape
    qs = _scale_q(q)
    out = torch.empty_like(q)
    p = torch.empty((bh, n, p_columns(n)), dtype=q.dtype, device=q.device)
    inv = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    rc = build.library().vitocm_flash_fwd_savep(
        build.DTYPE_CODES[q.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        p.data_ptr(), inv.data_ptr(), bh, n, p.shape[-1], d, build.stream_ptr(q.device))
    build.check(rc, "flash_attention_savep")
    flash_attention_savep.launches += 1
    return out, p, inv


def flash_attention_bwd_savep_plain(q, k, v, o, p, inv, do):
    """Plain PyTorch twin of :func:`flash_attention_bwd_savep`: e = P * inv
    in f32, then the rounding points of :func:`flash_attention_bwd_plain`."""
    e = p[..., :q.shape[1]].float() * inv.float()[..., None]
    return _bwd_from_probs(q, k, v, o, e, do)


def flash_attention_bwd_savep(q, k, v, o, p, inv, do):
    """(dq, dk, dv) of the saved-P route from the forward's out o, P and inv
    and the cotangent do, all folded (B*h, N, d) but P and inv as
    :func:`flash_attention_savep` returns them. CPU tensors take the plain
    twin; CUDA tensors launch the kernels of
    :func:`flash_attention_bwd_savep_route`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_savep_plain(q, k, v, o, p, inv, do)
    _check_folded("flash_attention_bwd_savep", q, k, v, o, do)
    bh, n, d = q.shape
    if (p.shape != (bh, n, p_columns(n)) or p.dtype != q.dtype or p.device != q.device
            or not p.is_contiguous() or p.data_ptr() % 16):
        raise ValueError(f"flash_attention_bwd_savep: want a contiguous {q.dtype} P of shape "
                         f"{(bh, n, p_columns(n))}, got {tuple(p.shape)} {p.dtype}")
    if inv.shape != (bh, n) or inv.dtype != torch.float32 or not inv.is_contiguous():
        raise ValueError(f"flash_attention_bwd_savep: want a contiguous float32 inv of shape "
                         f"{(bh, n)}")
    qs = _scale_q(q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # inv, rowsum(do o)
    stats = torch.empty((bh, 2, _stats_pitch(n)), dtype=torch.float32, device=q.device)
    rc = build.library().vitocm_flash_bwd_savep(
        build.DTYPE_CODES[q.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        p.data_ptr(), inv.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), bh, n, p.shape[-1], d, build.stream_ptr(q.device))
    build.check(rc, "flash_attention_bwd_savep")
    flash_attention_bwd_savep.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_savep.launches = 0
flash_attention_bwd_savep.launches = 0


class _FlashAttention(torch.autograd.Function):
    """flash_attention forward and flash_attention_bwd backward or, with
    save_p, flash_attention_savep and flash_attention_bwd_savep; all looked
    up in this module at call time, so the twins can stand in for a whole
    route."""

    @staticmethod
    def forward(ctx, q, k, v, save_p):
        fwd = flash_attention_savep if save_p else flash_attention
        out, *res = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, *res)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, *res = ctx.saved_tensors
        bwd = flash_attention_bwd_savep if len(res) == 2 else flash_attention_bwd
        return (*bwd(q, k, v, out, *res, do.contiguous()), None)


def flash_attention_trainable(q, k, v, save_p=False):
    """Differentiable softmax(q k^T / sqrt(d)) v for (B, h, N, d) q, k, v,
    the JAX package's layout: folded to (B*h, N, d) around the kernels.
    save_p saves P and 1/denominator for the backward (TRAIN.ATTN_SAVE_P
    on) instead of the logsumexp."""
    b, h, n, d = q.shape
    fold = lambda t: t.reshape(b * h, n, d).contiguous()  # noqa: E731
    return _FlashAttention.apply(fold(q), fold(k), fold(v), save_p).view(b, h, n, d)


def mha_flash(x, qkv_weight, qkv_bias, proj_weight, proj_bias, num_heads, prefer_folded=False,
              save_p=False, quant=False, int8=None):
    """Full MHSA block on the attention kernels: (B, N, D) -> (B, N, D).

    prefer_folded=False (inference): the qkvflat route, :func:`attention_qkv`
    on the fused projection, no gradient. prefer_folded=True (training): the
    folded route through :func:`flash_attention_trainable` (saving P with
    save_p), with the JAX package's roundings of the qkv projection (the
    product and the bias each rounded to x's dtype).

    quant=True (inference only, the --quant int8 route) runs the qkv and out
    projections as :func:`ops.quant.int8_dot`, the attention products staying
    in x's dtype, as the JAX package's ``mha_flash(quant=True)`` does: the
    flat branch quantizes the scaled qkv weight and adds its f32 bias before
    the one cast; the folded branch quantizes the raw weight and keeps that
    branch's two roundings. ``int8`` holds the weights quantized once
    (``models.vit.int8_weights``: "qkv" scaled, "proj"); without it they are
    quantized here."""
    b, n, dm = x.shape
    int8 = int8 or {}
    if quant:
        proj8 = int8.get("proj", proj_weight)
        pb = proj_bias.float() if proj_bias is not None else None
    if prefer_folded:
        if not quant:
            qkv = F.linear(x, qkv_weight)
            if qkv_bias is not None:
                qkv = qkv + qkv_bias.to(x.dtype)
            return attend_and_project(qkv, proj_weight, proj_bias, num_heads, save_p)
        qkv = qz.int8_dot(x, qkv_weight, out_dtype=x.dtype)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias.to(x.dtype)
        q, k, v = qkv.reshape(b, n, 3, num_heads, dm // num_heads).permute(2, 0, 3, 1, 4)
        out = flash_attention_trainable(q, k, v, save_p).transpose(1, 2).reshape(b, n, dm)
        return qz.int8_dot(out, proj8, pb, x.dtype)
    if quant:
        wq8 = int8.get("qkv")
        bq = int8.get("qkv_bias")
        if wq8 is None:
            wq, bq = _scaled_qkv_weights(qkv_weight, qkv_bias, num_heads)
            wq8 = qz.colwise_int8(wq)
        qkv = qz.int8_dot(x, wq8, bq, x.dtype)
        out = attention_qkv(qkv.contiguous(), num_heads, n)
        return qz.int8_dot(out, proj8, pb, x.dtype)
    wq, bq = _scaled_qkv_weights(qkv_weight, qkv_bias, num_heads)
    qkv = F.linear(x, wq, bq.to(x.dtype) if bq is not None else None)
    out = attention_qkv(qkv.contiguous(), num_heads, n)
    return F.linear(out, proj_weight, proj_bias)


def attend_and_project(qkv, proj_weight, proj_bias, num_heads, save_p=False):
    """The training attention after the qkv projection: (B, N, 3D) split
    into heads, :func:`flash_attention_trainable`, the out projection."""
    b, n, d3 = qkv.shape
    dm = d3 // 3
    q, k, v = qkv.reshape(b, n, 3, num_heads, dm // num_heads).permute(2, 0, 3, 1, 4)
    out = flash_attention_trainable(q, k, v, save_p).transpose(1, 2).reshape(b, n, dm)
    return F.linear(out, proj_weight, proj_bias)

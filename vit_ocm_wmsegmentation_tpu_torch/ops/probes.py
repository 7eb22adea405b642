"""The TPU kernel probes of ``tools/`` as CUDA kernels, with their plain twins.

* :func:`probe_matmul` is ``tools/probe_dot.py::matmul``: a tiled A B, bf16
  with f32 accumulation stored as bf16, or int8 with int32 accumulation
  stored as int8 (wrapped modulo 256, as XLA's convert does). Its kernel
  (``csrc/matmul_wgmma.cu``: wgmma fed by TMA) is also the int8 serving
  route's GEMM (:func:`ops.quant.int8_dot`, through :func:`launch_matmul`).
* :func:`probe_attention` runs one attention probe (``csrc/
  probe_attention_wgmma.cu``: wgmma fed by TMA; :func:`probe_attention_route`
  names it): ``tools/probe_dot.py::attn`` (variant "dot", int8 or bf16), the
  four modes of ``tools/bench_attention_variants.py`` and the nine distinct
  functions of ``tools/bench_attn_opt.py`` (:data:`VARIANTS`).

B operands come k-contiguous: :func:`probe_matmul` takes B transposed, (N,
K), which its callers make once, outside any timed region (8-bit wgmma reads
both operands K-major). The plain twins (``*_plain``) compute in f32 from the
rounded operands, integer products exactly (int64 on the CPU, float64 on the
card). CPU tensors take the twins; CUDA tensors launch the kernels or raise.
Each wrapper's ``launches`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import build

HEAD_DIM = 64  # the attention probes' head dim (ViT-S/8)
_PLAIN_GROUP_CHUNK = 16  # (batch, head) groups a plain-twin step holds
_LN2_F32, _LN2_BF16 = 0.693147182, 0.69140625  # ln 2 in f32 and in bf16


@dataclasses.dataclass(frozen=True)
class Variant:
    """One attention probe's function. layout: "folded_t" (q, kt, v),
    "folded" (q, k, v) or "qkvflat" (the fused (B, Np, 3 h d) projection);
    shift: "rowmax" (two passes), "none" or "cauchy" (|q_i| max_j |k_j|);
    exp: "exp", "exp2" (as XLA lowers it: exp(x ln 2), ln 2 and the product
    in the working type), "relu" or "ident"; sm: "f32", "bf16arg" (s - m and
    exp rounded to bf16) or "bf16all" (s too); den: "ones" (sum of the
    rounded P), "sum" (of the unrounded p), "sum1" (+ 1) or "none"."""

    layout: str
    shift: str
    exp: str
    sm: str = "f32"
    den: str = "ones"


_CODES = {"layout": ("folded_t", "folded", "qkvflat"), "shift": ("rowmax", "none", "cauchy"),
          "exp": ("exp", "exp2", "relu", "ident"), "sm": ("f32", "bf16arg", "bf16all"),
          "den": ("ones", "sum", "sum1", "none")}

VARIANTS = {
    # tools/probe_dot.py::attn: s / 16 + bias, p = exp(s - max) as int8 or bf16, unnormalized
    "dot": Variant("folded_t", "rowmax", "exp", den="none"),
    # tools/bench_attention_variants.py::make_variant modes
    "full": Variant("folded_t", "rowmax", "exp", den="sum"),
    "bf16exp": Variant("folded_t", "rowmax", "exp", "bf16arg", "sum"),
    "noexp": Variant("folded_t", "none", "relu", den="sum1"),
    "dotsonly": Variant("folded_t", "none", "ident", den="none"),
    # tools/bench_attn_opt.py's nine distinct functions
    "v0": Variant("folded_t", "rowmax", "exp"),
    "exp2": Variant("folded_t", "rowmax", "exp2"),
    "nomax": Variant("folded_t", "none", "exp"),
    "normbound": Variant("folded_t", "cauchy", "exp"),
    "bf16sm": Variant("folded_t", "rowmax", "exp2", "bf16all"),
    "combo": Variant("folded", "cauchy", "exp"),
    "qkvflat": Variant("qkvflat", "cauchy", "exp"),
    "qkvflat_pipe2": Variant("qkvflat", "cauchy", "exp2"),
    "qkvflat_pipe2b": Variant("qkvflat", "cauchy", "exp2", "bf16arg"),
}


def exact_product(a, b):
    """a @ b in f32; for int8 operands the integer product exactly (int64 on
    the CPU, float64 on the card: |sums| stay far below 2^53), then rounded
    to f32 once, as the kernels' int32 accumulators are."""
    if a.dtype == torch.int8:
        return _integer_product(a, b).float()
    return a.float() @ b.float()


def _integer_product(a, b):
    """The exact int64 product of int8 a and b."""
    if a.device.type == "cpu":
        return a.long() @ b.long()
    return (a.double() @ b.double()).long()


def _wrap_int8(x):
    """Exact integer sums -> int8, wrapped modulo 256 as XLA converts int32
    to int8."""
    return (torch.remainder(x + 128, 256) - 128).to(torch.int8)


def _check_cuda(name, *ts):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: no kernel for device {t.device}")
    check_layout(name, *ts)


def check_layout(name, *ts):
    """Raises ValueError unless the tensors are contiguous, 16-byte aligned
    and on one device, as the kernels' 16-byte and TMA loads need."""
    for t in ts:
        if t.device != ts[0].device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: want contiguous, 16-byte aligned tensors on one device, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _matmul_plan(a, bt, out_dtype, dequant):
    """(dtype code, epilogue) of csrc/matmul_wgmma.cu for these operands;
    raises ValueError on what the kernel does not take."""
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1] or a.dtype != bt.dtype:
        raise ValueError(f"matmul: want (M, K) and (N, K) of one dtype, got {tuple(a.shape)} "
                         f"{a.dtype} and {tuple(bt.shape)} {bt.dtype}")
    (m, k), n = a.shape, bt.shape[0]
    if (k * a.element_size()) % 16 or m < 1 or n < 1 or k < 1:
        raise ValueError(f"matmul: K * itemsize must be a multiple of 16 bytes, got K={k} "
                         f"{a.dtype}")
    if a.dtype == torch.bfloat16 and not dequant and out_dtype == torch.bfloat16:
        return build.DTYPE_CODES[torch.bfloat16], 0
    if a.dtype == torch.int8 and not dequant and out_dtype == torch.int8:
        return build.INT8_CODE, 0
    if a.dtype == torch.int8 and dequant and out_dtype in (torch.float32, torch.bfloat16):
        return build.INT8_CODE, 1 if out_dtype == torch.float32 else 2
    raise ValueError(f"matmul: no kernel for {a.dtype} operands to {out_dtype} "
                     f"(dequant={dequant})")


def matmul_route(a, bt, out_dtype, dequant=False) -> str:
    """The kernel source a CUDA call of :func:`launch_matmul` with these
    operands launches: "matmul_wgmma.cu", for bf16 -> bf16, int8 -> int8 and,
    dequantized, int8 -> f32 or bf16. Reads only shapes and dtypes, so a CPU
    tensor stands for its CUDA copy; raises on what the kernel does not take."""
    _matmul_plan(a, bt, out_dtype, dequant)
    return "matmul_wgmma.cu"


def launch_matmul(a, bt, out_dtype, sx=None, sw=None, bias=None):
    """C = a @ bt.T on the kernel of csrc/matmul_wgmma.cu, for (M, K) a and
    (N, K) bt of one dtype: bf16 -> bf16 (stored), int8 -> int8 (stored,
    wrapped) or, with the row and column scales sx (M,) and sw (N,) and an
    optional bias (N,), int8 -> f32 or bf16 dequantized. Raises on anything
    the kernel does not take; the callers count the launch."""
    _check_cuda("matmul", a, bt)
    dequant = sx is not None
    code, epi = _matmul_plan(a, bt, out_dtype, dequant)
    (m, k), n = a.shape, bt.shape[0]
    ptrs = [0, 0, 0]
    if dequant:
        vecs = [sx, sw] + ([bias] if bias is not None else [])
        vecs = [v.float().contiguous() for v in vecs]
        for v, size in zip(vecs, (m, n, n)):
            if v.numel() != size or v.device != a.device:
                raise ValueError(f"matmul: scales and bias must hold (M,), (N,), (N,) values on "
                                 f"{a.device}")
        ptrs[:len(vecs)] = [v.data_ptr() for v in vecs]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    rc = build.library().vitocm_matmul(code, epi, a.data_ptr(), bt.data_ptr(), out.data_ptr(),
                                       *ptrs, m, n, k, build.stream_ptr(a.device))
    build.check(rc, "matmul")
    return out


def probe_matmul_plain(a, bt):
    """Plain PyTorch twin of :func:`probe_matmul`."""
    if a.dtype == torch.int8:
        return _wrap_int8(_integer_product(a, bt.T))
    return exact_product(a, bt.T).to(a.dtype)


def probe_matmul(a, bt):
    """``tools/probe_dot.py::matmul``'s product a @ b for (M, K) a and the
    transposed (N, K) bt, both bfloat16 or both int8, in their dtype. CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return probe_matmul_plain(a, bt)
    out = launch_matmul(a, bt, a.dtype)
    probe_matmul.launches += 1
    return out


probe_matmul.launches = 0


def _split(variant, q, k, v, heads):
    """(q, kt, v) as (G, rows, 64), (G, 64, Nk), (G, Nk, 64) views of a
    probe's inputs, G groups of one (batch, head)."""
    if variant.layout == "qkvflat":
        b, rows, cols = q.shape
        t = q.reshape(b, rows, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4).reshape(
            3, b * heads, rows, HEAD_DIM)
        return t[0], t[1].transpose(1, 2), t[2]
    kt = k if variant.layout == "folded_t" else k.transpose(1, 2)
    return q, kt, v[..., :HEAD_DIM]


def _probe_plain_group(variant, q, kt, v, bias, scale):
    bf16 = torch.bfloat16
    s = exact_product(q, kt) * scale + bias.float()
    if variant.sm == "bf16all":
        s = s.to(bf16).float()
    if variant.shift == "rowmax":
        x = s - s.amax(-1, keepdim=True)
    elif variant.shift == "cauchy":
        qn = torch.sqrt((q.float() ** 2).sum(-1, keepdim=True))
        kmax = torch.sqrt((kt.float() ** 2).sum(-2).amax(-1))
        x = s - qn * kmax[:, None, None]
    else:
        x = s
    if variant.sm != "f32":
        x = x.to(bf16).float()
    if variant.exp == "exp2":  # as XLA lowers exp2: exp(x ln 2) in the working type
        f = torch.exp((x * _LN2_BF16).to(bf16).float() if variant.sm != "f32" else x * _LN2_F32)
    else:
        f = {"exp": torch.exp, "relu": torch.relu, "ident": lambda y: y}[variant.exp](x)
    if variant.sm != "f32":
        f = f.to(bf16).float()
    if q.dtype == torch.int8:
        p = torch.trunc(f * 127.0)
        o = exact_product(p.to(torch.int8), v)
    else:
        p = f.to(bf16)
        o = exact_product(p, v)
        p = p.float()
    if variant.den == "ones":
        o = o / p.sum(-1, keepdim=True)
    elif variant.den == "sum":
        o = o / f.sum(-1, keepdim=True)
    elif variant.den == "sum1":
        o = o / (f.sum(-1, keepdim=True) + 1.0)
    return o.to(bf16)


def probe_attention_plain(variant, q, k=None, v=None, bias=None, scale=1.0, heads=None):
    """Plain PyTorch twin of :func:`probe_attention`: whole score rows (the
    final row max, no tiling), in chunks of (batch, head) groups."""
    var = VARIANTS[variant]
    qq, kt, vv = _split(var, q, k, v, heads)
    outs = [_probe_plain_group(var, qq[i:i + _PLAIN_GROUP_CHUNK], kt[i:i + _PLAIN_GROUP_CHUNK],
                               vv[i:i + _PLAIN_GROUP_CHUNK], bias, scale)
            for i in range(0, qq.shape[0], _PLAIN_GROUP_CHUNK)]
    o = torch.cat(outs)
    if var.layout != "qkvflat":
        return o
    b, rows, _ = q.shape
    o = o.reshape(b, heads, rows, HEAD_DIM).permute(0, 2, 1, 3).reshape(b, rows, heads * HEAD_DIM)
    return torch.cat([o, o, o], dim=-1)


def _probe_plan(variant, q, k, v, bias, heads):
    """(groups, query rows, keys, vstride) of a call of csrc/probe_attention_wgmma.cu;
    raises ValueError on what the kernel does not take."""
    var = VARIANTS.get(variant)
    if var is None:
        raise ValueError(f"probe_attention: no variant {variant!r}; want one of {sorted(VARIANTS)}")
    qkvflat = var.layout == "qkvflat"
    ts = (q, bias) if qkvflat else (q, k, v, bias)
    int8 = q.dtype == torch.int8
    if q.dtype not in (torch.bfloat16, torch.int8) or (int8 and variant != "dot") or any(
            t.dtype != q.dtype for t in ts[1:-1]) or bias.dtype != torch.float32:
        raise ValueError(f"probe_attention: {variant} takes bfloat16 operands (int8 for 'dot' "
                         f"only) and a float32 bias, got {q.dtype}")
    align = 16 if int8 else 8  # elements in 16 bytes: TMA's row strides
    if qkvflat:
        if heads is None or q.dim() != 3 or q.shape[-1] != 3 * heads * HEAD_DIM or heads < 1:
            raise ValueError(f"probe_attention: want qkv (B, Np, 3 * heads * {HEAD_DIM}), got "
                             f"{tuple(q.shape)} for heads={heads}")
        groups, rq, nk, vstride = q.shape[0] * heads, q.shape[1], q.shape[1], 0
    else:
        if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
            raise ValueError(f"probe_attention: want 3-D q, k, v, got {tuple(q.shape)} "
                             f"{tuple(k.shape)} {tuple(v.shape)}")
        groups, rq, d = q.shape
        nk = k.shape[2] if var.layout == "folded_t" else k.shape[1]
        kshape = (groups, HEAD_DIM, nk) if var.layout == "folded_t" else (groups, nk, HEAD_DIM)
        vstride = v.shape[2]
        if (d != HEAD_DIM or tuple(k.shape) != kshape or v.shape[:2] != (groups, nk)
                or vstride < HEAD_DIM or vstride % align):
            raise ValueError(f"probe_attention: want q (G, Rq, {HEAD_DIM}), k {kshape}, v (G, Nk, "
                             f">= {HEAD_DIM}, a multiple of {align}), got {tuple(q.shape)} "
                             f"{tuple(k.shape)} {tuple(v.shape)}")
        if var.layout == "folded_t" and nk % align:
            raise ValueError(f"probe_attention: kt's keys must be a multiple of {align}, got {nk}")
    if min(groups, rq, nk) < 1:
        raise ValueError(f"probe_attention: empty operands {tuple(q.shape)}")
    if bias.dim() != 1 or bias.numel() != nk:
        raise ValueError(f"probe_attention: want a bias of {nk} keys, got {tuple(bias.shape)}")
    check_layout("probe_attention", *ts)
    return groups, rq, nk, vstride


def probe_attention_route(variant, q, k=None, v=None, bias=None, heads=None) -> str:
    """The kernel source a CUDA call of :func:`probe_attention` with these
    operands launches: "probe_attention_wgmma.cu", for every variant (int8
    for "dot" only). Reads only shapes, dtypes and layouts, so a CPU tensor
    stands for its CUDA copy; raises ValueError on what the kernel does not
    take: contiguous, 16-byte aligned operands on one device whose rows are
    multiples of 16 bytes (TMA's strides), with a bias of one value a key."""
    _probe_plan(variant, q, k, v, bias, heads)
    return "probe_attention_wgmma.cu"


def probe_attention(variant, q, k=None, v=None, bias=None, scale=1.0, heads=None):
    """One attention probe of :data:`VARIANTS`, head dim 64, bf16 output.

    "folded_t" variants take q (G, Rq, 64), kt (G, 64, Nk) and v (G, Nk, Dv)
    (its first 64 columns are read); "folded" q, k (G, Nk, 64), v (G, Nk, 64);
    "qkvflat" the projection q = (B, Np, 3 * heads * 64) alone and returns (B,
    Np, 3 * heads * 64) with o in all three sections. bias (Nk,) f32 is added
    to the scaled scores (-1e30 masks a key). Operands bf16; variant "dot"
    also int8. CPU tensors take the plain twin; CUDA tensors launch the
    kernel of :func:`probe_attention_route` or raise."""
    var = VARIANTS[variant]
    if q.device.type == "cpu":
        return probe_attention_plain(variant, q, k, v, bias, scale, heads)
    qkvflat = var.layout == "qkvflat"
    _check_cuda("probe_attention", *((q, bias) if qkvflat else (q, k, v, bias)))
    groups, rq, nk, vstride = _probe_plan(variant, q, k, v, bias, heads)
    out = torch.empty_like(q, dtype=torch.bfloat16) if qkvflat else torch.empty(
        (groups, rq, HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    kmax = torch.empty(groups, dtype=torch.float32, device=q.device)
    codes = [_CODES[f].index(getattr(var, f)) for f in ("layout", "shift", "exp", "sm", "den")]
    dtype_code = build.INT8_CODE if q.dtype == torch.int8 else build.DTYPE_CODES[torch.bfloat16]
    kp, vp = (0, 0) if qkvflat else (k.data_ptr(), v.data_ptr())
    rc = build.library().vitocm_probe_attention(
        dtype_code, *codes, q.data_ptr(), kp, vp, bias.data_ptr(), kmax.data_ptr(),
        out.data_ptr(), groups, rq, nk, vstride, heads or 1, float(scale),
        build.stream_ptr(q.device))
    build.check(rc, f"probe_attention[{variant}]")
    probe_attention.launches += 1
    return out


probe_attention.launches = 0

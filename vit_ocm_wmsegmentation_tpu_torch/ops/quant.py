"""Dynamic int8 (W8A8) inference quantization: the int8 serving route.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/quant.py``. Activations are
quantized per row on the fly (``rowwise_int8``: scale max|x_row| / 127, true
division, round half to even, clip to +-127, scale 1 for an all-zero row),
weights per output channel once per model (``colwise_int8``, on nn.Linear's
(out, in) layout: one scale per row of the weight). The product accumulates
in int32 and is dequantized as ``(float(acc) * s_x) * s_w``, then the bias is
added in f32 and the sum cast once to the output dtype.

:func:`int8_dot` runs two kernels for CUDA tensors: :func:`quantize_rows`
(``csrc/quantize_rows.cu``: the row quantization in one pass, where the JAX
package leaves it to XLA) and the int8 GEMM of ``csrc/matmul_wgmma.cu`` with
its dequant epilogue; for CPU tensors it takes :func:`int8_dot_plain`;
anything else raises. ``int8_dot.launches`` counts its calls on the card (a
quantizer and a GEMM launch each), ``quantize_rows.launches`` the
quantizer's launches; the ``launches_by_shape`` of each counts the same
launches by row width ("384") or projection ("384->1152").
"""

from __future__ import annotations

import torch

from .. import build
from . import probes

QUANT_K_MAX = 4096  # the widest row csrc/quantize_rows.cu holds in registers


def rowwise_int8(x):
    """(..., K) float -> (int8 values (..., K), (..., 1) f32 scales). The
    divisor 127 is a tensor on x's device: torch on CUDA would divide by a
    Python scalar as a product with its f32 reciprocal, which differs from
    the true quotient (the JAX package's) in the last bit of some scales."""
    x = x.float()
    amax = x.abs().amax(-1, keepdim=True)
    s = amax / torch.full_like(amax, 127.0)
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def colwise_int8(w):
    """(out, in) float weight -> (int8 values (out, in), (out,) f32 scales),
    one scale per output channel: the JAX package's ``_colwise_int8`` of the
    (in, out) transpose."""
    q, s = rowwise_int8(w)
    return q, s[:, 0]


def _weight(weight):
    """A prepared (q, scale) pair as it is, a float weight quantized here."""
    return weight if isinstance(weight, tuple) else colwise_int8(weight)


def quantize_route(x) -> str:
    """The kernel source a CUDA call of :func:`quantize_rows` on x launches:
    "quantize_rows.cu", for contiguous, 16-byte aligned float32 or bfloat16
    rows of K a multiple of 16 in [16, QUANT_K_MAX]. Reads only the shape,
    dtype and layout, so a CPU tensor stands for its CUDA copy; raises
    ValueError on what the kernel does not take."""
    k = x.shape[-1] if x.dim() else 0
    if x.dtype not in build.DTYPE_CODES or k % 16 or not 16 <= k <= QUANT_K_MAX:
        raise ValueError(f"quantize_rows: want float32 or bfloat16 rows with K a multiple of 16 "
                         f"in [16, {QUANT_K_MAX}], got K={k} {x.dtype}")
    probes.check_layout("quantize_rows", x)
    return "quantize_rows.cu"


def quantize_rows(x):
    """:func:`rowwise_int8` of (..., K) float32 or bfloat16 rows: (int8
    values (..., K), (..., 1) float32 scales). CPU tensors take the plain
    twin; CUDA tensors launch the kernel of csrc/quantize_rows.cu (see
    :func:`quantize_route`), whose outputs are bit-equal to the twin's."""
    if x.device.type == "cpu":
        return rowwise_int8(x)
    probes._check_cuda("quantize_rows", x)
    quantize_route(x)
    k = x.shape[-1]
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    rc = build.library().vitocm_quantize_rows(build.DTYPE_CODES[x.dtype], x.data_ptr(),
                                              xq.data_ptr(), s.data_ptr(), x.numel() // k, k,
                                              build.stream_ptr(x.device))
    build.check(rc, "quantize_rows")
    quantize_rows.launches += 1
    _count(quantize_rows, str(k))
    return xq, s


def int8_dot_plain(x, weight, bias=None, out_dtype=torch.float32):
    """Plain PyTorch twin of :func:`int8_dot`: the integer product exactly
    (int64 on the CPU, float64 on the card), then the kernel's dequant."""
    wq, sw = _weight(weight)
    xq, sx = rowwise_int8(x)
    acc = probes.exact_product(xq, wq.T)
    y = acc * sx * sw
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_dot(x, weight, bias=None, out_dtype=torch.float32):
    """Quantized ``x @ weight.T (+ bias)``: (..., K) x (N, K) -> (..., N) in
    ``out_dtype`` (float32 or bfloat16). ``weight`` is an (N, K) float weight
    or its ``colwise_int8`` pair (the route quantizes weights once). CPU
    tensors take the plain twin; CUDA tensors launch :func:`quantize_rows`
    and the int8 GEMM (K a multiple of 16)."""
    if x.device.type == "cpu":
        return int8_dot_plain(x, weight, bias, out_dtype)
    wq, sw = _weight(weight)
    xq, sx = quantize_rows(x.contiguous())
    lead = x.shape[:-1]
    out = probes.launch_matmul(xq.reshape(-1, xq.shape[-1]), wq, out_dtype,
                               sx=sx.reshape(-1), sw=sw, bias=bias)
    int8_dot.launches += 1
    _count(int8_dot, f"{xq.shape[-1]}->{wq.shape[0]}")
    return out.reshape(*lead, wq.shape[0])


def _count(wrapper, shape):
    wrapper.launches_by_shape[shape] = wrapper.launches_by_shape.get(shape, 0) + 1


quantize_rows.launches = int8_dot.launches = 0
quantize_rows.launches_by_shape, int8_dot.launches_by_shape = {}, {}

"""Dynamic int8 (W8A8) inference quantization: the int8 serving route.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/quant.py``. Activations are
quantized per row on the fly (``rowwise_int8``: scale max|x_row| / 127, true
division, round half to even, clip to +-127, scale 1 for an all-zero row),
weights per output channel once per model (``colwise_int8``, on nn.Linear's
(out, in) layout: one scale per row of the weight). The product accumulates
in int32 and is dequantized as ``(float(acc) * s_x) * s_w``, then the bias is
added in f32 and the sum cast once to the output dtype.

:func:`int8_dot` launches the int8 GEMM of ``csrc/matmul_mma.cu`` (its
dequant epilogue) for CUDA tensors and takes :func:`int8_dot_plain` for CPU
tensors; anything else raises. The row quantization stays plain torch ops on
the card, as it is XLA in the JAX package. ``int8_dot.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from . import probes


def rowwise_int8(x):
    """(..., K) float -> (int8 values (..., K), (..., 1) f32 scales)."""
    x = x.float()
    s = x.abs().amax(-1, keepdim=True) / 127.0
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
    tensors take the plain twin; CUDA tensors launch the int8 GEMM
    (K a multiple of 16)."""
    if x.device.type == "cpu":
        return int8_dot_plain(x, weight, bias, out_dtype)
    wq, sw = _weight(weight)
    xq, sx = rowwise_int8(x)
    lead = x.shape[:-1]
    out = probes.launch_matmul(xq.reshape(-1, xq.shape[-1]), wq, out_dtype,
                               sx=sx.reshape(-1), sw=sw, bias=bias)
    int8_dot.launches += 1
    return out.reshape(*lead, wq.shape[0])


int8_dot.launches = 0

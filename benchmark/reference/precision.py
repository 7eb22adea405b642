"""Arithmetic precisions of the plain reference.

The reference computes in float32 with TF32 off. The controls of the
correctness check put the same reference in the program's place one step
below the precision a configuration states: TF32 for float32, float8 (e4m3)
for bfloat16. Both are simulated, so that the CPU and the card compute the
same control. TF32 is a format of products only: each operand is the float32
value rounded to nearest (ties to even) at 10 bits of mantissa, multiplied
in float32. Float8 is computed as the bfloat16 program computes in bfloat16:
every tensor the computation stores (the input, the token stream after each
residual add, LayerNorm outputs, projections, attention probabilities and
outputs, the MLP's hidden units) is held in e4m3, and every product reads
e4m3 operands and accumulates in float32. A tensor is held in e4m3 under a
per-tensor power-of-two scale that brings its largest magnitude to at most
448; products of e4m3 values run as bfloat16 products with a float32
accumulation, which is exact for them.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32", "fp8")
_E4M3_MAX = 448.0


@contextlib.contextmanager
def matmul_flags(precision: str):
    """Library matmuls and convolutions in full float32 (no TF32, no
    reduced-precision bf16 reductions); the caller's flags are restored on
    exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


class _RoundFP8(torch.autograd.Function):
    """Forward: the e4m3 value of x under a power-of-two scale. Backward:
    the gradient passes unchanged (the rounded value is what the product
    saves, so the backward products read it)."""

    @staticmethod
    def forward(ctx, x):
        if not x.numel():
            return x.clone()
        amax = x.detach().abs().amax().float()
        ok = (amax > 0) & torch.isfinite(amax)
        safe = torch.where(ok, amax, torch.ones_like(amax))
        scale = torch.where(ok, torch.exp2(torch.floor(torch.log2(_E4M3_MAX / safe))),
                            torch.ones_like(amax)).to(x.dtype)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundTF32(torch.autograd.Function):
    """Forward: x rounded to TF32 (10 mantissa bits, to nearest, ties to
    even). Backward: the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def round_operand(x, precision: str):
    """x as a product reads it under ``precision``."""
    if precision == "fp8":
        return _RoundFP8.apply(x)
    if precision == "tf32":
        return _RoundTF32.apply(x)
    return x


def store(x, precision: str):
    """x as the computation holds it under ``precision``: e4m3 for "fp8",
    unchanged otherwise (TF32 stores float32)."""
    return _RoundFP8.apply(x) if precision == "fp8" else x


def matmul(a, b, precision: str):
    """a @ b in float32 on operands rounded to ``precision``, as float32."""
    if precision == "tf32":
        return round_operand(a, precision) @ round_operand(b, precision)
    if precision != "fp8":
        return a @ b
    a8, b8 = round_operand(a, precision), round_operand(b, precision)
    return (a8.to(torch.bfloat16) @ b8.to(torch.bfloat16)).float()


def linear(x, weight, bias, precision: str):
    """x @ weight.T + bias, the bias added in float32."""
    y = matmul(x, weight.t(), precision)
    return y + bias if bias is not None else y

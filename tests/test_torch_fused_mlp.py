"""The port's fused MLP blocks against the JAX package's kernels and stock
composition, on identical inputs (CPU: the wrappers take their plain twins).

Weights: the JAX functions take w1 (D, H) and w2 (H, D); the port takes
nn.Linear's fc1.weight (H, D) and fc2.weight (D, H).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_ocm_wmsegmentation_tpu import nn as jnn
from vit_ocm_wmsegmentation_tpu.ops import fused_mlp as jfm
from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as tfm

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

R, D, H = 70, 64, 256  # 70 rows: not a multiple of any row tile


def _inputs(seed, r=R, d=D, h=H):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0, mean=0.0: (rng.normal(size=s) * std + mean).astype(np.float32)  # noqa: E731
    return {"x": f(r, d, std=2.0, mean=0.5), "s": f(d, std=0.1, mean=1.0), "b": f(d, std=0.1),
            "w1": f(d, h, std=d ** -0.5), "b1": f(h, std=0.1), "w2": f(h, d, std=h ** -0.5),
            "b2": f(d, std=0.1), "s2": f(d, std=0.1, mean=1.0), "bb2": f(d, std=0.1)}


def _jax_args(a, dtype):
    c = lambda k: jnp.asarray(a[k]).astype(dtype)  # noqa: E731
    return [c(k) for k in ("x", "s", "b", "w1", "b1", "w2", "b2")], (c("s2"), c("bb2"))


def _torch_args(a, dtype):
    c = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)  # noqa: E731
    mlp = [c(a["x"]), c(a["s"]), c(a["b"]), c(a["w1"].T), c(a["b1"]), c(a["w2"].T), c(a["b2"])]
    return mlp, (c(a["s2"]), c(a["bb2"]))


def _stock(a):
    """The JAX package's stock composition: layer_norm, linear, exact gelu."""
    x = jnp.asarray(a["x"])
    h = jnn.layer_norm({"scale": jnp.asarray(a["s"]), "bias": jnp.asarray(a["b"])}, x, 1e-6)
    h = jnn.gelu(jnn.linear({"kernel": jnp.asarray(a["w1"]), "bias": jnp.asarray(a["b1"])}, h))
    out = x + jnn.linear({"kernel": jnp.asarray(a["w2"]), "bias": jnp.asarray(a["b2"])}, h)
    z = jnn.layer_norm({"scale": jnp.asarray(a["s2"]), "bias": jnp.asarray(a["bb2"])}, out, 1e-6)
    return np.asarray(out), np.asarray(z)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_mlp_lnout_matches_jax_kernel_and_stock(seed):
    a = _inputs(seed)
    jm, jl = _jax_args(a, jnp.float32)
    jout, jz = jfm.fused_mlp_block_lnout(*jm, *jl, 1e-6, jfm.DEFAULT_BLOCK_R, True)
    tm, tl = _torch_args(a, torch.float32)
    out, z = tfm.fused_mlp_block_lnout(*tm, *tl, 1e-6)
    # rational erf (JAX kernel) vs erf (port) plus summation order
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-5)
    sout, sz = _stock(a)
    np.testing.assert_allclose(out.numpy(), sout, rtol=0, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), sz, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_fused_mlp_block_matches_jax_kernel_and_stock(seed):
    a = _inputs(seed)
    jm, _ = _jax_args(a, jnp.float32)
    jout = jfm.fused_mlp_block(*jm, 1e-6, jfm.DEFAULT_BLOCK_R, True)
    tm, _ = _torch_args(a, torch.float32)
    out = tfm.fused_mlp_block(*tm, 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), _stock(a)[0], rtol=0, atol=1e-5)


def test_fused_mlp_bf16_matches_jax_kernel_bf16():
    """bf16 storage rounded at the same points as the JAX kernel; a
    one-ulp flip of bf16 (2^-8 relative, values up to ~8) bounds the gap."""
    a = _inputs(4)
    jm, jl = _jax_args(a, jnp.bfloat16)
    jout, jz = jfm.fused_mlp_block_lnout(*jm, *jl, 1e-6, jfm.DEFAULT_BLOCK_R, True)
    jplain = jfm.fused_mlp_block(*jm, 1e-6, jfm.DEFAULT_BLOCK_R, True)
    tm, tl = _torch_args(a, torch.bfloat16)
    out, z = tfm.fused_mlp_block_lnout(*tm, *tl, 1e-6)
    plain = tfm.fused_mlp_block(*tm, 1e-6)
    assert out.dtype == z.dtype == plain.dtype == torch.bfloat16
    for got, want in ((out, jout), (z, jz), (plain, jplain)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("r,d,h", [(70, 192, 768), (200, 192, 800), (130, 384, 1536),
                                   (200, 384, 1568)])
def test_fused_mlp_twins_match_jax_kernels_at_kernel_widths(r, d, h, dtype):
    """The twins the wgmma kernel is held to on the card, against the JAX
    kernels in interpret mode, at the kernels' widths D, row counts that are
    no multiple of its 128-row tile, and H a multiple of its 32-unit chunk
    (800 and 1568 of no larger power of two). f32 within 1e-5; bf16: one
    bf16 ulp of a rounded out (or z) apart at most, 2^-7 of max|out|."""
    a = _inputs(r + d, r, d, h)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    assert h % tfm.HIDDEN_CHUNK == 0 and d in tfm.KERNEL_WIDTHS
    jm, jl = _jax_args(a, jdt)
    jout, jz = jfm.fused_mlp_block_lnout(*jm, *jl, 1e-6, jfm.DEFAULT_BLOCK_R, True)
    jplain = jfm.fused_mlp_block(*jm, 1e-6, jfm.DEFAULT_BLOCK_R, True)
    tm, tl = _torch_args(a, tdt)
    out, z = tfm.fused_mlp_block_lnout(*tm, *tl, 1e-6)
    plain = tfm.fused_mlp_block(*tm, 1e-6)
    for got, want in ((out, jout), (z, jz), (plain, jplain)):
        assert got.dtype == tdt
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()

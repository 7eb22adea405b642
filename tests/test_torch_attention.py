"""The port's attention against the JAX package's, on identical inputs.

The port's wrappers take their plain twins on CPU tensors, so these tests
hold the twins' arithmetic against the JAX Pallas kernel (interpret mode)
and the JAX stock attention; the CUDA kernels are held against the same
twins on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_ocm_wmsegmentation_tpu.ops import attention as jatt
from vit_ocm_wmsegmentation_tpu.ops import flash_attention_mod as jfa
from vit_ocm_wmsegmentation_tpu_torch.ops import attention as tatt
from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as tfa

from port_helpers import one_torch_thread  # noqa: F401  (autouse)


def _weights(rng, d, bias=True):
    w = {"wqkv": rng.normal(0, 0.3, (d, 3 * d)).astype(np.float32),
         "wo": rng.normal(0, 0.3, (d, d)).astype(np.float32),
         "bo": rng.normal(0, 0.1, d).astype(np.float32)}
    if bias:
        w["bqkv"] = rng.normal(0, 0.1, 3 * d).astype(np.float32)
    return w


def _torch_weights(w):
    """JAX (in, out) kernels -> nn.Linear (out, in) tensors."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(w["wqkv"].T), t(w["bqkv"]) if "bqkv" in w else None, t(w["wo"].T), t(w["bo"]))


@pytest.mark.parametrize("b,n,h,d", [(2, 37, 6, 64), (3, 73, 2, 16)])
def test_attention_qkv_plain_matches_jax_kernel(b, n, h, d):
    rng = np.random.default_rng(n)
    np_ = -(-n // 128) * 128  # the JAX kernel's padded row count
    qkv = rng.normal(size=(b, np_, 3 * h * d)).astype(np.float32)
    qkv[..., : h * d] *= d ** -0.5  # q section pre-scaled
    want = np.asarray(jfa.attention_qkv(jnp.asarray(qkv), h, n, True))[:, :n]
    got = tfa.attention_qkv(torch.from_numpy(qkv), h, n)[:, :n].numpy()
    # row max (port) against the Cauchy-Schwarz bound (JAX) as the exp shift
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("n", [1, 63, 65, 129, 200])
def test_attention_qkv_twin_matches_jax_kernel_at_kernel_head_dims(n, d, dtype):
    """The twin the wgmma kernel is held to on the card, against the JAX
    kernel in interpret mode, at the kernels' head dims and ragged n (one
    key; one past, one short of, the 64-key tile; 200). f32 as above; bf16:
    both round P and the output to bf16 but shift exp differently (running
    row max against the Cauchy-Schwarz bound), so an output may land one
    bf16 ulp away, 2^-7 of max|out| at most."""
    rng = np.random.default_rng(n + d)
    h = 2
    qkv = rng.normal(size=(2, -(-n // 128) * 128, 3 * h * d)).astype(np.float32)
    qkv[..., : h * d] *= d ** -0.5
    jq = jnp.asarray(qkv, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32)))
    if dtype == "bf16":
        tq = tq.to(torch.bfloat16)
    want = np.asarray(jfa.attention_qkv(jq, h, n, True).astype(jnp.float32))[:, :n]
    got = tfa.attention_qkv(tq, h, n)
    assert got.dtype == tq.dtype
    got = got[:, :n].float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("h,d", [(6, 64), (2, 16)])
def test_attention_qkv_masks_keys_past_n(h, d):
    """Rows >= n of the input never reach rows < n of the output."""
    rng = np.random.default_rng(1)
    qkv = rng.normal(size=(2, 40, 3 * h * d)).astype(np.float32)
    other = qkv.copy()
    other[:, 33:] = rng.normal(size=other[:, 33:].shape) * 50
    a = tfa.attention_qkv(torch.from_numpy(qkv), h, 33)[:, :33]
    b = tfa.attention_qkv(torch.from_numpy(other), h, 33)[:, :33]
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,bias", [(37, True), (50, False)])
def test_mha_flash_matches_jax_stock_mha(n, bias):
    rng = np.random.default_rng(3)
    d, h = 32, 2
    w = _weights(rng, d, bias)
    x = rng.normal(size=(2, n, d)).astype(np.float32)
    want = np.asarray(jatt.mha(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}, h))
    got = tfa.mha_flash(torch.from_numpy(x), *_torch_weights(w), h).numpy()
    # the scale folded into the q weights (f32) vs applied to the logits
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    plain = tatt.mha(torch.from_numpy(x), *_torch_weights(w), h).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("n,h", [(37, 2), (65, 4)])
def test_cls_row_attention_matches_jax(n, h):
    rng = np.random.default_rng(n)
    d = 32
    w = _weights(rng, d)
    x = rng.normal(size=(3, n, d)).astype(np.float32)
    want = np.asarray(jatt.cls_row_attention(jnp.asarray(x),
                                             {k: jnp.asarray(v) for k, v in w.items()}, h))
    qkv_w, qkv_b, _, _ = _torch_weights(w)
    got = tatt.cls_row_attention(torch.from_numpy(x), qkv_w, qkv_b, h).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # softmax of f32 logits


@pytest.mark.parametrize("n,h", [(37, 2), (65, 4)])
def test_cls_row_attention_bf16_keeps_f32_probabilities(n, h):
    """bf16 parity with the JAX function: both take the same bf16 inputs,
    compute f32 logits and an f32 softmax, and return the probabilities
    rounded to bf16. The f32 summation orders differ, so a value may land
    one bf16 ulp away (2^-7 relative at most)."""
    rng = np.random.default_rng(n + 1)
    d = 32
    w = _weights(rng, d)
    x = rng.normal(size=(3, n, d)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jatt.cls_row_attention(jx, {k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()}, h)
    assert want.dtype == jnp.bfloat16
    bf16 = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)).to(torch.bfloat16)  # noqa: E731
    qkv_w, qkv_b = bf16(w["wqkv"].T), bf16(w["bqkv"])
    got = tatt.cls_row_attention(bf16(x), qkv_w, qkv_b, h)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2.0**-7,
                               atol=0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [2, 63, 64, 65, 127, 128, 129, 257])
def test_savep_f32_twin_matches_jax_want_p(n, d):
    """The f32 saved-P forward's twin against the JAX package's
    _flash_fwd(want_p) in interpret mode: out, P (exp(s - m), m the true row
    max) and inv = 1 / denominator, within 1e-5 of max|JAX|; P's padded
    columns are exactly 0."""
    rng = np.random.default_rng(n + d)
    q, k, v = (rng.normal(0, 1, (1, 2, n, d)).astype(np.float32) for _ in range(3))
    jout, jinv, jp = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), 0, True,
                                    want_lse=False, want_p=True)
    out, p, inv = tfa.flash_attention_savep(*(torch.from_numpy(a.reshape(2, n, d))
                                              for a in (q, k, v)))
    assert p.shape == (2, n, tfa.p_columns(n)) and p.dtype == torch.float32
    assert not p[..., n:].any()
    for got, want in ((out, np.asarray(jout)[:, :n]), (p[..., :n], np.asarray(jp)[:, :n, :n]),
                      (inv, np.asarray(jinv)[:, :n, 0])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())

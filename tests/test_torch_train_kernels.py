"""The port's training kernels' twins, through their autograd Functions,
against the JAX package's Pallas kernels and custom VJPs in interpret mode.

On CPU tensors the port's wrappers take their plain twins, so these tests
hold the twins' arithmetic (and the Functions' backward wiring) against the
JAX kernels; the CUDA kernels are held against the same twins on the card
(chip_smoke.py, tests/test_torch_cuda.py). Tolerances are relative to the
largest reference value: 1e-4 in float32 (summation order, the running-max
softmax shift, erff against a rational erf), 2e-2 in bfloat16 (a one-ulp
flip of a bf16 value before a product moves a gradient by ~2^-8 of its
scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ocm_wmsegmentation_tpu.ops import fused_mlp as jfm
from vit_ocm_wmsegmentation_tpu.ops.flash_attention import flash_attention_trainable as jfat
from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as tfa
from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as tfm

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

TOL = {"f32": 1e-4, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _close(got, want, tag, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL[tag] * scale, f"{what}[{tag}]: max|d| {err:.3e} vs max|ref| {scale:.3e}"


def _pair(a, tag):
    """One numpy array as the same values in JAX and in torch."""
    j = jnp.asarray(a).astype(JDT[tag])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[tag])


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [2, 31, 33, 63, 64, 65, 127, 128, 129, 130, 257])
def test_attention_function_matches_jax_vjp(n, d, tag):
    """At the edges of the kernels' tiles: the 64-row tiles and 128-row CTAs
    (one key, a tile exactly, one past it, a CTA exactly, one past it, 130,
    and one past two CTAs), and the f32 kernels' 32-key tiles at d = 128
    (one short of and one past 32 and 64) and 128-query CTAs (one short)."""
    b, h = (2, 2) if n == 130 else (1, 1)
    rng = np.random.default_rng(d if n == 130 else d + n)
    arrays = [rng.normal(0, 1, (b, h, n, d)).astype(np.float32) for _ in range(4)]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(a, tag) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: jfat(q, k, v, 0, True), jq, jk, jv)
    want = (out, *vjp(jdo))
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    got = tfa.flash_attention_trainable(tq, tk, tv)
    got.backward(tdo)
    assert got.dtype == tq.grad.dtype == TDT[tag]
    for name, g, w in zip(("out", "dq", "dk", "dv"), (got, tq.grad, tk.grad, tv.grad), want):
        _close(g, w, tag, name)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_attention_bwd_guards_nonfinite_lse(tag):
    """A non-finite lse counts as 0 (nan_to_num in the JAX backward), so the
    twin's gradients stay finite."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 33, 64)).astype(np.float32)).to(TDT[tag])
                   for _ in range(4))
    out, lse = tfa.flash_attention(q, k, v)
    lse[0, 3], lse[1, 7] = float("inf"), float("nan")
    for g in tfa.flash_attention_bwd(q, k, v, out, lse, do):
        assert torch.isfinite(g.float()).all()


def _mlp_arrays(seed, r=70, d=64, hdim=256):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0, mean=0.0: (rng.normal(size=s) * std + mean).astype(np.float32)  # noqa: E731
    return {"x": f(r, d, std=2.0, mean=0.5), "s": f(d, std=0.1, mean=1.0), "b": f(d, std=0.1),
            "w1": f(d, hdim, std=d ** -0.5), "b1": f(hdim, std=0.1),
            "w2": f(hdim, d, std=hdim ** -0.5), "b2": f(d, std=0.1), "do": f(r, d)}


@pytest.mark.parametrize("tag,r,d", [
    pytest.param("f32", 70, 64, id="f32"), pytest.param("bf16", 70, 64, id="bf16"),
    *(pytest.param("f32", r, d, id=f"f32-{r}x{d}") for d in (192, 384) for r in (63, 65, 129)),
    *(pytest.param("bf16", r, d, id=f"bf16-{r}x{d}") for d in (192, 384)
      for r in (63, 65, 127, 129, 257))])
def test_mlp_function_matches_jax_vjp(tag, r, d):
    """At D = 64 in both dtypes, then at the CUDA kernels' widths (H = 4 D)
    with row counts at the edges of their tiles: float32's 64-row tiles, and
    bfloat16's 64-row warpgroups in 128-row CTAs (and the weight kernel's
    64-row slices)."""
    a = _mlp_arrays(7, r, d, 256 if d == 64 else 4 * d)
    names = ("x", "s", "b", "w1", "b1", "w2", "b2")
    jargs, targs = zip(*(_pair(a[k], tag) for k in names))
    # the port takes nn.Linear's (H, D) / (D, H) weights: transposes of the JAX ones
    targs = list(targs)
    targs[3], targs[5] = targs[3].T.contiguous(), targs[5].T.contiguous()
    jdo, tdo = _pair(a["do"], tag)
    out, vjp = jax.vjp(
        lambda *p: jfm.fused_mlp_block(*p, 1e-6, jfm.DEFAULT_BLOCK_R, True), *jargs)
    want = [out, *vjp(jdo)]
    want[4], want[6] = want[4].T, want[6].T  # dw1, dw2 in the port's layouts
    targs = [t.requires_grad_() for t in targs]
    got = tfm.fused_mlp_block_trainable(*targs, 1e-6)
    got.backward(tdo)
    assert got.dtype == TDT[tag] and all(t.grad.dtype == TDT[tag] for t in targs)
    for name, g, w in zip(("out",) + tuple("d" + k for k in names), [got] + [t.grad for t in targs],
                          want):
        _close(g, w, tag, name)


def test_mlp_h1_is_the_rounded_pre_gelu_activation():
    a = _mlp_arrays(8)
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in a.items()}
    out, h1 = tfm.fused_mlp_block_h1(t["x"], t["s"], t["b"], t["w1"].T.contiguous(), t["b1"],
                                     t["w2"].T.contiguous(), t["b2"])
    assert h1.dtype == torch.bfloat16 and h1.shape == (70, 256)
    xn = tfm.tnn.layer_norm(t["x"], t["s"], t["b"]).float()
    want = (xn @ t["w1"].float() + t["b1"].float()).to(torch.bfloat16)
    assert torch.equal(h1, want)
    assert torch.equal(out, tfm.fused_mlp_block(t["x"], t["s"], t["b"], t["w1"].T.contiguous(),
                                                t["b1"], t["w2"].T.contiguous(), t["b2"]))

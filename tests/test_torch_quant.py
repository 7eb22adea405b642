"""The port's int8 serving route (ops/quant.py, mha_flash(quant=True),
models.vit.InferRoutes) against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu import pipeline as jpl
from vit_ocm_wmsegmentation_tpu.models import vit as jvit
from vit_ocm_wmsegmentation_tpu.ops import attention as jatt
from vit_ocm_wmsegmentation_tpu.ops import flash_attention_mod as jfa
from vit_ocm_wmsegmentation_tpu.ops import quant as jquant
from vit_ocm_wmsegmentation_tpu.ops import threshold as jth
from vit_ocm_wmsegmentation_tpu.train.checkpoint import vit_params_from_torch
from vit_ocm_wmsegmentation_tpu_torch import pipeline as tpl
from vit_ocm_wmsegmentation_tpu_torch import sw_processing as tsw
from vit_ocm_wmsegmentation_tpu_torch.models import vit as tvit
from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as tfa
from vit_ocm_wmsegmentation_tpu_torch.ops import quant as tquant
from vit_ocm_wmsegmentation_tpu_torch.ops import threshold as tth

from port_helpers import one_torch_thread, quant_rows  # noqa: F401  (autouse)

from torch_oracle import make_vit_state_dict

# head dim 16: d^-1/2 = 1/4 is a power of two, so the scaled and the raw qkv
# weights quantize alike and the JAX package's routes agree with each other
JCFG = jvit.ViTConfig(patch_size=8, embed_dim=32, depth=3, num_heads=2, pretrain_img_size=32)
TCFG = tvit.ViTConfig(patch_size=8, embed_dim=32, depth=3, num_heads=2, pretrain_img_size=32)
WINDOW, STRIDE, SIZE = 48, 16, 144


@pytest.fixture
def jax_routes(monkeypatch):
    """Set the JAX package's inference routes for one test, restored after
    (through its setters, which clear jax's caches)."""
    def set_(mlp="auto", quant="none", interpret=False):
        monkeypatch.setattr(jvit, "FUSED_MLP_INTERPRET", interpret)
        jvit.set_infer_mlp(mlp)
        jvit.set_infer_quant(quant)
        jax.clear_caches()

    yield set_
    jvit.set_infer_mlp("auto")
    jvit.set_infer_quant("auto")
    jax.clear_caches()


def _weights(seed):
    sd = make_vit_state_dict(torch.Generator().manual_seed(seed), patch=8, dim=32, depth=3,
                             heads=2, pretrain_img=32)
    model = tvit.ViT(TCFG)
    model.load_state_dict(sd, strict=True)
    return vit_params_from_torch(sd, JCFG), model


# (M, K, N): a small case, then the mosaic's four projections (qkv, proj,
# fc1, fc2) at an M that is not a multiple of the GEMM's 128-row tile
@pytest.mark.parametrize("shape", [(64, 384, 1536), (7, 48, 5), (130, 384, 1152), (130, 384, 384),
                                   (130, 384, 1536), (130, 1536, 384)])
def test_int8_dot_and_colwise_match_jax_exactly(shape):
    m, k, n = shape
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[1] = 0  # an all-zero row takes scale 1
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)  # the JAX (in, out) layout
    w[:, 0] = 0
    wt = torch.from_numpy(w.T.copy())  # the port's (out, in)
    jq, js = jquant._colwise_int8(jnp.asarray(w))
    tq, ts = tquant.colwise_int8(wt)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])
    jxq, jxs = jquant._rowwise_int8(jnp.asarray(x))
    txq, txs = tquant.rowwise_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    want = np.asarray(jquant.int8_dot(jnp.asarray(x), jnp.asarray(w)))
    for weight in (wt, (tq, ts)):
        np.testing.assert_array_equal(tquant.int8_dot_plain(torch.from_numpy(x), weight).numpy(), want)
        np.testing.assert_array_equal(tquant.int8_dot(torch.from_numpy(x), weight).numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [16, 384, 1536])
def test_quantize_rows_twin_matches_jax_exactly(k, dtype):
    """quantize_rows on the CPU (its plain twin, rowwise_int8) against the
    JAX package's _rowwise_int8: values and scales equal, on rows over six
    decades, an all-zero row and exact round-half ties of x / s (0.5 -> 0,
    2.5 -> 2: half to even); no kernel launches."""
    x = quant_rows(130, k, k)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    jq, js = jquant._rowwise_int8(jx)
    before = tquant.quantize_rows.launches
    tq, ts = tquant.quantize_rows(tx)
    assert tquant.quantize_rows.launches == before
    assert tq.dtype == torch.int8 and ts.shape == (130, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1]) == 1.0 and tq[2, 1] == 0 and tq[2, 3] == 2 and tq[3, 1] == 0


def _mha_case(seed, n=20, dm=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, dm)).astype(np.float32)
    p = {"wqkv": 0.1 * rng.standard_normal((dm, 3 * dm)), "bqkv": 0.1 * rng.standard_normal(3 * dm),
         "wo": 0.1 * rng.standard_normal((dm, dm)), "bo": 0.1 * rng.standard_normal(dm)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    t = (torch.from_numpy(p["wqkv"].T.copy()), torch.from_numpy(p["bqkv"]),
         torch.from_numpy(p["wo"].T.copy()), torch.from_numpy(p["bo"]))
    return x, {k: jnp.asarray(v) for k, v in p.items()}, t


@pytest.mark.parametrize("prefer_folded", [False, True])
def test_mha_flash_quant_matches_jax(prefer_folded):
    """Both branches of the port's mha_flash(quant=True) against the JAX
    chunked path and its interpret-mode kernel route (tests/test_quant.py's
    comparison), head dim 16."""
    x, jp, tw = _mha_case(5)
    got = tfa.mha_flash(torch.from_numpy(x), *tw, 2, prefer_folded=prefer_folded, quant=True)
    want_fused = np.asarray(jatt.mha_fused(jnp.asarray(x), jp, 2, quant=True))
    want_kernel = np.asarray(jfa.mha_flash(jnp.asarray(x), jp, 2, prefer_folded=prefer_folded,
                                           interpret=True, quant=True))
    plain = tfa.mha_flash(torch.from_numpy(x), *tw, 2, prefer_folded=prefer_folded)
    assert not torch.equal(got, plain), "quant not wired"
    np.testing.assert_allclose(got.numpy(), want_fused, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=0, atol=2e-5)


# (--infer_mlp, --quant) -> the JAX package's settings that take the same
# route on the CPU: its kernel routes need FUSED_MLP_INTERPRET there
ROUTES = {("lnout", "int8"): ("lnout", True), ("kernel", "int8"): ("kernel", True),
          ("none", "int8"): ("none", False), ("lnout", "none"): ("lnout", True),
          ("kernel", "none"): ("kernel", True), ("none", "none"): ("none", False)}


@pytest.mark.parametrize("mlp,quant", list(ROUTES))
def test_blocks_on_each_route_match_jax(jax_routes, mlp, quant):
    """cls_attention_grid (blocks 0..L-2 on the route, the CLS row) against
    the JAX package on each row of the --infer_mlp x --quant table."""
    jmlp, interpret = ROUTES[(mlp, quant)]
    jax_routes(jmlp, quant, interpret)
    tree, model = _weights(3)
    x = np.random.default_rng(2).random((2, 48, 48, 3), dtype=np.float32)
    want = np.asarray(jvit.cls_attention_grid(tree, JCFG, jnp.asarray(x)))
    got = tvit.cls_attention_grid(model, torch.from_numpy(x),
                                  tvit.infer_routes(mlp if mlp != "lnout" else "auto", quant))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_int8_routes_take_the_reference_mlp():
    """With int8, lnout keeps the fused MLP in full precision and only the
    projections change; kernel and none both take the stock int8 MLP."""
    _, model = _weights(4)
    model.requires_grad_(False)
    tok = tvit.prepare_tokens(model, torch.from_numpy(
        np.random.default_rng(1).random((2, 48, 48, 3), dtype=np.float32)))
    run = lambda mlp, q: tvit.run_blocks(model, tok, 2, tvit.InferRoutes(mlp, q))  # noqa: E731
    assert torch.equal(run("kernel", "int8"), run("none", "int8"))
    assert not torch.equal(run("lnout", "int8"), run("none", "int8"))
    assert not torch.equal(run("lnout", "int8"), run("lnout", None))
    np.testing.assert_allclose(run("lnout", "int8").numpy(), run("lnout", None).numpy(),
                               rtol=0, atol=5e-2)


def _mosaic(seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(120, 40, (SIZE, SIZE))
    base[40:100, 30:110] += 70
    return np.clip(base, 0, 255).astype(np.uint8)


def _otsu(th, img, attn):
    a = th.min_max_normalize(attn)
    result = img * 1.0 * a / a.max()
    if isinstance(result, torch.Tensor):
        return float(th.otsu_from_hist(th.histogram_u8(result.to(torch.uint8))))
    return float(th.otsu_threshold_u8(result.astype(jnp.uint8)))


@pytest.mark.parametrize("mlp", ["none", "lnout"])
def test_segment_mosaic_int8_matches_jax(jax_routes, mlp):
    jax_routes(mlp, "int8", mlp == "lnout")
    params, model = _weights(41)
    img = _mosaic(1)
    jmask, jattn = jpl.segment_mosaic(params, JCFG, jnp.asarray(img), window=WINDOW, stride=STRIDE)
    tmask, tattn = tpl.segment_mosaic(model, torch.from_numpy(img), WINDOW, STRIDE,
                                      routes=tvit.InferRoutes(mlp, "int8"))
    # int8 rounding is discontinuous: the two frameworks' f32 sums differ in
    # the last ulp (1e-8 at the ViT output on the f32 route), which moves a
    # few round-half cases of x / s by one int8 code; each tile's min-max
    # normalization of its near-flat random-weight map magnifies one such flip
    # to up to 0.55 on the 0-255 scale (seeds 41-43, three mosaics), where the
    # f32 route stays within 2e-3 (tests/test_torch_pipeline.py)
    assert np.abs(tattn.numpy() - np.asarray(jattn)).max() < 1.0  # 0-255 scale
    a, b = tmask.numpy() > 0, np.asarray(jmask) > 0
    assert 2 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1) >= 0.999
    assert abs(_otsu(tth, torch.from_numpy(img), tattn)
               - _otsu(jth, jnp.asarray(img), jnp.asarray(jattn))) <= 1


def test_training_is_unchanged_by_the_inference_routes():
    """tests/test_quant.py:67's counterpart: int8 changes the inference
    blocks, never the training forward (which takes no InferRoutes), and
    quantizing the weights leaves the model's parameters as they were."""
    _, model = _weights(6)
    model.requires_grad_(False)
    x = tvit.prepare_tokens(model, torch.from_numpy(
        np.random.default_rng(1).random((2, 48, 48, 3), dtype=np.float32)))
    with torch.no_grad():
        train_before = tvit.run_blocks_train(model, x)
    infer = tvit.run_blocks(model, x, 3)
    infer_q = tvit.run_blocks(model, x, 3, tvit.InferRoutes(quant="int8"))
    with torch.no_grad():
        train_after = tvit.run_blocks_train(model, x)
    assert torch.equal(train_before, train_after)
    assert not torch.equal(infer, infer_q)
    np.testing.assert_allclose(infer_q.numpy(), infer.numpy(), rtol=0, atol=5e-2)


def test_int8_weights_are_quantized_once_per_model():
    _, model = _weights(7)
    first = tvit.int8_weights(model)
    assert tvit.int8_weights(model) is first
    assert torch.equal(first[0]["fc1"][0], tquant.colwise_int8(model.blocks[0].mlp.fc1.weight)[0])
    model = model.to(torch.bfloat16)  # cast: quantized again from the bf16 weights
    again = tvit.int8_weights(model)
    assert again is not first
    assert torch.equal(again[1]["proj"][0],
                       tquant.colwise_int8(model.blocks[1].attn.proj.weight)[0])


def test_infer_routes_choices():
    assert tvit.infer_routes() == tvit.InferRoutes("lnout", None)
    assert tvit.infer_routes("none", "int8") == tvit.InferRoutes("none", "int8")
    with pytest.raises(ValueError):
        tvit.infer_routes("fused")
    with pytest.raises(ValueError):
        tvit.infer_routes("auto", "int4")
    with pytest.raises(ValueError):
        tvit.InferRoutes("auto")


def test_cli_quant_int8_on_the_cpu(tmp_path):
    """The serving CLI with --quant int8 --infer_mlp none on the CPU: its masks
    equal segment_mosaic's on the same route."""
    src = tmp_path / "in"
    src.mkdir()
    for i in range(2):
        Image.fromarray(_mosaic(i)[:96, :96]).save(src / f"m{i}.png")
    masks = tsw.main(["--arch", "vit_tiny", "--image_path", str(src), "--image_size", "96",
                      "--window_size", "48", "--stride", "16", "--device", "cpu", "--quant",
                      "int8", "--infer_mlp", "none", "--save", "mask", "--writers", "1",
                      "--output_dir", str(tmp_path / "out")])
    model = tsw.load_model("vit_tiny", 8, quant="int8")
    routes = tvit.InferRoutes("none", "int8")
    for i in range(2):
        gray = torch.from_numpy(tsw.decode(str(src / f"m{i}.png"), (96, 96)))
        want, _ = tpl.segment_mosaic(model, gray, 48, 16, routes=routes)
        np.testing.assert_array_equal(masks[f"m{i}"], want.numpy())
        assert (tmp_path / "out" / f"m{i}" / "otsu_sw.jpg").is_file()

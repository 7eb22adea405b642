"""The port's ViT analysis API and single-image attention path against the
JAX package's, on identical weights and inputs (f32, the JAX stock route)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ocm_wmsegmentation_tpu import pipeline as jpl
from vit_ocm_wmsegmentation_tpu.models import vit as jvit
from vit_ocm_wmsegmentation_tpu.ops import filters as jfilters
from vit_ocm_wmsegmentation_tpu.ops import resize as jresize
from vit_ocm_wmsegmentation_tpu.ops import stitch as jstitch
from vit_ocm_wmsegmentation_tpu.ops import threshold as jth
from vit_ocm_wmsegmentation_tpu_torch import pipeline as tpl
from vit_ocm_wmsegmentation_tpu_torch.models import vit as tvit
from vit_ocm_wmsegmentation_tpu_torch.ops import filters as tfilters
from vit_ocm_wmsegmentation_tpu_torch.ops import resize as tresize
from vit_ocm_wmsegmentation_tpu_torch.ops import stitch as tstitch
from vit_ocm_wmsegmentation_tpu_torch.ops import threshold as tth
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as tckpt

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

JCFG = jvit.ViTConfig(patch_size=8, embed_dim=32, depth=3, num_heads=2, pretrain_img_size=32)
TCFG = tvit.ViTConfig(patch_size=8, embed_dim=32, depth=3, num_heads=2, pretrain_img_size=32)
ROUTES = ("lnout", "kernel", "none")


def _pair(seed):
    tree = jax.tree.map(np.asarray, jvit.init(JCFG, jax.random.PRNGKey(seed)))
    model = tvit.ViT(TCFG)
    model.load_state_dict(tckpt.vit_state_from_jax_numpy(tree, TCFG), strict=True)
    return jax.tree.map(jnp.asarray, tree), model.requires_grad_(False)


def _images(hw, seed, b=2):
    return np.random.default_rng(seed).random((b,) + hw + (3,), dtype=np.float32)


def _gray(hw, seed, b=2):
    """Gray images with a bright block on noise, the eval sets' look."""
    rng = np.random.default_rng(seed)
    img = rng.normal(90, 30, (b,) + hw)
    img[:, hw[0] // 4 : 3 * hw[0] // 4, hw[1] // 3 :] += 90
    return np.clip(img, 0, 255).astype(np.uint8)


def _dice(a, b):
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    return 2 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# the analysis API's token and feature functions: (port call, JAX call)
TOKEN_CASES = {
    "forward_features": (lambda m, x, r: tvit.forward_features(m, x, r),
                         lambda p, x: jvit.forward_features(p, JCFG, x)),
    "forward_cls": (lambda m, x, r: tvit.forward_cls(m, x, r),
                    lambda p, x: jvit.forward_cls(p, JCFG, x)),
    "get_intermediate_layers_1": (lambda m, x, r: tvit.get_intermediate_layers(m, x, 1, r),
                                  lambda p, x: jvit.get_intermediate_layers(p, JCFG, x, 1)),
    "get_intermediate_layers_2": (lambda m, x, r: tvit.get_intermediate_layers(m, x, 2, r),
                                  lambda p, x: jvit.get_intermediate_layers(p, JCFG, x, 2)),
    "last_block_key_features": (lambda m, x, r: tvit.last_block_key_features(m, x, r),
                                lambda p, x: jvit.last_block_key_features(p, JCFG, x)),
}


@functools.lru_cache(maxsize=None)
def _jax_tokens(case):
    params, _ = _pair(0)
    return np.asarray(jax.jit(TOKEN_CASES[case][1])(params, jnp.asarray(_images((48, 40), 1))))


@pytest.mark.parametrize("routes", ROUTES)
@pytest.mark.parametrize("case", sorted(TOKEN_CASES))
def test_token_functions_match_jax(case, routes):
    _, model = _pair(0)
    x = _images((48, 40), 1)
    got = TOKEN_CASES[case][0](model, torch.from_numpy(x), tvit.InferRoutes(routes)).numpy()
    _close(got, _jax_tokens(case), 1e-4)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_get_intermediate_feat_matches_jax(n):
    params, model = _pair(1)
    x = _images((48, 48), 2)
    feats, attns, qkvs = tvit.get_intermediate_feat(model, torch.from_numpy(x), n)
    jf, ja, jq = jax.jit(jvit.get_intermediate_feat, static_argnums=(1, 3))(
        params, JCFG, jnp.asarray(x), n)
    assert attns.shape == (n, 2, 2, 37, 37) and qkvs.shape == (n, 3, 2, 2, 37, 16)
    _close(feats.numpy(), jf, 1e-4)
    _close(qkvs.numpy(), jq, 1e-4)
    np.testing.assert_allclose(attns.numpy(), np.asarray(ja), rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(48, 48), (96, 96)])
def test_get_last_selfattention_matches_jax_and_the_cls_row(hw):
    params, model = _pair(2)
    x = torch.from_numpy(_images(hw, 3))
    got = tvit.get_last_selfattention(model, x)
    want = np.asarray(jax.jit(jvit.get_last_selfattention, static_argnums=1)(
        params, JCFG, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the materialized matrix's CLS row is what cls_attention_grid computes alone
    grid = tvit.cls_attention_grid(model, x)
    np.testing.assert_allclose(got[:, :, 0, 1:].reshape(grid.shape).numpy(), grid.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("queries", [[0], [0, 5, 17, 36], list(range(36, -1, -3))])
def test_query_attention_rows_match_jax(queries):
    params, model = _pair(3)
    x = _images((48, 48), 4)
    got = tvit.query_attention_rows(model, torch.from_numpy(x), queries).numpy()
    want = np.asarray(jvit.query_attention_rows(params, JCFG, jnp.asarray(x),
                                                jnp.asarray(queries)))
    assert got.shape == (2, 2, len(queries), 37)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    full = tvit.get_last_selfattention(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, full[:, :, queries], rtol=0, atol=1e-5)


@pytest.mark.parametrize("routes", ["lnout", "kernel"])
def test_intermediate_layers_kernel_routes_equal_stock_route(routes):
    """The LN-out route runs blocks [0, depth-n) as one span and each of the
    last n as its own: no block's LN-out z may leak past its span, so the
    route equals the stock one (the fused MLP twins against the stock MLP)."""
    _, model = _pair(4)
    x = torch.from_numpy(_images((48, 48), 5))
    want = tvit.get_intermediate_layers(model, x, 2, tvit.InferRoutes("none")).numpy()
    got = tvit.get_intermediate_layers(model, x, 2, tvit.InferRoutes(routes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_run_blocks_spans_compose():
    """run_blocks over [0, 1) then [1, 3) equals one span [0, 3) on every
    route (lo, hi)."""
    _, model = _pair(5)
    x = torch.from_numpy(_images((48, 48), 6))
    tok = tvit.prepare_tokens(model, x)
    for routes in ROUTES:
        r = tvit.InferRoutes(routes)
        one = tvit.run_blocks(model, tok, 3, r)
        two = tvit.run_blocks(model, tvit.run_blocks(model, tok, 1, r), 3, r, lo=1)
        np.testing.assert_allclose(two.numpy(), one.numpy(), rtol=0, atol=1e-5)
    assert tvit.run_blocks(model, tok, 2, r, lo=2) is tok


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5])
def test_median_filter_bit_equal(size):
    x = np.random.default_rng(size).random((2, 17, 23)).astype(np.float32)
    x[0, 3:9, 4:12] = 0.5  # ties
    got = tfilters.median_filter(torch.from_numpy(x), size).numpy()
    for i in range(2):
        want = np.asarray(jfilters.median_filter(jnp.asarray(x[i]), size))
        assert np.array_equal(got[i], want), size


def test_median_filter_equals_scipy():
    from scipy import ndimage

    x = np.random.default_rng(0).integers(0, 255, (19, 14)).astype(np.float32)
    for size in (2, 3, 4, 5):
        got = tfilters.median_filter(torch.from_numpy(x), size).numpy()
        assert np.array_equal(got, ndimage.median_filter(x, size)), size


def test_upsample_nearest_and_concat_crops_bit_equal():
    rng = np.random.default_rng(1)
    g = rng.random((2, 3, 5, 4)).astype(np.float32)
    assert np.array_equal(tresize.upsample_nearest(torch.from_numpy(g), 8).numpy(),
                          np.asarray(jresize.upsample_nearest(jnp.asarray(g), 8)))
    for t in (4, 16):
        crops = rng.random((t, 6, 7)).astype(np.float32)
        assert np.array_equal(tstitch.concat_crops(torch.from_numpy(crops)).numpy(),
                              np.asarray(jstitch.concat_crops(jnp.asarray(crops))))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int32])
@pytest.mark.parametrize("t", [4, 9, 16])
def test_concat_crops_overlap_bit_equal(t, dtype):
    rng = np.random.default_rng(t)
    crops = (rng.random((t, 24, 24)) * 255 - (60 if dtype == np.int32 else 0)).astype(dtype)
    got = tstitch.concat_crops_overlap(torch.from_numpy(crops), 4).numpy()
    want = np.asarray(jstitch.concat_crops_overlap(jnp.asarray(crops), 4))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_blend_ours_bit_equal():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (64, 48)).astype(np.uint8)
    attn = rng.random((64, 48)).astype(np.float32) ** 3
    for a in (attn, np.full_like(attn, 0.25)):
        got = tth.blend_ours(torch.from_numpy(img), torch.from_numpy(a))
        want = jth.blend_ours(jnp.asarray(img), jnp.asarray(a))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    # the float64 table: every pair of uint8 values, ties at exact integers
    iv = np.arange(256)
    ii, aa = np.meshgrid(iv, iv, indexing="ij")
    lut = tth._blend_lut(0.4, torch.device("cpu")).numpy()
    assert np.array_equal(lut, ((ii / 2) * 0.6 + (aa / 2) * 0.4).astype(np.uint8))


def test_mult_blend_u8_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (96, 96)).astype(np.uint8)
    attn = (rng.random((96, 96)) * 0.02).astype(np.float32)
    got = tth.mult_blend_u8(torch.from_numpy(img), torch.from_numpy(attn)).numpy()
    want = np.asarray(jth.mult_blend_u8(jnp.asarray(img), jnp.asarray(attn)))
    # one division each, of the same f32 values
    assert np.array_equal(got, want)


def _threshold_images():
    rng = np.random.default_rng(4)
    yield rng.integers(0, 256, (48, 48)).astype(np.uint8)
    yield _gray((48, 48), 5, 1)[0]
    yield np.clip(rng.normal(40, 5, (32, 32)), 0, 255).astype(np.uint8)  # narrow range
    two = np.full((16, 16), 30, np.uint8)
    two[:, 8:] = 200
    yield two
    yield np.full((16, 16), 77, np.uint8)  # constant


@pytest.mark.parametrize("i", range(5))
def test_otsu_and_yen_within_one_bin(i):
    img = list(_threshold_images())[i]
    t_otsu = float(tth.otsu_threshold_u8(torch.from_numpy(img)))
    t_yen = float(tth.yen_threshold_u8(torch.from_numpy(img)))
    assert abs(t_otsu - float(jth.otsu_threshold_u8(jnp.asarray(img)))) <= 1.0
    assert abs(t_yen - float(jth.yen_threshold_u8(jnp.asarray(img)))) <= 1.0
    if i == 4:
        assert t_yen == 77.0  # skimage gives a constant image its own value
    mask = tth.yen_binary_u8(torch.from_numpy(img)).numpy()
    assert mask.dtype == bool and np.array_equal(mask, img >= t_yen)


@pytest.mark.parametrize("median_size", [1, 3])
@pytest.mark.parametrize("hw", [(48, 48), (96, 64)])
def test_attention_map_matches_jax(hw, median_size):
    """The smoothed attention within 2e-3 on the 0-255 scale, from RGB and
    from uint8 gray input."""
    params, model = _pair(6)
    x = _images(hw, 7)
    gray = _gray(hw, 8)
    for got, want in (
        (tpl.attention_map_rgb(model, torch.from_numpy(x), median_size),
         jpl.attention_map_rgb(params, JCFG, jnp.asarray(x), median_size)),
        (tpl.attention_map_single(model, torch.from_numpy(gray), median_size),
         jpl.attention_map_single(params, JCFG, jnp.asarray(gray), median_size)),
    ):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.float32 and got.shape == (2,) + hw
        assert np.abs(got - want).max() * 255.0 / np.abs(want).max() <= 2e-3


def test_head_average_attention_median_matches_jax():
    params, model = _pair(7)
    x = _images((48, 48), 9)
    for size in (2, 3, 5):
        got = tpl.head_average_attention(model, torch.from_numpy(x), size).numpy()
        want = np.asarray(jax.jit(jpl.head_average_attention, static_argnums=(1, 3))(
            params, JCFG, jnp.asarray(x), size))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_attention_heads_match_jax():
    params, model = _pair(8)
    x = _images((48, 40), 10)
    got = tpl.attention_heads(model, torch.from_numpy(x)).numpy()
    want = np.asarray(jpl.attention_heads(params, JCFG, jnp.asarray(x)))
    assert got.shape == (2, 2, 48, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["ours", "otsu", "heatmap_threshold"])
@pytest.mark.parametrize("median_size", [1, 3])
def test_segment_single_matches_jax(method, median_size):
    params, model = _pair(9)
    gray = _gray((48, 48), 11, 3)
    tmask, tattn = tpl.segment_single(model, torch.from_numpy(gray), method, median_size)
    jmask, jattn = jpl.segment_single(params, JCFG, jnp.asarray(gray), method, median_size)
    assert tmask.dtype == torch.uint8 and set(np.unique(tmask.numpy())) <= {0, 255}
    assert np.abs(tattn.numpy() - np.asarray(jattn)).max() * 255 / np.abs(jattn).max() <= 2e-3
    for i in range(3):
        assert _dice(tmask[i].numpy(), jmask[i]) >= 0.999


@pytest.mark.parametrize("streamed", [False, True])
def test_mosaic_median_filter_matches_jax(streamed):
    """median_size 3 through the fused and the streamed mosaic paths."""
    params, model = _pair(10)
    img = _gray((96, 96), 12, 1)[0]
    if streamed:
        jmask, jattn = jpl.segment_mosaic_streamed(params, JCFG, jnp.asarray(img), 48, 16,
                                                   median_size=3)
        tmask, tattn = tpl.segment_mosaic_streamed(model, img, 48, 16, median_size=3)
    else:
        jmask, jattn = jpl.segment_mosaic(params, JCFG, jnp.asarray(img), 48, 16, median_size=3)
        tmask, tattn = tpl.segment_mosaic(model, torch.from_numpy(img), 48, 16, median_size=3)
    np.testing.assert_allclose(tattn.numpy(), np.asarray(jattn), rtol=0, atol=2e-3)
    assert _dice(tmask.numpy(), jmask) >= 0.999


def test_mosaic_median_filter_acts():
    """The 2-tap resample reads pixels 3 and 4 of each 8-pixel block, where a
    median over fewer than 9 x 9 pixels of the nearest-upsampled map sees a
    majority of its own block and leaves it alone (so size 3 is the identity
    here, as in the reference); a 15 x 15 median reaches the neighbours. The
    streamed path filters as the fused one does."""
    _, model = _pair(11)
    img = torch.from_numpy(_gray((96, 96), 13, 1)[0])
    plain = tpl.attention_mosaic(model, img, 48, 16).numpy()
    three = tpl.attention_mosaic(model, img, 48, 16, median_size=3).numpy()
    fused, attn = tpl.segment_mosaic(model, img, 48, 16, median_size=15)
    streamed, sattn = tpl.segment_mosaic_streamed(model, img, 48, 16, median_size=15)
    np.testing.assert_allclose(three, plain, rtol=0, atol=1e-3)
    assert np.abs(attn.numpy() - plain).max() > 1.0
    np.testing.assert_allclose(sattn.numpy(), attn.numpy(), rtol=0, atol=2e-3)
    assert _dice(streamed.numpy(), fused.numpy()) >= 0.999


def test_resize_bicubic_and_smooth_attention_match_jax():
    rng = np.random.default_rng(13)
    x = rng.random((2, 6, 5)).astype(np.float32)
    for out, scale in (((13, 11), None), ((12, 10), (2.1, 2.05))):
        got = tresize.resize_bicubic_torch(torch.from_numpy(x), out, scale).numpy()
        want = np.asarray(jresize.resize_bicubic_torch(jnp.asarray(x), out, scale))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = tresize.smooth_attention(torch.from_numpy(x), 8, (48, 40)).numpy()
    want = np.asarray(jresize.smooth_attention(jnp.asarray(x), 8, (48, 40)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_thresholds_of_a_batch_equal_each_image_alone():
    """histogram_u8_images, Otsu and threshold_ours on a (B, H, W) batch
    give each image's own result, bit for bit (the batched eval step)."""
    gray = torch.from_numpy(_gray((48, 40), 14, 3))
    attn = torch.from_numpy(np.random.default_rng(15).random((3, 48, 40)).astype(np.float32))
    hists = tth.histogram_u8_images(gray)
    masks = tth.threshold_ours(gray, attn)
    assert hists.shape == (3, 256) and all(m.shape == gray.shape for m in masks)
    for i in range(3):
        assert torch.equal(hists[i], tth.histogram_u8(gray[i]))
        assert torch.equal(tth.otsu_threshold_u8(gray)[i], tth.otsu_threshold_u8(gray[i]))
        for got, want in zip(masks, tth.threshold_ours(gray[i], attn[i])):
            assert torch.equal(got[i], want)

"""The port's streamed gigapixel path against the JAX package's: the
histogram family, the streamed threshold, the chunked re-stitch, and
segment_mosaic_streamed on the tiny ViT of test_torch_pipeline.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ocm_wmsegmentation_tpu import pipeline as jpl
from vit_ocm_wmsegmentation_tpu.ops import stitch as jst
from vit_ocm_wmsegmentation_tpu.ops import threshold as jth
from vit_ocm_wmsegmentation_tpu_torch import pipeline as tpl
from vit_ocm_wmsegmentation_tpu_torch.ops import stitch as tst
from vit_ocm_wmsegmentation_tpu_torch.ops import threshold as tth
from vit_ocm_wmsegmentation_tpu_torch.parallel.mesh import make_mesh

from port_helpers import one_torch_thread  # noqa: F401  (autouse)
from test_torch_pipeline import JCFG, STRIDE, WINDOW, _mosaic, _otsu_of_blend, _weights


def _dice(a, b):
    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    return 2 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1)


# (shape, kind, offset): uniform images; a skewed one (~90 % bin 0, as the
# blend image is where the attention is low) and an all-255 one; lengths
# around 16 bytes (the CUDA kernel's vectors) and around its 16 KB pieces;
# flat views 1-15 bytes in (data pointers off a 16-byte boundary on the card)
_PIECE = 16384
HIST_CASES = ([pytest.param(shape, "uniform", 0, id=f"shape{i}")
               for i, shape in enumerate([(256, 128), (300, 200), (17, 13)])]
              + [pytest.param(shape, kind, 0, id=f"{kind}-{'x'.join(map(str, shape))}")
                 for kind, shape in (("skewed", (300, 200)), ("skewed", (1, _PIECE + 3)),
                                     ("all255", (300, 200)))]
              + [pytest.param((n,), "uniform", 0, id=f"len{n}")
                 for n in (15, 16, 17, 33, _PIECE - 1, _PIECE, _PIECE + 1, 4 * _PIECE + 7)]
              + [pytest.param((_PIECE + 100,), "uniform", o, id=f"view{o}") for o in range(1, 16)])


def _hist_image(shape, kind):
    rng = np.random.default_rng(sum(shape))
    if kind == "all255":
        return np.full(shape, 255, np.uint8)
    img = rng.integers(0, 256, shape, np.uint8)
    if kind == "skewed":
        img[rng.random(shape) < 0.9] = 0
    return img


@pytest.mark.parametrize("shape,kind,offset", HIST_CASES)
def test_histograms_match_jax(shape, kind, offset):
    img = _hist_image(shape, kind)
    if offset:
        img = img.reshape(-1)[offset:]
    j = jnp.asarray(img)
    want = np.asarray(jth.histogram_u8(j))
    assert np.array_equal(np.asarray(jth.histogram_u8_chunked(j, 1000)), want)
    assert np.array_equal(np.asarray(jth.histogram_u8_pallas(j, block_rows=8, interpret=True)),
                          want)
    t = torch.from_numpy(_hist_image(shape, kind))
    if offset:
        t = t.reshape(-1)[offset:]
        assert t.storage_offset() == offset
    for got in (tth.histogram_u8(t), tth.histogram_u8_chunked(t), tth.histogram_u8_chunked(t, 1000),
                tth.histogram_u8_chunked(t, 1), tth.histogram_u8_kernel(t)):
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert tth.histogram_u8_kernel.launches == 0  # CPU tensors take the twin


def test_histogram_exact_past_f32_accumulation():
    """Counts past 2^24 in one bin stay exact: an f32 accumulator stalls at
    16777216; the int64 counts round once, as the JAX int32 ones do."""
    n = (1 << 24) + 67
    img = np.full(n, 7, np.uint8)
    img[-5:] = 9
    want = np.asarray(jth.histogram_u8_pallas(jnp.asarray(img), block_rows=8192, interpret=True))
    expect = np.zeros(256, np.int64)
    expect[7], expect[9] = n - 5, 5
    assert np.array_equal(want, expect.astype(np.float32))
    t = torch.from_numpy(img)
    for got in (tth.histogram_u8_chunked(t), tth.histogram_u8_kernel(t)):
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk_px", [tth.CHUNK_PX, 1000, 1])
def test_threshold_streamed_matches_jax_and_fused(monkeypatch, chunk_px):
    monkeypatch.setattr(tth, "CHUNK_PX", chunk_px)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (96, 80), np.uint8)
    canvases = (rng.normal(2.0, 1.3, (96, 80)).astype(np.float32),
                np.full((96, 80), 3.25, np.float32))  # the constant-canvas branch
    for attn in canvases:
        want = np.asarray(jpl._threshold_mult_streamed(jnp.asarray(img), jnp.asarray(attn)))
        got = tpl._threshold_mult_streamed(torch.from_numpy(img), torch.from_numpy(attn))
        assert np.array_equal(got.numpy(), want)
        fused, _, _ = tth.threshold_multiplicative(torch.from_numpy(img), torch.from_numpy(attn))
        assert torch.equal(got, fused)


@pytest.mark.parametrize("size,window,stride,chunk_px",
                         [(144, 48, 16, 1 << 24), (144, 48, 16, 144 * 7), (96, 64, 32, 1),
                          (128, 64, 64, 100)])
def test_restitch_chunked_matches_unchunked_and_jax(size, window, stride, chunk_px):
    img = np.random.default_rng(size + stride).integers(0, 256, (size, size), np.uint8)
    whole = tst.restitch_u8(torch.from_numpy(img), window, stride, chunk_px=size * size)
    got = tst.restitch_u8(torch.from_numpy(img), window, stride, chunk_px=chunk_px)
    assert torch.equal(got, whole)
    assert np.array_equal(got.numpy(), np.asarray(jst.restitch_u8(jnp.asarray(img), window,
                                                                  stride)))


@pytest.mark.parametrize("exact_stitch", [False, True])
def test_segment_mosaic_streamed_matches_jax(exact_stitch):
    params, model = _weights(47)
    img = _mosaic(7)
    jmask, jattn = jpl.segment_mosaic_streamed(params, JCFG, img, WINDOW, STRIDE,
                                               exact_stitch=exact_stitch)
    tmask, tattn = tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE,
                                               exact_stitch=exact_stitch)
    jmask, jattn, tmask, tattn = np.asarray(jmask), np.asarray(jattn), tmask.numpy(), tattn.numpy()
    assert tmask.shape == tattn.shape == img.shape and tattn.dtype == np.float32
    np.testing.assert_allclose(tattn, jattn, rtol=0, atol=2e-3)  # 0-255 scale
    # test_torch_pipeline.py's envelope: uint8 truncation of near-equal maps
    # may flip boundary pixels; Dice >= 0.999 and the Otsu bin within one
    assert _dice(jmask, tmask) >= 0.999
    timg = img
    if exact_stitch:
        timg = tst.restitch_u8(torch.from_numpy(img), WINDOW, STRIDE).numpy()
    t_port = _otsu_of_blend(tth, torch.from_numpy(timg), torch.from_numpy(tattn))
    t_jax = _otsu_of_blend(jth, jnp.asarray(timg), jnp.asarray(jattn))
    assert abs(t_port - t_jax) <= 1.0, (t_port, t_jax)


@pytest.mark.parametrize("exact_stitch", [False, True])
def test_segment_mosaic_streamed_matches_fused(exact_stitch):
    """Band after band against the fused path's shifted-block sums: the
    attention agrees to float tolerance, the masks here exactly."""
    _, model = _weights(48)
    img = torch.from_numpy(_mosaic(7))
    want_mask, want_attn = tpl.segment_mosaic(model, img, WINDOW, STRIDE, exact_stitch=exact_stitch)
    got_mask, got_attn = tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE,
                                                     exact_stitch=exact_stitch)
    np.testing.assert_allclose(got_attn.numpy(), want_attn.numpy(), rtol=0, atol=2e-3)
    assert torch.equal(got_mask, want_mask)


def test_band_chunk_leaves_canvas_and_mask_bit_equal():
    """band_chunk only spaces the progress calls: 7 bands with chunk 3 report
    after 3, 6 and 7; canvas and mask are bit-equal for every chunk."""
    _, model = _weights(49)
    img = _mosaic(8)
    want_mask, want_attn = tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE)
    for chunk, calls in ((None, [(7, 7)]), (1, [(r, 7) for r in range(1, 8)]),
                         (3, [(3, 7), (6, 7), (7, 7)])):
        seen = []
        mask, attn = tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE, band_chunk=chunk,
                                                 progress=lambda d, t: seen.append((d, t)))
        assert seen == calls
        assert torch.equal(mask, want_mask) and torch.equal(attn, want_attn)


def test_streamed_takes_numpy_and_tensor_input():
    _, model = _weights(50)
    img = _mosaic(9)
    mask, attn = tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE)
    mask_t, attn_t = tpl.segment_mosaic_streamed(model, torch.from_numpy(img), WINDOW, STRIDE)
    assert torch.equal(mask, mask_t) and torch.equal(attn, attn_t)
    assert mask.device == attn.device == torch.device("cpu")


def test_streamed_odd_size_pads():
    params, model = _weights(51)
    img = (np.random.default_rng(9).random((100, 70)) * 255).astype(np.uint8)  # pads to 112 x 80
    mask, attn = tpl.segment_mosaic_streamed(model, img, 48, 16)
    assert mask.shape == attn.shape == (100, 70)
    assert set(np.unique(mask.numpy()).tolist()) <= {0, 255}
    _, jattn = jpl.segment_mosaic_streamed(params, JCFG, img, 48, 16)
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), rtol=0, atol=2e-3)
    fmask, fattn = tpl.segment_mosaic(model, torch.from_numpy(img), 48, 16)
    np.testing.assert_allclose(attn.numpy(), fattn.numpy(), rtol=0, atol=2e-3)
    assert _dice(mask, fmask) >= 0.999


def test_streamed_refuses_unported_options():
    """single_dispatch (a TPU dispatch) raises; a mesh of one rank, the
    mesh of a process without a group, leaves canvas and mask unchanged
    (the sharded path on several ranks: tests/test_torch_parallel.py)."""
    _, model = _weights(52)
    img = _mosaic(0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE, single_dispatch=True)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    want = tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE)
    got = tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE, mesh=mesh)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="band_chunk"):
        tpl.segment_mosaic_streamed(model, img, WINDOW, STRIDE, band_chunk=0)
    with pytest.raises(ValueError, match="multiple of stride"):
        tpl.segment_mosaic_streamed(model, img, 48, 20)

"""The port's serving pieces on the CPU: the viridis table and the attention
quantization against the JAX package's, the heatmap Otsu, the prefetch
iterator, and the serving CLI's --streamed, --save and --writers."""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu import cli as jcli
from vit_ocm_wmsegmentation_tpu.ops import threshold as jth
from vit_ocm_wmsegmentation_tpu_torch import pipeline as tpl
from vit_ocm_wmsegmentation_tpu_torch import sw_processing as tsw
from vit_ocm_wmsegmentation_tpu_torch.data.prefetch import prefetch
from vit_ocm_wmsegmentation_tpu_torch.ops import threshold as tth
from vit_ocm_wmsegmentation_tpu_torch.utils import imageio

from port_helpers import one_torch_thread  # noqa: F401  (autouse)


def test_viridis_table_equals_matplotlib():
    want = jcli.viridis_lut()
    assert imageio.VIRIDIS.dtype == np.uint8 and imageio.VIRIDIS.shape == (256, 3)
    assert imageio.VIRIDIS.tobytes() == np.ascontiguousarray(want, np.uint8).tobytes()


def _canvases():
    rng = np.random.default_rng(3)
    yield rng.normal(3.0, 2.0, (70, 50)).astype(np.float32)
    yield (rng.random((33, 65)) * 255).astype(np.float32)
    yield np.full((20, 30), 0.75, np.float32)  # constant: passes min-max unchanged


@pytest.mark.parametrize("chunk_px", [tth.CHUNK_PX, 1])
def test_lut_index_and_heatmap_match_jax(monkeypatch, chunk_px):
    monkeypatch.setattr(tth, "CHUNK_PX", chunk_px)
    for attn in _canvases():
        j = jnp.asarray(attn)
        want = np.asarray(jnp.clip(jnp.floor(jth.min_max_normalize(j) * 256.0), 0, 255)
                          .astype(jnp.uint8))
        assert np.array_equal(imageio.attention_lut_index(torch.from_numpy(attn)).numpy(), want)
        img = np.random.default_rng(attn.size).integers(0, 256, attn.shape, np.uint8)
        _, _, jheat = jth.threshold_multiplicative(jnp.asarray(img), j)
        heat = tth.heatmap_otsu(torch.from_numpy(attn))
        assert np.array_equal(heat.numpy(), np.asarray(jheat))
        _, _, theat = tth.threshold_multiplicative(torch.from_numpy(img), torch.from_numpy(attn))
        assert torch.equal(heat, theat)


def test_prefetch_keeps_order_and_places_on_its_thread():
    main = threading.get_ident()
    seen = []

    def place(x):
        seen.append(threading.get_ident())
        return x * 10

    assert list(prefetch(iter(range(7)), depth=2, place=place)) == [10 * i for i in range(7)]
    assert seen and all(t != main for t in seen)


def test_prefetch_raises_the_producer_error_after_its_items():
    def items():
        yield 1
        yield 2
        raise OSError("decode failed")

    it = prefetch(items(), depth=1)
    got = []
    with pytest.raises(OSError, match="decode failed"):
        for x in it:
            got.append(x)
    assert got == [1, 2]
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


def test_prefetch_releases_the_producer_on_early_break():
    produced = []

    def items():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch(items(), depth=2)
    for x in it:
        if x == 3:
            break
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    assert len(produced) < 1000
    with pytest.raises(StopIteration):
        next(it)


SIZE = 96
CLI = ["--arch", "vit_tiny", "--image_size", str(SIZE), "--window_size", "48", "--stride", "16",
       "--device", "cpu"]


def _write_pngs(folder, n):
    os.makedirs(folder)
    for i in range(n):
        rng = np.random.default_rng(20 + i)
        Image.fromarray((rng.random((SIZE, SIZE)) * 255).astype(np.uint8)).save(
            os.path.join(folder, f"m{i}.png"))
    return folder


def _files(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), folder)] = f.read()
    return out


def test_streamed_flag_against_auto(tmp_path):
    """--streamed 1 takes the band-streamed path, auto stays fused at this
    size; the masks agree (> 0.999, as the JAX CLI test holds them)."""
    src = _write_pngs(str(tmp_path / "in"), 1)
    path = os.path.join(src, "m0.png")
    fused = tsw.main(CLI + ["--image_path", path, "--output_dir", str(tmp_path / "a")])[""]
    streamed = tsw.main(CLI + ["--image_path", path, "--output_dir", str(tmp_path / "s"),
                               "--streamed", "1"])[""]
    assert (fused == streamed).mean() > 0.999
    assert not tsw.streamed_route("auto", (SIZE, SIZE)) and tsw.streamed_route("1", (SIZE, SIZE))
    assert tsw.streamed_route("auto", (4800, 4800)) and not tsw.streamed_route("0", (4800, 4800))


def test_save_all_writes_the_three_artifacts_of_the_pipeline(tmp_path):
    src = _write_pngs(str(tmp_path / "in"), 2)
    dst = str(tmp_path / "out")
    masks = tsw.main(CLI + ["--image_path", src, "--output_dir", dst, "--streamed", "1"])
    model = tsw.load_model("vit_tiny", 8)
    for name, mask in masks.items():
        files = sorted(os.listdir(os.path.join(dst, name)))
        assert files == ["attention_map_sw.jpg", "otsu_sw.jpg", "otsu_sw_heatmap.jpg"]
        gray = torch.from_numpy(tsw.decode(os.path.join(src, name + ".png"), (SIZE, SIZE)))
        want, attn = tpl.segment_mosaic_streamed(model, gray, 48, 16)
        read = lambda f: np.asarray(Image.open(os.path.join(dst, name, f)))  # noqa: E731
        assert np.array_equal(read("otsu_sw.jpg"), want.numpy()) and np.array_equal(mask, want)
        _, _, heat = tth.threshold_multiplicative(gray, attn)
        assert np.array_equal(read("otsu_sw_heatmap.jpg"), heat.numpy())
        idx = imageio.attention_lut_index(attn).numpy()
        assert np.array_equal(read("attention_map_sw.jpg"), imageio.VIRIDIS[idx])


def test_save_mask_writes_the_mask_only(tmp_path):
    src = _write_pngs(str(tmp_path / "in"), 2)
    dst = str(tmp_path / "out")
    tsw.main(CLI + ["--image_path", src, "--output_dir", dst, "--save", "mask"])
    assert sorted(_files(dst)) == [os.path.join("m0", "otsu_sw.jpg"),
                                   os.path.join("m1", "otsu_sw.jpg")]


def test_writer_count_does_not_change_the_files(tmp_path):
    src = _write_pngs(str(tmp_path / "in"), 3)
    outs = []
    for writers in ("1", "3"):
        dst = str(tmp_path / f"out{writers}")
        tsw.main(CLI + ["--image_path", src, "--output_dir", dst, "--writers", writers])
        outs.append(_files(dst))
    assert len(outs[0]) == 9 and outs[0] == outs[1]


def test_directory_masks_equal_single_image_masks(tmp_path):
    src = _write_pngs(str(tmp_path / "in"), 2)
    masks = tsw.main(CLI + ["--image_path", src, "--output_dir", str(tmp_path / "dir"),
                            "--streamed", "1", "--writers", "2"])
    for name, mask in masks.items():
        out = str(tmp_path / name)
        single = tsw.main(CLI + ["--image_path", os.path.join(src, name + ".png"),
                                 "--output_dir", out, "--streamed", "1"])[""]
        assert np.array_equal(single, mask)
        assert _files(out) == _files(str(tmp_path / "dir" / name))


def test_cli_refuses_negative_writers(tmp_path):
    with pytest.raises(SystemExit, match="--writers"):
        tsw.main(CLI + ["--image_path", str(tmp_path), "--writers", "-1"])

"""The port's attention-analysis CLI against the repository's root
analyse_attention.py, and its image writer against matplotlib.

The root script's analyse_single / analyse_croped and the port's run on the
same PNG and the same weights (a local checkpoint the root script converts);
every flag of the root script is exercised. Held: the same file names; the
masks (files the reference saves with the gray colormap) at Dice >= 0.999;
each colormapped map within one level of its colormap on every pixel (the
two packages' f32 attention differs in summation order); the region
centroids equal. The JAX package's native wrappers run on the library the
port built from the same source, so that nothing is written under
``native/``.
"""

import argparse
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu import cli as jcli
from vit_ocm_wmsegmentation_tpu import native as jnative
from vit_ocm_wmsegmentation_tpu.models import vit as jvit
from vit_ocm_wmsegmentation_tpu.ops import morphology as jmorph
from vit_ocm_wmsegmentation_tpu.ops.threshold import yen_binary_u8 as jyen
from vit_ocm_wmsegmentation_tpu_torch import analyse_attention as tan
from vit_ocm_wmsegmentation_tpu_torch import native as tnative
from vit_ocm_wmsegmentation_tpu_torch.models import vit as tvit
from vit_ocm_wmsegmentation_tpu_torch.ops import morphology as tmorph
from vit_ocm_wmsegmentation_tpu_torch.ops.threshold import yen_binary_u8 as tyen
from vit_ocm_wmsegmentation_tpu_torch.sw_processing import load_model
from vit_ocm_wmsegmentation_tpu_torch.utils import imageio

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZE = 96
GRAY_FILES = ("OTSU_th", "heatmap_otsu", "YEN_th")  # masks, saved with cmap="gray"


@pytest.fixture(autouse=True)
def jax_native_on_the_port_library(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", tnative.load())


def _root_module():
    spec = importlib.util.spec_from_file_location("root_analyse_attention",
                                                  os.path.join(ROOT, "analyse_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_image(path, seed=0, size=SIZE):
    """Bright disks (5 of radius 4-9) on a dark, noisy background: several
    ROIs above Yen's threshold, so the region-query mode has queries."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    img = np.full((size, size), 25.0)
    for _ in range(5):
        cy, cx = rng.integers(10, size - 10, 2)
        r = rng.integers(4, 10)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(150, 230)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    Image.fromarray(img).convert("RGB").save(path)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(image path, checkpoint path, JAX params and config, port model)."""
    tmp = tmp_path_factory.mktemp("analyse")
    img = _write_image(tmp / "tile.png")
    model = tvit.init(tvit.VIT_TINY(patch_size=8), torch.Generator().manual_seed(7))
    ckpt = str(tmp / "vit_tiny.pth")
    torch.save({"teacher": model.state_dict()}, ckpt)
    params, cfg, source = jcli.load_model("vit_tiny", 8, ckpt, "teacher")
    assert source == ckpt
    tmodel = load_model("vit_tiny", 8, ckpt, "teacher", device="cpu")
    return img, params, cfg, tmodel


def _args(out, **kw):
    base = dict(image_size=[SIZE, SIZE], output_dir=str(out), threshold=0.1, crop=1,
                window_stride=0, region_query=False, query_analysis=False, query_rate=4,
                save_query=False, save_feature=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


_VIRIDIS_INDEX = {tuple(c): i for i, c in enumerate(imageio.VIRIDIS.tolist())}


def _read(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _viridis_levels(rgb):
    return np.vectorize(lambda r, g, b: _VIRIDIS_INDEX[(r, g, b)])(*np.moveaxis(rgb, -1, 0))


def _dice(a, b):
    a, b = a > 127, b > 127
    return 2 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1)


def _compare_trees(got_root, want_root):
    got, want = _files(got_root), _files(want_root)
    assert got == want
    # adjacent levels of matplotlib's gray table differ by up to 2 bytes
    gray_step = int(np.diff(imageio.GRAY[:, 0].astype(int)).max())
    for rel in want:
        g, w = _read(os.path.join(got_root, rel)), _read(os.path.join(want_root, rel))
        assert g.shape == w.shape, rel
        name = os.path.basename(rel)
        if name.startswith(GRAY_FILES):
            assert (g[..., 0] == g[..., 2]).all() and set(np.unique(g)) <= {0, 255}, rel
            assert _dice(g[..., 0], w[..., 0]) >= 0.999, rel
        elif name == "img.png":  # the RGB input, uint8(x * 255)
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, rel
        elif "features" in rel.split(os.sep) or name == "weighted_iamge_attention.png":
            assert np.abs(g.astype(int) - w.astype(int)).max() <= gray_step, rel
        else:
            lv = np.abs(_viridis_levels(g) - _viridis_levels(w))
            assert lv.max() <= 1, f"{rel}: {lv.max()} viridis levels"
    return want


def _run_both(setup, tmp_path, fn, **kw):
    img, params, cfg, tmodel = setup
    root = _root_module()
    getattr(root, fn)(_args(tmp_path / "root", **kw), params, cfg, img)
    getattr(tan, fn)(_args(tmp_path / "port", **kw), tmodel, img)
    return _compare_trees(str(tmp_path / "port"), str(tmp_path / "root"))


MODES = {
    "plain": {},
    "save_feature": {"save_feature": True},
    "region_query": {"region_query": True, "save_query": True},
    "query_analysis": {"query_analysis": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_analyse_single_matches_root(setup, tmp_path, mode):
    files = _run_both(setup, tmp_path, "analyse_single", **MODES[mode])
    assert "tile/attn-head2.png" in files and "tile/OTSU_th_average.png" in files
    if mode == "save_feature":
        assert sum(f.startswith("tile/features/") for f in files) == 191
    if mode == "region_query":
        assert "tile/YEN_th.png" in files
        assert sum(f.startswith("tile/queries/") for f in files) >= 2
        assert "tile/attn-average-queried-threshold/OTSU_th_average.png" in files
    if mode == "query_analysis":
        # 12 x 12 grid, rate 4: queries i * 12 * 4 + j * 4 for i, j < 3
        want = sorted(f"tile/analysis/attn-average-{i * 48 + j * 4}.png"
                      for i in range(3) for j in range(3))
        assert sorted(f for f in files if f.startswith("tile/analysis/")) == want


@pytest.mark.parametrize("crop", [1, 4, 16])
def test_analyse_croped_matches_root(setup, tmp_path, crop):
    files = _run_both(setup, tmp_path, "analyse_croped", crop=crop)
    assert f"tile/croped_{crop}/attn-average.png" in files
    assert f"tile/croped_{crop}/img.png" in files


def test_query_analysis_beyond_the_grid_writes_no_map(setup, tmp_path):
    """query_rate larger than the grid: the reference's loops run no time."""
    _, _, _, tmodel = setup
    tan.analyse_single(_args(tmp_path, query_analysis=True, query_rate=50), tmodel, setup[0])
    assert os.listdir(tmp_path / "tile" / "analysis") == []


def test_region_centroids_equal_jax(setup):
    """The region query's points: Yen mask, ROIs and centroids of both
    packages on the CLI's gray image."""
    img = setup[0]
    gray = np.array(Image.open(img).convert("RGB").resize(
        (SIZE, SIZE), Image.Resampling.BICUBIC).convert("L"), np.uint8)
    jb = np.asarray(jyen(jax.numpy.asarray(gray)))
    tb = tyen(torch.from_numpy(gray)).numpy()
    assert np.array_equal(jb, tb)
    jl, tl = jmorph.get_rois(jb), tmorph.get_rois(tb)
    assert np.array_equal(jl, tl) and tl.max() >= 3
    assert tmorph.region_centroids(tl) == [tuple(map(float, p)) for p in jmorph.region_centroids(jl)]


def test_cli_main_writes_every_mode(setup, tmp_path, capsys):
    """main() with the root script's flags (type=bool ones as strings) on
    the CPU, random weights: the single image with every option, the crop
    path with the int8 route, window_stride in bf16, then a bad crop, which
    prints and writes nothing."""
    img = setup[0]
    out = tmp_path / "out"
    base = ["--arch", "vit_tiny", "--image_path", img, "--image_size", str(SIZE), "--output_dir",
            str(out), "--device", "cpu"]
    assert tan.main(base + ["--save_feature", "1", "--region_query", "False", "--query_analysis",
                            "yes", "--query_rate", "6", "--save_query", "1"]) == [img]
    files = _files(out)
    # "False" is a non-empty string: true, as in the reference
    assert "tile/YEN_th.png" in files and "tile/analysis/attn-average-0.png" in files
    tan.main(base + ["--crop", "4", "--quant", "int8", "--infer_mlp", "none"])
    assert "tile/croped_4/OTSU_th_original.png" in _files(out)
    tan.main(base + ["--window_stride", "8", "--bf16", "1"])  # window_stride: the crop path
    assert "tile/croped_1/attn-average.png" in _files(out)
    n = len(_files(out))
    tan.main(base + ["--crop", "3"])
    assert "crop must be 1, 4 or 16" in capsys.readouterr().out and len(_files(out)) == n


def test_cli_has_every_root_flag():
    root_flags = {a.dest for a in _parser_of(_root_module())._actions}
    port_flags = {a.dest for a in _parser_of(tan)._actions}
    assert root_flags <= port_flags
    assert port_flags - root_flags == {"device", "bf16"}
    args = tan.parse_args([])
    assert args.device == "cuda" and args.image_size == (384, 384) and args.crop == 1


def _parser_of(mod):
    """The ArgumentParser a module's parse_args() builds, caught before it
    parses."""
    from unittest import mock

    class Built(Exception):
        pass

    def grab(self, *a, **k):
        raise Built(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Built) as built:
            mod.parse_args()
    return built.value.args[0]


def test_cli_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tan.main(["--image_path", str(tmp_path), "--arch", "vit_tiny"])


# --- imsave against matplotlib -------------------------------------------------------


def _mpl_save(path, arr, cmap=None):
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.imsave(fname=path, arr=arr, format="png", cmap=cmap)
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rule", ["viridis_f32", "gray_f32", "rgb_f32", "viridis_u8", "gray_bool",
                                  "constant"])
def test_imsave_equals_matplotlib(tmp_path, rule, seed):
    """The three rules of plt.imsave (a 2-D map through viridis, through
    gray, an (H, W, 3) float image), and uint8, bool and constant maps:
    the decoded RGBA pixels equal matplotlib's, byte for byte."""
    rng = np.random.default_rng(seed)
    a = (rng.random((37, 53)) ** 3 * rng.uniform(1e-3, 1e3)).astype(np.float32)
    arr, cmap = {
        "viridis_f32": (a, None),
        "gray_f32": (a, "gray"),
        "rgb_f32": (rng.random((37, 53, 3)).astype(np.float32), None),
        "viridis_u8": ((a / a.max() * 255).astype(np.uint8), None),
        "gray_bool": (a > np.median(a), "gray"),
        "constant": (np.full((9, 7), 3.5, np.float32), None),
    }[rule]
    want = _mpl_save(str(tmp_path / "mpl.png"), arr, cmap)
    imageio.imsave(str(tmp_path / "port.png"), torch.from_numpy(np.ascontiguousarray(arr)), cmap)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)


def test_gray_table_equals_matplotlib():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    want = plt.get_cmap("gray")(np.arange(256), bytes=True)[:, :3]
    assert np.array_equal(imageio.GRAY, want)
    assert (imageio.GRAY[:, 0] != np.arange(256)).sum() == 24  # truncated levels


def test_imsave_rejects_what_matplotlib_rejects(tmp_path):
    with pytest.raises(ValueError, match="0..1 range"):
        imageio.imsave(str(tmp_path / "x.png"), torch.full((4, 4, 3), 1.5))
    with pytest.raises(ValueError, match="colormap"):
        imageio.imsave(str(tmp_path / "x.png"), torch.zeros(4, 4), cmap="jet")


def test_jax_params_are_the_port_weights(setup):
    """The root script reads the same checkpoint: its converted params give
    the port's CLS attention grid within f32 noise."""
    img, params, cfg, tmodel = setup
    x = np.random.default_rng(0).random((1, 48, 48, 3), dtype=np.float32)
    want = np.asarray(jvit.cls_attention_grid(params, cfg, jax.numpy.asarray(x)))
    got = tvit.cls_attention_grid(tmodel, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

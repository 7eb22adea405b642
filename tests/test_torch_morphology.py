"""The port's host morphology on its own native binding, its tensor
morphology, CLAHE, the normalizers, the meters and the profiling helpers,
against the JAX package and scipy.

The JAX package's ``native.py`` builds ``native/libocm_native.so`` with make
on first use; here its wrappers are pointed at the library the port built
(the same source), so that these tests never write under ``native/``.
"""

import contextlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from vit_ocm_wmsegmentation_tpu import native as jnative
from vit_ocm_wmsegmentation_tpu.ops import clahe as jclahe
from vit_ocm_wmsegmentation_tpu.ops import morphology as jmorph
from vit_ocm_wmsegmentation_tpu.ops import normalize as jnorm
from vit_ocm_wmsegmentation_tpu.utils import meters as jmeters
from vit_ocm_wmsegmentation_tpu_torch import native
from vit_ocm_wmsegmentation_tpu_torch.ops import clahe as tclahe
from vit_ocm_wmsegmentation_tpu_torch.ops import morphology as tmorph
from vit_ocm_wmsegmentation_tpu_torch.ops import normalize as tnorm
from vit_ocm_wmsegmentation_tpu_torch.utils import meters as tmeters
from vit_ocm_wmsegmentation_tpu_torch.utils import profiling

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

SEEDS = [0, 1, 2, 3]
EIGHT = np.ones((3, 3), bool)


@pytest.fixture(autouse=True)
def jax_native_on_the_port_library(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", native.load())


def _mask(seed, shape=(64, 80), p=0.45):
    return np.random.default_rng(seed).random(shape) > p


def _blobs(seed, size=96):
    """uint8 mask of disks and specks: objects above and below 20 pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    m = np.zeros((size, size), bool)
    for _ in range(8):
        cy, cx = rng.integers(0, size, 2)
        r = rng.integers(1, 9)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    m |= rng.random((size, size)) > 0.985
    return m.astype(np.uint8) * 255


# --- the binding ---------------------------------------------------------------------


def test_native_builds_under_the_lock_with_two_processes(tmp_path):
    """Two processes build one fresh path at once: both get the library,
    it loads, and nothing half-written is left beside it."""
    path = str(tmp_path / "_build" / "libocm_native_test.so")
    code = ("import sys; from vit_ocm_wmsegmentation_tpu_torch import native; "
            "print(native.build(sys.argv[1]))")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))}
    procs = [subprocess.Popen([sys.executable, "-c", code, path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == [path, path]
    assert sorted(os.listdir(tmp_path / "_build")) == ["libocm_native_test.so",
                                                       "libocm_native_test.so.lock"]
    import ctypes

    assert ctypes.CDLL(path).cc_label is not None


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build(str(tmp_path / "broken.so"))
    assert os.listdir(tmp_path) == ["broken.so.lock"]


def test_native_library_is_keyed_by_the_source():
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.isfile(path)
    assert native.SOURCE.endswith(os.path.join("native", "ocm_native.cpp"))


@pytest.mark.parametrize("seed", SEEDS)
def test_cc_label_equals_scipy_and_jax(seed):
    m = _mask(seed)
    labels, n = native.cc_label(m)
    want, wn = ndi.label(m, structure=EIGHT)
    assert n == wn and np.array_equal(labels, want)
    jl, jn = jnative.cc_label(m)
    assert jn == n and np.array_equal(jl, labels)


@pytest.mark.parametrize("seed", SEEDS)
def test_remove_small_objects_equals_scipy_and_jax(seed):
    m = _blobs(seed) > 0
    got = native.remove_small_objects(m, 20)
    assert got.dtype == bool
    assert np.array_equal(got, tmorph.remove_small_objects_plain(m, 20))
    assert np.array_equal(got, jnative.remove_small_objects(m, 20))
    assert np.array_equal(tmorph.remove_small_objects(torch.from_numpy(m)), got)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("radius", [1, 2, 3])
def test_dilation_erosion_equal_scipy_and_jax(seed, radius):
    m, st = _mask(seed), tmorph.disk(radius)
    d = native.binary_dilation(m, st)
    assert np.array_equal(d, ndi.binary_dilation(m, structure=st))
    assert np.array_equal(d, jnative.binary_dilation(m, st))
    for border in (0, 1):
        e = native.binary_erosion(m, st, border_value=border)
        assert np.array_equal(e, ndi.binary_erosion(m, structure=st, border_value=border))
        assert np.array_equal(e, jnative.binary_erosion(m, st, border_value=border))


def test_native_morphology_refuses_asymmetric_elements():
    with pytest.raises(ValueError, match="symmetric, odd-sized"):
        native.binary_dilation(_mask(0), np.ones((2, 2), bool))
    with pytest.raises(ValueError, match="symmetric, odd-sized"):
        native.binary_erosion(_mask(0), np.array([[1, 1, 0]], bool))


@pytest.mark.parametrize("seed", SEEDS)
def test_region_props_equal_jax_and_numpy(seed):
    labels, n = native.cc_label(_blobs(seed))
    areas, cents, bbox = native.region_props(labels, n)
    jareas, jcents, jbbox = jnative.region_props(labels, n)
    assert np.array_equal(areas, jareas) and np.array_equal(cents, jcents)
    assert np.array_equal(bbox, jbbox)
    for i in range(n):
        ys, xs = np.nonzero(labels == i + 1)
        assert areas[i] == ys.size
        np.testing.assert_allclose(cents[i], (xs.mean(), ys.mean()), rtol=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_otsu_threshold_equals_cv2_and_jax(seed):
    import cv2

    img = (np.random.default_rng(seed).random((50, 70)) ** (seed + 1) * 255).astype(np.uint8)
    want, _ = cv2.threshold(img, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    assert native.otsu_threshold(img) == want == jnative.otsu_threshold(img)
    assert native.otsu_threshold(np.zeros((0,), np.uint8)) == 0.0


# --- ops/morphology ------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("op", ["binary_dilation", "binary_erosion", "binary_closing"])
def test_tensor_morphology_equals_jax(op, radius, seed):
    m, st = _mask(seed, (40, 56)), tmorph.disk(radius)
    want = np.asarray(getattr(jmorph, op)(jnp.asarray(m), jmorph.disk(radius)))
    got = getattr(tmorph, op)(torch.from_numpy(m), st)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_disk_equals_jax():
    for r in range(5):
        assert np.array_equal(tmorph.disk(r), jmorph.disk(r))


@pytest.mark.parametrize("seed", SEEDS)
def test_get_rois_and_centroids_equal_jax_and_the_plain_twins(seed):
    mask = _blobs(seed)
    labels = tmorph.get_rois(mask)
    assert labels.dtype == np.int32 and labels.max() >= 2
    assert np.array_equal(labels, jmorph.get_rois(mask))
    assert np.array_equal(labels, tmorph.get_rois_plain(mask))
    pts = tmorph.region_centroids(labels)
    assert pts == [tuple(map(float, p)) for p in jmorph.region_centroids(labels)]
    assert pts == tmorph.region_centroids_plain(labels)
    assert tmorph.get_rois(torch.from_numpy(mask)).tolist() == labels.tolist()
    assert tmorph.region_centroids(np.zeros((5, 5), np.int32)) == []


# --- CLAHE, normalize, meters, profiling -----------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("size", [64, 96, 384])
def test_clahe_bit_equal_to_jax(size, seed):
    rng = np.random.default_rng(seed)
    img = (rng.random((size, size)) ** (1 + 2 * seed) * 255).astype(np.uint8)
    img[: size // 4, : size // 4] = 7  # one flat corner: histograms that clip
    want = np.asarray(jclahe.clahe(jnp.asarray(img)))
    got = tclahe.clahe(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_adaptive_histogram_equalization_equals_jax():
    x = np.random.default_rng(5).normal(120, 90, (64, 64)).astype(np.float32)
    want = np.asarray(jclahe.adaptive_histogram_equalization(jnp.asarray(x)))
    assert np.array_equal(tclahe.adaptive_histogram_equalization(torch.from_numpy(x)).numpy(),
                          want)


def test_clahe_refuses_off_grid_sizes():
    with pytest.raises(ValueError, match="grid"):
        tclahe.clahe(torch.zeros((60, 64), dtype=torch.uint8))


@pytest.mark.parametrize("fn", ["l1_normalize", "l2_normalize", "zscore_normalize",
                                "softmax_normalize"])
@pytest.mark.parametrize("case", ["random", "zeros", "constant"])
def test_normalize_equals_jax(fn, case):
    x = {"random": np.random.default_rng(3).normal(0, 2, (6, 9)),
         "zeros": np.zeros((6, 9)), "constant": np.full((6, 9), -3.0)}[case].astype(np.float32)
    if fn == "softmax_normalize" and case == "constant":
        x[2] = -200.0  # a row whose exponentials underflow to 0
    want = np.asarray(getattr(jnorm, fn)(jnp.asarray(x)))
    got = getattr(tnorm, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))


def test_smoothed_value_and_metric_logger_equal_jax(capsys):
    vals = np.random.default_rng(4).random(30)
    j, t = jmeters.SmoothedValue(window_size=7), tmeters.SmoothedValue(window_size=7)
    for i, v in enumerate(vals):
        j.update(v, n=1 + i % 3)
        t.update(v, n=1 + i % 3)
    for attr in ("median", "avg", "global_avg", "max", "value"):
        assert abs(getattr(t, attr) - getattr(j, attr)) <= 1e-6, attr
    assert str(t) == str(j)
    jl, tl = jmeters.MetricLogger(), tmeters.MetricLogger()
    for v in vals[:5]:
        jl.update(loss=v, acc=1 - v)
        tl.update(loss=v, acc=1 - v)
    assert str(tl) == str(jl) and abs(tl.loss.global_avg - jl.loss.global_avg) <= 1e-6
    t.synchronize_between_processes()  # no process group: the identity
    assert t.count == j.count and abs(t.total - j.total) <= 1e-6
    assert list(tl.log_every(range(4), 2, header="h")) == [0, 1, 2, 3]
    assert "h Total time" in capsys.readouterr().out
    with pytest.raises(AttributeError):
        tl.missing  # noqa: B018


def test_meters_sum_over_a_gloo_group(tmp_path):
    """Two processes in a gloo group: synchronize_between_processes sums
    count and total over both (torch.distributed.all_reduce)."""
    code = """
import sys, torch.distributed as dist
from vit_ocm_wmsegmentation_tpu_torch.utils.meters import SmoothedValue
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[2], world_size=2,
                        rank=rank)
v = SmoothedValue()
v.update(1.5 + rank, n=2 + rank)
v.synchronize_between_processes()
print(v.count, v.total)
dist.destroy_process_group()
"""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-500:] for _, e in outs]
    # rank 0: 1.5 x 2, rank 1: 2.5 x 3 -> count 5, total 10.5
    assert [o.split() for o, _ in outs] == [["5", "10.5"], ["5", "10.5"]]


def test_profiling_helpers_on_the_cpu(tmp_path):
    # no profiler: every span is the one shared null context, which runs its
    # block and dispatches nothing
    spans = {profiling.annotate(name) for name in ("step", "mim.step", "pipeline.tiles")}
    assert len(spans) == 1 and isinstance(next(iter(spans)), contextlib.nullcontext)
    with profiling.annotate("step"):
        assert float(torch.ones(8).sum()) == 8.0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        for _ in range(3):
            with profiling.annotate("traced_span"):
                torch.ones(64).cumsum(0)
    assert sum(e.name == "traced_span" for e in prof.events()) == 3
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "traced_span"]
    assert len(spans) == 3 and all(e["cat"] == "user_annotation" for e in spans)
    assert not torch.autograd._profiler_enabled()

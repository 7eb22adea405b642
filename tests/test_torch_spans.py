"""The port's spans (utils.profiling.annotate) on the CPU, at a tiny size:
the null context without a profiler, the span tree of each unit of work
under ``profiling.trace``, every op of a top span inside one of its leaves,
the loader's span closed across its ``yield``, outputs bit-identical with
and without the profiler, and the CLIs' ``--trace_dir``."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu_torch import mim
from vit_ocm_wmsegmentation_tpu_torch import pipeline as tpl
from vit_ocm_wmsegmentation_tpu_torch import sw_processing as tsw
from vit_ocm_wmsegmentation_tpu_torch.data.datasets import DeviceAugLoader
from vit_ocm_wmsegmentation_tpu_torch.models import simmim
from vit_ocm_wmsegmentation_tpu_torch.models import vit as tvit
from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step
from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer
from vit_ocm_wmsegmentation_tpu_torch.utils import profiling
from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

WINDOW, STRIDE, SIZE = 48, 16, 96  # 4 tile rows of 4 tiles
PORT_SPANS = ("pipeline.", "vit.", "mim.", "data.")
MOSAIC_LEAVES = {"pipeline.tiles", "pipeline.tile_maps", "pipeline.stitch",
                 "pipeline.threshold"}
STEP_LEAVES = {"mim.forward", "mim.backward", "mim.optimizer"}


def _vit(**dinov2):
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32,
                         **dinov2)
    return tvit.init(cfg, torch.Generator().manual_seed(3)).eval()


# the DINOv2 block kind's fields, at the tiny size
DINOV2 = {"num_register_tokens": 4, "ffn": "swiglu", "layerscale": True,
          "pos_interp": "antialias"}


def _mosaic():
    rng = np.random.default_rng(5)
    base = rng.normal(120, 40, (SIZE, SIZE))
    base[30:70, 20:80] += 70
    return torch.from_numpy(np.clip(base, 0, 255).astype(np.uint8))


def _write_images(folder, n, size=40):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(7)
    for i in range(n):
        Image.fromarray((rng.random((size, size)) * 255).astype(np.uint8)).save(
            os.path.join(folder, f"{i}.png"))
    return str(folder)


def _fused(**dinov2):
    mask, attn = tpl.segment_mosaic(_vit(**dinov2), _mosaic(), WINDOW, STRIDE)
    return [mask, attn]


def _streamed():
    mask, attn = tpl.segment_mosaic_streamed(_vit(), _mosaic(), WINDOW, STRIDE)
    return [mask, attn]


def _mim(amp):
    def run():
        model = simmim.init(tvit.ViTConfig(patch_size=8, embed_dim=64, depth=2, num_heads=2,
                                           pretrain_img_size=32),
                            torch.Generator().manual_seed(4))
        cfg = default_config()
        cfg.TRAIN.OPTIMIZER.EPS = 1e-3
        step = make_train_step(model, Optimizer(cfg, model, lambda t: 1e-3), amp=amp)
        rng = np.random.default_rng(6)
        out = []
        with tpl.exact_matmuls():
            for _ in range(2):
                x = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
                mask = torch.from_numpy((rng.random((2, 4, 4)) > 0.5).astype(np.int64))
                out += list(step(x, mask))
        return out + [p.detach().clone() for p in model.parameters()]

    return run


def _loader(tmp_path):
    src = _write_images(tmp_path / "aug", 5)
    paths = sorted(os.path.join(src, f) for f in os.listdir(src))
    loader = DeviceAugLoader(paths, 2, 32, 16, 8, 0.5, seed=1, device="cpu")
    return [t for batch in loader.epoch(0) for t in batch]


# name -> (work(tmp_path), the expected tree of port spans, leaves of its top span)
CASES = {
    "fused": (lambda _: _fused(),
              [("pipeline.segment_mosaic",
                [("pipeline.tiles", []), ("pipeline.tile_maps", [("vit.cls_attention_grid", [])]),
                 ("pipeline.stitch", []), ("pipeline.threshold", [])])],
              MOSAIC_LEAVES),
    # the DINOv2 block kind adds vit.tokens and one vit.ffn a block before the last
    "fused_dinov2": (lambda _: _fused(**DINOV2),
                     [("pipeline.segment_mosaic",
                       [("pipeline.tiles", []),
                        ("pipeline.tile_maps", [("vit.cls_attention_grid",
                                                 [("vit.tokens", []), ("vit.ffn", [])])]),
                        ("pipeline.stitch", []), ("pipeline.threshold", [])])],
                     MOSAIC_LEAVES),
    "streamed": (lambda _: _streamed(),
                 [("pipeline.segment_mosaic_streamed",
                   [("pipeline.tiles", [])]
                   + [("pipeline.band", [("pipeline.tile_maps", [("vit.cls_attention_grid", [])]),
                                         ("pipeline.stitch", [])])] * 4
                   + [("pipeline.threshold", [])])],
                 MOSAIC_LEAVES),
    "mim_f32": (lambda _: _mim(False)(),
                [("mim.step", [("mim.forward", []), ("mim.backward", []),
                               ("mim.optimizer", [])])] * 2,
                STEP_LEAVES),
    "mim_amp": (lambda _: _mim(True)(),
                [("mim.step", [("mim.forward", []), ("mim.backward", []),
                               ("mim.optimizer", [])])] * 2,
                STEP_LEAVES),
    "device_aug": (_loader, [("data.device_aug", [])] * 3, {"data.device_aug"}),
}


def _port_tree(events, parent=None):
    """The port's spans among ``events`` (a profiler's FunctionEvents) as
    [(name, children)], each under its nearest port-span ancestor."""
    def port_parent(e):
        p = e.cpu_parent
        while p is not None and not (p.is_user_annotation and p.name.startswith(PORT_SPANS)):
            p = p.cpu_parent
        return p

    mine = [e for e in events if e.is_user_annotation and e.name.startswith(PORT_SPANS)
            and port_parent(e) is parent]
    mine.sort(key=lambda e: e.time_range.start)
    return [(e.name, _port_tree(events, e)) for e in mine]


def _ops_outside_leaves(span, leaves):
    """Ops (non-span events) under ``span`` that no span of ``leaves`` holds."""
    if span.name in leaves:
        return []
    out = []
    for c in span.cpu_children:
        if c.is_user_annotation:
            out += _ops_outside_leaves(c, leaves)
        else:
            out.append(f"{span.name} > {c.name}")
    return out


def _traced(work, tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        out = work(tmp_path)
    return out, prof.events()


def test_annotate_is_the_shared_null_context_without_a_profiler(tmp_path):
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.annotate("pipeline.tiles"), profiling.annotate("mim.step")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profiling.trace(str(tmp_path / "tr")):
        span = profiling.annotate("traced_span")
        assert isinstance(span, torch.profiler.record_function)
        with span:
            torch.ones(8).sum()
    assert profiling.annotate("after") is a
    assert "traced_span" in (tmp_path / "tr" / "trace.json").read_text()


@pytest.mark.parametrize("case", list(CASES))
def test_each_unit_of_work_emits_its_span_tree(case, tmp_path):
    work, want, _ = CASES[case]
    _, events = _traced(work, tmp_path)
    assert _port_tree(events) == want
    if case.startswith("mim"):  # torch's own AdamW span nests inside mim.optimizer
        opt = [e for e in events if e.name.startswith("Optimizer.step#")]
        assert len(opt) == 2 and all(e.cpu_parent.name == "mim.optimizer" for e in opt)


@pytest.mark.parametrize("case", list(CASES))
def test_every_op_of_a_top_span_runs_under_one_of_its_leaves(case, tmp_path):
    work, want, leaves = CASES[case]
    _, events = _traced(work, tmp_path)
    tops = [e for e in events if e.name == want[0][0]]
    assert len(tops) == len(want)
    assert [op for e in tops for op in _ops_outside_leaves(e, leaves)] == []
    assert all(any(not c.is_user_annotation for c in e.cpu_children)
               for e in events if e.name in leaves - {"pipeline.tile_maps"})


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_are_bit_identical_with_and_without_the_profiler(case, tmp_path):
    work = CASES[case][0]
    plain = work(tmp_path / "plain")
    traced, _ = _traced(work, tmp_path / "traced")
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_the_consumers_work_between_batches_falls_outside_the_loader_span(tmp_path):
    src = _write_images(tmp_path / "aug", 6)
    paths = sorted(os.path.join(src, f) for f in os.listdir(src))
    loader = DeviceAugLoader(paths, 2, 32, 16, 8, 0.5, seed=1, device="cpu")
    with profiling.trace(str(tmp_path / "trace")) as prof:
        for x, _ in loader.epoch(0):
            with torch.profiler.record_function("consumer"):
                x.sum()
    events = prof.events()
    consumer = [e for e in events if e.name == "consumer"]
    assert len(consumer) == 3
    for e in consumer:
        p = e.cpu_parent
        while p is not None:
            assert p.name != "data.device_aug"
            p = p.cpu_parent
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "data.device_aug")
    for e in consumer:
        assert not any(s <= e.time_range.start < t for s, t in spans)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _trace_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("streamed", ["0", "1"])
def test_sw_processing_trace_dir_writes_the_second_mosaic(streamed, tmp_path):
    src = _write_images(tmp_path / "in", 3, size=96)
    out = tmp_path / "trace"
    masks = tsw.main(["--arch", "vit_tiny", "--image_size", "96", "--window_size", "48",
                      "--stride", "16", "--device", "cpu", "--save", "mask", "--streamed",
                      streamed, "--image_path", src, "--output_dir", str(tmp_path / "out"),
                      "--trace_dir", str(out)])
    assert len(masks) == 3
    names = _trace_spans(out / "trace.json")
    top = "pipeline.segment_mosaic" + ("_streamed" if streamed == "1" else "")
    assert names.count(top) == 1 and names.count("vit.cls_attention_grid") >= 1
    assert names.count("pipeline.band") == (4 if streamed == "1" else 0)


def test_sw_processing_without_trace_dir_writes_no_trace(tmp_path, monkeypatch):
    src = _write_images(tmp_path / "in", 2, size=96)
    monkeypatch.chdir(tmp_path)
    tsw.main(["--arch", "vit_tiny", "--image_size", "96", "--window_size", "48", "--stride",
              "16", "--device", "cpu", "--save", "mask", "--image_path", src, "--output_dir",
              str(tmp_path / "out")])
    assert not list(tmp_path.rglob("trace.json"))


def test_mim_trace_dir_traces_steps_two_to_five(tmp_path):
    src = _write_images(tmp_path / "imgs", 6)
    out = tmp_path / "trace"
    _, hist = mim.main(["--image_path", src, "--image_size", "32", "--mask_patch_size", "8",
                        "--batch_size", "2", "--warmup_epochs", "1", "--epochs", "2",
                        "--device", "cpu", "--output", str(tmp_path / "ckpt"),
                        "--output_dir", str(tmp_path / "log"), "--trace_dir", str(out),
                        "--opts", "DATA.DEVICE_AUG", "True"])
    assert len(hist) == 2 and np.isfinite(hist).all()
    names = _trace_spans(out / "trace.json")
    # 3 steps an epoch: steps 2-5 are batches 1-2 of epoch 0 and 0-1 of epoch 1
    assert names.count("mim.step") == 4 and names.count("mim.optimizer") == 4
    assert names.count("data.device_aug") == 5  # 4 batches and epoch 1's set-up


def test_profile_mosaic_reads_device_time_by_span_and_the_union_of_busy_time():
    """utils.profiling's reading of a profiler's capture: each device
    operation goes to the innermost span its launch ran in, and busy time is
    the union of the operations' intervals, so two streams that overlap
    count once."""
    trace = {"traceEvents": [
        _x("user_annotation", "pipeline.segment_mosaic", 0, 100),
        _x("user_annotation", "pipeline.tile_maps", 10, 50),
        _x("user_annotation", "vit.cls_attention_grid", 20, 20),
        _x("user_annotation", "pipeline.threshold", 70, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=2),
        _x("cuda_driver", "cuLaunchKernel", 75, 1, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 80, 1, correlation=4),
        _x("kernel", "attention", 30, 40, tid=7, correlation=1),
        _x("kernel", "resize", 70, 10, tid=7, correlation=2),
        _x("kernel", "histogram", 80, 10, tid=7, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 85, 10, tid=8, correlation=4),
    ]}
    ops = profiling.device_ops(trace)
    assert [(name, span) for name, _, _, span in ops] == [
        ("attention", "vit.cls_attention_grid"), ("resize", "pipeline.tile_maps"),
        ("histogram", "pipeline.threshold"), ("Memcpy DtoH", "pipeline.threshold")]
    assert profiling.span_device_ms(ops) == {"vit.cls_attention_grid": 0.040,
                                             "pipeline.tile_maps": 0.010,
                                             "pipeline.threshold": 0.015}
    assert profiling.union_ms((s, e) for _, s, e, _ in ops) == pytest.approx(0.065)  # not 0.070

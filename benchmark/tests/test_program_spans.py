"""The readers of the program's own spans (program_spans.py) on hand-made
Chrome traces: port spans nested under the benchmark's give each new metric
its value and leave the readers they succeed silent; a trace whose program
opens no span of its own (the benchmark's spans alone) leaves the new
readers silent."""

from __future__ import annotations

import pytest

from benchmark import program_spans as ps
from benchmark import spec
from benchmark.tests.test_bench_trace import TRACE as BENCH_SPANS_ONLY
from benchmark.tracing import TraceView


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _launch(ts, corr, dev_start, dev_dur, name="kernel_a", cat="kernel"):
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 2, correlation=corr),
            _x(cat, name, dev_start, dev_dur, tid=7, correlation=corr)]


def _span(name, ts, dur, tid=1):
    return _x("user_annotation", name, ts, dur, tid=tid)


TRACE = {"traceEvents": [
    _span("traced_window", 0, 2000),
    # a mosaic: the benchmark's segment and vit around the port's spans
    _span("segment", 10, 890),
    _span("pipeline.segment_mosaic", 20, 860),
    _span("pipeline.tiles", 30, 30), *_launch(40, 1, 100, 50),
    _span("pipeline.tile_maps", 70, 530),
    _span("vit", 80, 420),
    _span("vit.cls_attention_grid", 85, 410), *_launch(90, 2, 150, 300, "attention_wgmma_kernel"),
    *_launch(550, 3, 450, 50),  # resize, under pipeline.tile_maps
    _span("pipeline.stitch", 610, 90), *_launch(620, 4, 500, 60),
    _span("pipeline.threshold", 710, 160), *_launch(720, 5, 560, 40),
    *_launch(730, 6, 580, 40, "Memcpy DtoD", "gpu_memcpy"),  # overlaps the last by 20
    _span("to_host", 900, 50), *_launch(910, 7, 620, 20, "Memcpy DtoH", "gpu_memcpy"),
    # a mosaic span on another thread, and one the window's end cuts
    _span("pipeline.segment_mosaic", 300, 100, tid=2),
    _span("segment", 1950, 200), _span("pipeline.segment_mosaic", 1950, 150),
    # a batch and a step: the benchmark's loader and step around the port's spans
    _span("loader", 1000, 100),
    _span("data.device_aug", 1005, 85), *_launch(1010, 8, 1100, 80),
    _span("step", 1200, 700),
    _span("mim.step", 1210, 680),
    _span("mim.forward", 1220, 180), *_launch(1230, 9, 1250, 200),
]}
UNITS = {"mosaics": 2, "mp": 2.0, "steps": 1, "images": 16, "batches": 1}


@pytest.fixture
def view():
    return TraceView(TRACE, UNITS)


def test_port_spans_are_the_innermost_launching_spans(view):
    by_span = {sp for _, _, _, sp in view.ops}
    assert by_span == {"pipeline.tiles", "vit.cls_attention_grid", "pipeline.tile_maps",
                       "pipeline.stitch", "pipeline.threshold", "to_host", "data.device_aug",
                       "mim.forward"}


@pytest.mark.parametrize("metric, cell, want", [
    # tiles 100-150, resize 450-500, stitch 500-560, threshold 560-620: 220 us over 2 MP
    ("pipeline_dev_ms_per_mp.serve", "tiny_fused_cell", 0.220 / 2.0),
    ("pipeline_dev_ms_per_mp.streamed", "tiny_streamed_cell", 0.220 / 2.0),
    # 860 us, and 50 us of the span the window cuts; not the other thread's
    ("issue_ms_per_mp.serve", "tiny_fused_cell", 0.910 / 2.0),
    ("issue_ms_per_mp.streamed", "tiny_streamed_cell", 0.910 / 2.0),
    ("aug_dev_ms.train", "tiny_mim_cell", 0.080),
    ("aug_dev_ms.f32", "tiny_mim_cell", 0.080),
    ("issue_ms_per_step.train", "tiny_mim_cell", 0.680),
    ("issue_ms_per_step.f32", "tiny_mim_cell", 0.680),
])
def test_each_new_reader_gives_its_value(cell_of, view, metric, cell, want):
    c = cell_of(cell)
    assert metric in {m["name"] for m in c.per_layer}
    assert spec.metric_reader(metric, c.bench_dir)(view, c) == pytest.approx(want)


@pytest.mark.parametrize("metric, cell", [
    ("post_dev_ms_per_mp.serve", "tiny_fused_cell"),
    ("post_dev_ms_per_mp.streamed", "tiny_streamed_cell"),
    ("loader_dev_ms.train", "tiny_mim_cell"),
    ("loader_dev_ms.f32", "tiny_mim_cell"),
])
def test_the_readers_the_new_ones_succeed_read_none(cell_of, view, metric, cell):
    c = cell_of(cell)
    assert spec.metric_reader(metric, c.bench_dir)(view, c) is None


@pytest.mark.parametrize("reader", [ps.pipeline_dev_ms_per_mp, ps.issue_ms_per_mp,
                                    ps.aug_dev_ms, ps.issue_ms_per_step])
def test_the_new_readers_are_silent_without_port_spans(cell_of, reader):
    v = TraceView(BENCH_SPANS_ONLY, UNITS)
    assert reader(v, cell_of("tiny_fused_cell")) is None


@pytest.mark.parametrize("reader", [ps.issue_ms_per_mp, ps.issue_ms_per_step])
def test_the_host_readers_are_silent_where_nothing_ran_on_the_device(cell_of, reader):
    events = [e for e in TRACE["traceEvents"] if e["cat"] == "user_annotation"]
    v = TraceView({"traceEvents": events}, UNITS)
    assert reader(v, cell_of("tiny_fused_cell")) is None


def test_the_breakdown_names_gaps_by_the_port_spans(view):
    # busy 100-640, 1100-1180, 1250-1450: the gaps from 640 (in pipeline.stitch)
    # and from 1450 (in mim.step after mim.forward) take the port's names
    gaps = {round(g * 1e6): name for name, g in view.breakdown()["idle_gaps"]}
    assert gaps == {100: "outside_spans", 460: "pipeline.stitch", 70: "outside_spans",
                    550: "mim.step"}

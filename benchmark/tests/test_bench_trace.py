"""The trace reading on a hand-made Chrome trace: busy time is the union of
device intervals (two streams that overlap count once), kernels belong to
the innermost span their launch ran in, and the breakdown names idle gaps by
the main thread's span."""

from __future__ import annotations

import pytest

from benchmark import spec
from benchmark.tracing import TraceView, union


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


TRACE = {"traceEvents": [
    _x("user_annotation", "traced_window", 0, 1000),
    _x("user_annotation", "segment", 10, 500),
    _x("user_annotation", "vit", 20, 200),
    _x("user_annotation", "loader", 600, 100),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 2, correlation=1),
    _x("cuda_driver", "cuLaunchKernelEx", 300, 2, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 650, 2, correlation=3),
    _x("kernel", "void vitocm::attention_wgmma_kernel<64, false>(CUtensorMap_st)", 100, 300,
       tid=7, correlation=1),
    _x("kernel", "at::native::add_kernel", 350, 100, tid=8, correlation=2),
    _x("gpu_memcpy", "Memcpy HtoD", 700, 100, tid=9, correlation=3),
    _x("kernel", "outside the window", 1500, 100, tid=7, correlation=99),
]}


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def test_busy_time_is_the_union_and_spans_attribute_kernels():
    v = TraceView(TRACE, {"mosaics": 2, "mp": 2.0})
    assert v.window_s == pytest.approx(1e-3)
    assert v.busy_s == pytest.approx((450 - 100 + 100) / 1e6)  # 100-450 and 700-800
    assert v.device_s(r"attention_wgmma_kernel") == pytest.approx(300e-6)
    assert v.device_s(span="vit") == pytest.approx(300e-6)
    assert v.device_s(span="segment") == pytest.approx(100e-6)
    assert v.device_s(span="loader") == pytest.approx(100e-6)


def test_breakdown_sums_by_name_and_names_gaps():
    b = TraceView(TRACE, {}).breakdown()
    assert b["device_ops"][0] == ["vitocm::attention_wgmma_kernel<64, false>", pytest.approx(3e-4)]
    gaps = dict((round(g * 1e6), name) for name, g in b["idle_gaps"])
    assert gaps == {100: "outside_spans", 250: "segment", 200: "outside_spans"}


def test_metric_readers_on_the_hand_made_trace(cell_of):
    cell = cell_of("tiny_fused_cell")
    v = TraceView(TRACE, {"mosaics": 2, "mp": 2.0})
    idle = spec.metric_reader("device_idle.serve", cell.bench_dir)(v, cell)
    assert idle == pytest.approx(100 * (1 - 450e-6 / 1e-3))
    post = spec.metric_reader("post_dev_ms_per_mp.serve", cell.bench_dir)(v, cell)
    assert post == pytest.approx(100e-6 * 1e3 / 2.0)
    attn = spec.metric_reader("attn_roofline.serve", cell.bench_dir)(v, cell)
    assert 0 < attn < 100
    assert spec.metric_reader("mlp_roofline.serve", cell.bench_dir)(v, cell) is None

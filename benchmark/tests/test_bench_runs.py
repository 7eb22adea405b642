"""Runs of tiny cells on the CPU, the chip's look skipped: a sound run is
correct; the control (the reference one precision down in the program's
place) and every planted fault come out not correct; a cell, a
configuration and a metric are each added as new files."""

from __future__ import annotations

import functools
import json

import pytest
import torch

from benchmark import faults, run, spec
from benchmark.runners import serve, train
from benchmark.tests.conftest import TINY_VIT

CPU = torch.device("cpu")
SEED = 2**31 + 424242


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, tmp_path, trace=0, seconds=0.5, **hooks):
    return run.run_cell(cell, SEED, seconds, trace, CPU, str(tmp_path), t_start=0.0, **hooks)[0]


@pytest.mark.parametrize("workload", ["tiny_fused_cell", "tiny_streamed_cell", "tiny_mim_cell"])
def test_sound_run_is_correct(cell_of, tmp_path, workload):
    cell = cell_of(workload)
    res = _run(cell, tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == e2e and "setup_s" in e2e
    assert json.loads(json.dumps(res)) == res


@pytest.mark.parametrize("workload", ["tiny_fused_cell", "tiny_mim_cell"])
def test_traced_run_reads_the_trace(cell_of, tmp_path, workload):
    res = _run(cell_of(workload), tmp_path, trace=1)
    assert res["correct"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    # the CPU trace holds no device operation: every device metric stays silent
    assert res["metrics"] == {}


@pytest.mark.parametrize("workload, control", [("tiny_fused_cell", "tf32"),
                                               ("tiny_streamed_cell", "tf32")])
def test_serving_control_fails(cell_of, tmp_path, workload, control):
    hook = functools.partial(serve.reference_segment, precision=control)
    res = _run(cell_of(workload), tmp_path, seconds=0.3, segment_factory=hook)
    assert not res["correct"], res["checks"]
    assert res["checks"]["canvas_rel"]["value"] > res["checks"]["canvas_rel"]["limit"]


def test_training_control_fails(cell_of, tmp_path):
    hook = functools.partial(train.ReferenceTrainer, precision="tf32")
    res = _run(cell_of("tiny_mim_cell"), tmp_path, seconds=0.3, trainer_factory=hook)
    assert not res["correct"], res["checks"]


def test_reference_in_the_programs_place_at_full_precision_passes(cell_of, tmp_path):
    """The control's other side: the same reference at float32 passes, so it
    is the precision that fails the control."""
    hook = functools.partial(serve.reference_segment, precision="float32")
    assert _run(cell_of("tiny_fused_cell"), tmp_path, seconds=0.3, segment_factory=hook)["correct"]


@pytest.mark.parametrize("workload", ["tiny_fused_cell", "tiny_streamed_cell"])
@pytest.mark.parametrize("fault", faults.SERVE_FAULTS)
def test_serving_fault_fails(cell_of, tmp_path, workload, fault):
    res = _run(cell_of(workload), tmp_path, segment_factory=faults.serve_factory(fault))
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("fault", faults.TRAIN_FAULTS)
def test_training_fault_fails(cell_of, tmp_path, fault):
    res = _run(cell_of("tiny_mim_cell"), tmp_path, trainer_factory=faults.train_factory(fault))
    assert not res["correct"], (fault, res["checks"])


def _add(root, doc_update):
    path = root / "BENCHMARK.json"
    doc = json.loads(path.read_text())
    doc_update(doc)
    path.write_text(json.dumps(doc))


def test_a_cell_a_configuration_and_a_metric_are_new_files(tiny_root, tmp_path):
    bench = tiny_root / "bench"
    cfg = dict(TINY_VIT, name="tiny_vit_d3", depth=3)
    (bench / "configs" / "tiny_vit_d3.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "tiny_fused.json").read_text())
    (bench / "traffic" / "tiny_fused_pool5.json").write_text(json.dumps(dict(traffic, pool=5)))
    (bench / "workloads" / "tiny_new_cell.json").write_text(
        (bench / "workloads" / "tiny_fused_cell.json").read_text())
    (bench / "metrics" / "window_mosaics.serve.py").write_text(
        "def read(view, cell):\n    return float(view.units['mosaics'])\n")

    def update(doc):
        doc["configs"].append({"name": "tiny_vit_d3", "source": "test",
                               "file": "bench/configs/tiny_vit_d3.json", "reduced": ["depth"],
                               "why": "test"})
        doc["workloads"].append({"name": "tiny_new_cell", "config": "tiny_vit_d3",
                                 "traffic": "tiny_fused_pool5", "chips": 1, "why": "test"})
        for m in doc["end_to_end"] + doc["per_layer"]:
            if "tiny_fused_cell" in m.get("workloads", []):
                m["workloads"].append("tiny_new_cell")
        doc["per_layer"].append({"name": "window_mosaics.serve", "unit": "mosaics",
                                 "better": "higher", "source": "program_counter",
                                 "layer": "pipeline", "moves": "seg_mp_per_s",
                                 "workloads": ["tiny_new_cell"]})

    _add(tiny_root, update)
    cell = spec.load_cell("tiny_new_cell", root=str(tiny_root), bench_dir=str(bench))
    assert cell.config["depth"] == 3 and cell.traffic["pool"] == 5
    assert "window_mosaics.serve" in {m["name"] for m in cell.per_layer}
    res = _run(cell, tmp_path, trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["window_mosaics.serve"]["value"] == traffic["trace_mosaics"]


RUNNER = '''"""A runner of a new traffic kind: the serving runner on a pool twice as large."""

from benchmark.runners import serve


def run(cell, seed, seconds, trace, device, tmpdir, **hooks):
    cell.traffic = dict(cell.traffic, pool=2 * cell.traffic["pool"])
    rec = serve.run(cell, seed, seconds, trace, device, tmpdir, **hooks)
    rec["metrics"]["pool_size"] = cell.traffic["pool"]
    return rec
'''


def test_a_traffic_kind_is_a_new_runner_file(tiny_root, tmp_path):
    bench = tiny_root / "bench"
    (bench / "runners").mkdir()
    (bench / "runners" / "serve_twice.py").write_text(RUNNER)
    traffic = json.loads((bench / "traffic" / "tiny_fused.json").read_text())
    (bench / "traffic" / "tiny_twice.json").write_text(json.dumps(dict(traffic, kind="serve_twice")))
    (bench / "workloads" / "tiny_twice_cell.json").write_text(
        (bench / "workloads" / "tiny_fused_cell.json").read_text())

    def update(doc):
        doc["workloads"].append({"name": "tiny_twice_cell", "config": "tiny_vit",
                                 "traffic": "tiny_twice", "chips": 1, "why": "test"})
        doc["end_to_end"].append({"name": "pool_size", "unit": "mosaics", "better": "higher",
                                  "bound": 0.01, "source": "host_clock",
                                  "workloads": ["tiny_twice_cell"]})

    _add(tiny_root, update)
    cell = spec.load_cell("tiny_twice_cell", root=str(tiny_root), bench_dir=str(bench))
    res = _run(cell, tmp_path)
    assert res["correct"], res["checks"]
    assert res["metrics"]["pool_size"]["value"] == 2 * traffic["pool"]


def test_a_quantity_is_reported_under_each_variant_of_its_name(cell_of):
    cell = cell_of("tiny_fused_cell")
    cell.end_to_end = [{"name": "seg_mp_per_s.fused", "unit": "MP/s"},
                       {"name": "seg_mp_per_s", "unit": "MP/s"}, {"name": "setup_s", "unit": "s"}]
    out = run.end_to_end(cell, {"seg_mp_per_s": 3.0, "seg_p95_ms": 9.0})
    assert out == {"seg_mp_per_s.fused": {"value": 3.0, "unit": "MP/s"},
                   "seg_mp_per_s": {"value": 3.0, "unit": "MP/s"}}


def test_metrics_without_a_workloads_key_go_to_every_cell_of_their_end_to_end_metric():
    e2e = {"seg_mp_per_s", "setup_s"}
    assert spec._reports({"name": "x", "moves": "seg_mp_per_s"}, "any", e2e)
    assert not spec._reports({"name": "x", "moves": "train_img_per_s"}, "any", e2e)
    assert not spec._reports({"name": "x", "moves": "seg_mp_per_s", "workloads": ["b"]}, "a", e2e)


def test_the_real_benchmark_loads_every_cell():
    with open(spec.ROOT + "/BENCHMARK.json") as f:
        doc = json.load(f)
    for w in doc["workloads"]:
        cell = spec.load_cell(w["name"])
        assert callable(spec.runner(cell.traffic["kind"]))
        assert set(cell.limits["limits"]) >= ({"canvas_rel", "tile_rel", "mask_own_px"}
                                              if cell.traffic["kind"] == "serve"
                                              else {"loss_rel", "grad1_leaf", "delta3_leaf"})
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}

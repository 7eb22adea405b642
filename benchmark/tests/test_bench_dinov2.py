"""A tiny DINOv2 serving cell (traffic kind ``serve_dinov2``) on the CPU:
a sound run is correct; the control (the reference in float8 operands in the
program's place) and every planted fault come out not correct; its per-layer
metrics are new files that read nothing on the CPU. And every cell of the
real benchmark loads with the limits its traffic kind judges."""

from __future__ import annotations

import functools
import json
import re

import pytest
import torch

from benchmark import calibrate_dinov2, faults, readers, roofline, roofline_dinov2, run, spec
from benchmark.runners import serve_dinov2

CPU = torch.device("cpu")
SEED = 2**31 + 424243

TINY_G14 = {"name": "tiny_g14", "source": "test fixture", "patch_size": 14, "embed_dim": 128,
            "depth": 3, "num_heads": 2, "mlp_ratio": 4, "ffn": "swiglu", "ffn_hidden": 344,
            "layerscale": True, "num_register_tokens": 4, "pos_interp": "antialias",
            "qkv_bias": True, "ln_eps": 1e-6, "img_size": 70, "precision": "float32",
            "infer_mlp": "auto", "quant": "none",
            "weights": {"dtype": "float32", "std": 0.02, "bias_std": 0.02, "gamma_low": 0.1,
                        "gamma_high": 1.0}}
TRAFFIC = {"kind": "serve_dinov2", "route": "fused", "size": 112, "window": 56, "stride": 28,
           "blob": 28, "pool": 3, "prefetch_depth": 2, "warmup": 1, "trace_mosaics": 2}
# the CPU runs the port's plain twins in float32: the gaps to the reference
# are rounding (canvas ~1e-7); the limits sit well above them and far below
# what the control and the faults read
LIMITS = {"sample": 2, "judge_within": 2,
          "limits": {"canvas_rel": 1e-4, "tile_rel": 1e-4, "mask_ref_px": 0.0,
                     "mask_own_px": 0.0}}
G14_METRICS = ("device_idle.g14", "mfu.g14", "attn_roofline.g14", "gate_roofline.g14",
               "lsnorm_roofline.g14", "ffn_dev_ms_per_mp.g14", "pipeline_dev_ms_per_mp.g14")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def g14_cell(tiny_root):
    bench = tiny_root / "bench"
    (bench / "configs" / "tiny_g14.json").write_text(json.dumps(TINY_G14))
    (bench / "traffic" / "tiny_g14.json").write_text(json.dumps(TRAFFIC))
    (bench / "workloads" / "tiny_g14_cell.json").write_text(json.dumps(LIMITS))
    path = tiny_root / "BENCHMARK.json"
    doc = json.loads(path.read_text())
    doc["configs"].append({"name": "tiny_g14", "source": "test", "reduced": [], "why": "test",
                           "file": "bench/configs/tiny_g14.json"})
    doc["workloads"].append({"name": "tiny_g14_cell", "config": "tiny_g14",
                             "traffic": "tiny_g14", "chips": 1, "why": "test"})
    path.write_text(json.dumps(doc))
    return spec.load_cell("tiny_g14_cell", root=str(tiny_root), bench_dir=str(bench))


def _run(cell, tmp_path, trace=0, seconds=0.3, **hooks):
    return run.run_cell(cell, SEED, seconds, trace, CPU, str(tmp_path), t_start=0.0, **hooks)[0]


def test_the_tiny_cell_takes_the_real_cells_metrics(g14_cell):
    assert {m["name"] for m in g14_cell.end_to_end} == {"seg_mp_per_s", "seg_p95_ms",
                                                         "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in g14_cell.per_layer} == set(G14_METRICS)


def test_sound_run_is_correct(g14_cell, tmp_path):
    res = _run(g14_cell, tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"seg_mp_per_s", "seg_p95_ms", "peak_mem_gib", "setup_s"}
    assert set(res["checks"]) == {"canvas_rel", "tile_rel", "mask_ref_px", "mask_own_px",
                                  "unjudged"}


def test_traced_run_reads_nothing_on_the_cpu(g14_cell, tmp_path):
    res = _run(g14_cell, tmp_path, trace=1)
    assert res["correct"] and res["device"]["window_s"] > 0
    assert res["metrics"] == {}


def test_control_fails(g14_cell, tmp_path):
    hook = functools.partial(serve_dinov2.reference_segment, precision="fp8")
    res = _run(g14_cell, tmp_path, segment_factory=hook)
    assert not res["correct"], res["checks"]
    assert res["checks"]["canvas_rel"]["value"] > res["checks"]["canvas_rel"]["limit"]


def test_reference_in_the_programs_place_at_full_precision_passes(g14_cell, tmp_path):
    hook = functools.partial(serve_dinov2.reference_segment, precision="float32")
    assert _run(g14_cell, tmp_path, segment_factory=hook)["correct"]


@pytest.mark.parametrize("fault", faults.SERVE_FAULTS)
def test_fault_fails(g14_cell, tmp_path, fault):
    res = _run(g14_cell, tmp_path, seconds=0.6, segment_factory=serve_dinov2.fault_factory(fault))
    assert not res["correct"], (fault, res["checks"])


def test_calibration_plans_every_side():
    sides = [s for s, _, _ in calibrate_dinov2.plans([1, 2], [3], [4])]
    assert sides == ["program", "program", "control_fp8"] + [f"fault_{f}"
                                                             for f in faults.SERVE_FAULTS]


def test_weights_hold_every_key_of_the_port(g14_cell):
    from vit_ocm_wmsegmentation_tpu_torch.models import vit

    state = serve_dinov2.make_state(g14_cell.config, SEED, CPU)
    model = vit.ViT(serve_dinov2.vit_config(vit, g14_cell.config))
    assert set(state) == set(model.state_dict())
    gammas = torch.cat([v for k, v in state.items() if k.endswith(".gamma")])
    assert 0.1 <= float(gammas.min()) and float(gammas.max()) <= 1.0


def test_the_real_cells_counts():
    """The real cell's shapes: 1301 tokens a tile, about 3.3
    TFLOP a tile, the FFN 58 % of a block's FLOPs."""
    cell = spec.load_cell("g14reg_fused_1512")
    c, t = cell.config, cell.traffic
    n = roofline_dinov2.tokens(c, t["window"])
    assert n == 36 * 36 + 1 + 4
    assert 3.2e12 < roofline_dinov2.tile_flops(c, t["window"]) < 3.5e12
    assert roofline.tiles_per_mosaic(t["size"], t["window"], t["stride"]) == 49
    ffn = 6 * n * c["embed_dim"] * c["ffn_hidden"]
    assert 0.57 < ffn / roofline_dinov2.block_flops(c, n) < 0.59


def test_every_real_cell_loads_with_its_kinds_limits():
    with open(spec.ROOT + "/BENCHMARK.json") as f:
        doc = json.load(f)
    assert len(doc["workloads"]) == 6
    for w in doc["workloads"]:
        cell = spec.load_cell(w["name"])
        kind = cell.traffic["kind"]
        assert callable(spec.runner(kind))
        judged = ({"loss_rel", "grad1_leaf", "delta3_leaf"} if kind == "train"
                  else {"canvas_rel", "tile_rel", "mask_own_px"})
        assert set(cell.limits["limits"]) >= judged
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("name, pattern", [
    ("vitocm::swiglu_gate_kernel<__nv_bfloat16>", roofline_dinov2.GATE),
    ("vitocm::layerscale_norm_kernel<__nv_bfloat16, 6>", roofline_dinov2.LSNORM)])
def test_the_new_kernels_are_read_by_their_own_metrics_alone(name, pattern):
    """The DINOv2 kernels' names match their own readers' patterns and
    neither of the older cells' attention and MLP patterns."""
    assert re.search(pattern, name)
    assert not re.search(readers.ATTENTION, name) and not re.search(readers.MLP, name)

"""The strips control (calibrate_strips.py) on a tiny streamed cell on the
CPU: its canvas holds the reference's rows on exactly the strips the judge
reads, so through run.run_cell it reads what the whole control reads, and
comes out not correct."""

from __future__ import annotations

import dataclasses
import functools

import pytest
import torch

from benchmark import calibrate_strips, run
from benchmark.runners import serve

CPU = torch.device("cpu")
SEED = 2**31 + 424244


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def streamed_cell(cell_of):
    """The tiny streamed cell at 256^2: 7 tile rows, so that the judge's two
    strips of 2 tile rows leave rows out and a wrong draw reads zeros."""
    cell = cell_of("tiny_streamed_cell")
    return dataclasses.replace(cell, traffic={**cell.traffic, "size": 256})


def _checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def _whole_control(cell, tmpdir):
    hook = functools.partial(serve.reference_segment, precision="tf32")
    return run.run_cell(cell, SEED, 0.2, 0, CPU, str(tmpdir), segment_factory=hook,
                        judge_within=1)


def test_the_strips_at_full_precision_are_the_references_rows(streamed_cell, tmp_path):
    """At float32 the control's strips are the judge's reference rows bit
    for bit: every compared gap reads 0, and the run is correct."""
    res, _ = calibrate_strips.control_run(streamed_cell, SEED, 0.2, CPU, str(tmp_path),
                                          precision="float32")
    assert res["correct"], res["checks"]
    assert _checks(res) == {"canvas_rel": 0.0, "tile_rel": 0.0, "mask_own_px": 0.0,
                            "unjudged": 0}


def test_the_strips_control_reads_the_whole_controls_numbers(streamed_cell, tmp_path):
    """One precision down (tf32) the strips control fails, with the canvas
    and tile gaps of the whole control in the program's place."""
    strips, _ = calibrate_strips.control_run(streamed_cell, SEED, 0.2, CPU, str(tmp_path / "s"),
                                             precision="tf32")
    whole, _ = _whole_control(streamed_cell, tmp_path / "w")
    assert not strips["correct"], strips["checks"]
    got, want = _checks(strips), _checks(whole)
    assert got["canvas_rel"] == want["canvas_rel"] > 0
    assert got["tile_rel"] == want["tile_rel"] > 0
    assert got["mask_own_px"] == 0.0


def test_a_fused_cell_is_refused(cell_of, tmp_path):
    with pytest.raises(SystemExit, match="streamed"):
        calibrate_strips.control_run(cell_of("tiny_fused_cell"), SEED, 0.2, CPU, str(tmp_path))

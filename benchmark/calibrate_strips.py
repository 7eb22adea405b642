"""The control's readings of a streamed serving cell, on the strips its
judge reads: ``calibrate.py``'s control for mosaics too large to serve
whole in the reference.

    python3 benchmark/calibrate_strips.py --workload <name> --control_seeds <n ...> \\
        [--out file]

The control is the plain reference in the program's place, one precision
below the configuration's (calibrate.py's ``CONTROL``). Served whole, a
32768^2 mosaic takes the reference over half an hour of the chip. The judge
of a streamed cell (``runners/serve.judge``) reads only ``strips`` strips of
``strip_rows`` tile rows of each kept mosaic, drawn from the seed. So this
control's canvas holds the reference's rows (``reference/vit.canvas_rows``,
the whole canvas's rows bit for bit) on every strip the judge draws for the
seed, and zeros elsewhere; its mask is the threshold of that canvas. Each
run goes through ``run.run_cell`` and the judge as calibrate.py's do, so its
``canvas_rel`` and ``tile_rel`` are a whole control's, and ``mask_own_px``
reads 0 as any control's. The sample is drawn from the first window mosaic
alone (``judge_within`` 1), so a window of one mosaic judges it. Every run
prints, and appends to ``--out``, one JSON line; the benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run, spec  # noqa: E402
from benchmark.calibrate import CONTROL  # noqa: E402
from benchmark.reference import vit as ref  # noqa: E402


def judged_strips(cell, seed, n_kept, n_rows):
    """[(first, last)] tile rows of every strip the judge draws for ``seed``
    over ``n_kept`` kept mosaics of ``n_rows`` tile rows (serve.judge's
    draws, in its order)."""
    lim = cell.limits
    rng = np.random.default_rng((seed, 2))
    out = []
    for _ in range(n_kept * lim["strips"]):
        first = int(rng.integers(0, n_rows - lim["strip_rows"] + 1))
        out.append((first, first + lim["strip_rows"] - 1))
    return out


def strips_segment(cell, state, device, seed, n_kept, precision):
    """A ``segment_factory`` (serve.run's hook): the reference in
    ``precision`` on the rows of every strip the judge draws for ``seed``,
    zeros elsewhere, and the threshold of that canvas."""
    t = cell.traffic
    if t["route"] != "streamed":
        raise SystemExit(f"{cell.name}: the strips control takes a streamed cell; "
                         f"calibrate.py serves the control of a {t['route']} one whole")

    def segment(img):
        n_rows = len(ref.tile_starts(img.shape[0], t["window"], t["stride"]))
        attn = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
        for first, last in judged_strips(cell, seed, n_kept, n_rows):
            (y0, y1), rows = ref.canvas_rows(state, cell.config, img, t["window"], t["stride"],
                                             first, last, precision)
            attn[y0:y1] = rows
        return ref.threshold_multiplicative(img, attn), attn

    return segment, None


def control_run(cell, seed, seconds, device, tmpdir, precision=None):
    """One run of the strips control through run.run_cell, the sample drawn
    from the first window mosaic: (result, checks)."""
    if cell.traffic["kind"] != "serve":
        raise SystemExit(f"{cell.name}: traffic kind {cell.traffic['kind']!r} is not serve")
    precision = precision or CONTROL[cell.precision]
    n_kept = min(cell.limits["sample"], 1)

    def factory(c, state, dev):
        return strips_segment(c, state, dev, seed, n_kept, precision)

    return run.run_cell(cell, seed, seconds, 0, device, tmpdir, segment_factory=factory,
                        judge_within=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control_seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_strips: no CUDA device")
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    side = f"control_{CONTROL[cell.precision]}_strips"
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.control_seeds:
            tmp = tempfile.mkdtemp(prefix="calib_")
            t = time.perf_counter()
            try:
                result, _ = control_run(cell, seed, 1.0, device, tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            line = {"workload": cell.name, "side": side, "seed": seed,
                    "correct": result["correct"], "attempted": result["attempted"],
                    "numbers": {k: v["value"] for k, v in result["checks"].items()},
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()

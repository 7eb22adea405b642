"""Readings that a DINOv2 serving cell's correctness limits are set from, on
the chip: ``calibrate.py`` for the ``serve_dinov2`` traffic kind.

    python3 benchmark/calibrate_dinov2.py --workload <name> --seeds <n ...> \\
        [--control_seeds <n ...>] [--fault_seeds <n ...>] [--seconds S] [--out file]

For each of ``--seeds`` one short run of the program, for each of
``--control_seeds`` one of the control (the plain reference in float8
operands in the program's place), and for each of ``--fault_seeds`` one run
with each planted serving fault (``runners/serve_dinov2.fault_factory``).
Every run prints, and appends to ``--out``, one JSON line with the compared
numbers; all runs share one process. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import faults, run, spec  # noqa: E402
from benchmark.runners import serve_dinov2  # noqa: E402


def plans(seeds, control_seeds, fault_seeds):
    """[(side, seed, hooks)] of the runs, in order."""
    out = [("program", s, {}) for s in seeds]
    out += [("control_fp8", s, {"segment_factory": functools.partial(
        serve_dinov2.reference_segment, precision="fp8")}) for s in control_seeds]
    out += [(f"fault_{f}", s, {"segment_factory": serve_dinov2.fault_factory(f)})
            for s in fault_seeds for f in faults.SERVE_FAULTS]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--judge_within", type=int, default=None,
                    help="draw the sample from this many window mosaics")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate_dinov2: no CUDA device")
    cell = spec.load_cell(args.workload)
    if cell.traffic["kind"] != "serve_dinov2":
        raise SystemExit(f"{args.workload}: traffic kind {cell.traffic['kind']!r}; "
                         f"calibrate.py takes it")
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for side, seed, hooks in plans(args.seeds, args.control_seeds, args.fault_seeds):
            if args.judge_within:
                hooks = dict(hooks, judge_within=args.judge_within)
            tmp = tempfile.mkdtemp(prefix="calib_")
            t = time.perf_counter()
            try:
                result, _ = run.run_cell(cell, seed, args.seconds, 0, device, tmp, **hooks)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            line = {"workload": cell.name, "side": side, "seed": seed,
                    "correct": result["correct"], "attempted": result["attempted"],
                    "numbers": {k: v["value"] for k, v in result["checks"].items()},
                    "metrics": {k: v["value"] for k, v in result["metrics"].items()},
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

"""Readings that the correctness limits are set from, on the chip.

    python3 benchmark/calibrate.py --workload <name> --seeds <n ...> \\
        [--control_seeds <n ...>] [--fault_seeds <n ...>] [--seconds S] [--out file]

For each of ``--seeds`` one short run of the program, and for each of
``--control_seeds`` one of the control: the plain reference in the
program's place one precision below the configuration's (TF32 for float32,
float8 operands for bfloat16). For each of ``--fault_seeds`` one run with
each planted fault (faults.py). Every run prints, and appends to ``--out``,
one JSON line with the compared numbers; all runs share one process, so the
kernels load once. The benchmark's own runs never run this.
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
from benchmark.runners import serve, train  # noqa: E402

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--judge_within", type=int, default=None,
                    help="serving: draw the sample from this many window mosaics")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    serving = cell.traffic["kind"] == "serve"
    precision = CONTROL[cell.precision]
    plans = [("program", s, {}) for s in args.seeds]
    if serving:
        plans += [(f"control_{precision}", s,
                   {"segment_factory": functools.partial(serve.reference_segment,
                                                         precision=precision)})
                  for s in args.control_seeds]
        plans += [(f"fault_{f}", s, {"segment_factory": faults.serve_factory(f)})
                  for s in args.fault_seeds for f in faults.SERVE_FAULTS]
    else:
        plans += [(f"control_{precision}", s,
                   {"trainer_factory": functools.partial(train.ReferenceTrainer,
                                                         precision=precision)})
                  for s in args.control_seeds]
        plans += [(f"fault_{f}", s, {"trainer_factory": faults.train_factory(f)})
                  for s in args.fault_seeds for f in faults.TRAIN_FAULTS]
    out = open(args.out, "a") if args.out else None
    try:
        for side, seed, hooks in plans:
            if serving and args.judge_within:
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

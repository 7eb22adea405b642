"""Run one cell of the port's benchmark on the machine it is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
    python3 -m benchmark.run ...   (the same, from the checkout's root)

The cell is an entry of ``BENCHMARK.json`` at the root of the checkout; its
configuration, traffic mix, limits and per-layer metrics are files under
this folder found by name (``spec.py``). The traffic's ``kind`` names the
runner, ``runners/<kind>.py`` (``serve``, ``train``). With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read by ``metrics/<name>.py`` from a
profiler trace of a part of the window, and the trace's breakdown.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), and last ``checks``, each compared number with its limit; the
same numbers end standard error. The run exits non-zero and prints no result
without a CUDA device (or fewer than the cell asks for), when the program
is missing, and when JAX, jaxlib, flax or the JAX package is loaded once the
window has closed. Kernel and compiler caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import spec  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "vit_ocm_wmsegmentation_tpu")
CACHE_DIR = os.path.join(spec.ROOT, "_bench_cache")


def banned_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    BANNED, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in BANNED})


def cache_env():
    """Point the compiler caches into the checkout, at fixed paths (the
    port builds its CUDA library into its own ``_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ.setdefault(var, os.path.join(CACHE_DIR, sub))
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ.setdefault("USE_FLAX", "0")


def check_list(cell, numbers: dict, unjudged: int):
    """[(name, value, limit)] of the compared numbers; a number passes at
    or under its limit."""
    out = [(k, v, cell.limits["limits"][k]) for k, v in sorted(numbers.items())]
    out.append(("unjudged", unjudged, 0))
    return out


def is_correct(checks) -> bool:
    return all(v == v and v <= lim for _, v, lim in checks)


def per_layer(cell, view):
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"], cell.bench_dir)(view, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(cell, measured: dict):
    """The cell's end-to-end metrics from the runner's quantities: the
    quantity ``q`` under each of the cell's metrics named ``q`` or
    ``q.<variant>`` (one quantity under a name a group of cells, where the
    groups' runs spread differently and so take bounds of their own)."""
    out = {}
    for m in cell.end_to_end:
        q = m["name"].split(".")[0]
        if q in measured:
            out[m["name"]] = {"value": measured[q], "unit": m["unit"]}
    return out


def run_cell(cell, seed, seconds, trace, device, tmpdir, t_start=None, **hooks):
    """One run of ``cell`` on ``device``: the result dict, and the checks.
    ``t_start`` (host clock) is where set-up began."""
    import torch

    runner = spec.runner(cell.traffic["kind"], cell.bench_dir)
    rec = runner(cell, seed, seconds, trace, device, tmpdir, **hooks)
    setup_s = rec["t0"] - t_start if t_start is not None else None
    checks = check_list(cell, rec["numbers"], rec["unjudged"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": is_correct(checks) and rec["failed"] == 0,
              "attempted": rec["attempted"], "failed": rec["failed"]}
    if trace:
        view = rec["view"]
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
        result["metrics"] = per_layer(cell, view)
        result["breakdown"] = view.breakdown()
    else:
        metrics = dict(rec["metrics"])
        if setup_s is not None:
            metrics["setup_s"] = setup_s
        result["metrics"] = end_to_end(cell, metrics)
    result["device"] = dev
    if t_start is not None:
        first = rec["t0"] - t_start - sum(s for _, s in rec["phases"])
        result["setup_phases"] = [["start_and_imports", first]] + [list(p) for p in rec["phases"]]
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), {n} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tmpdir = tempfile.mkdtemp(prefix="bench_")
    try:
        result, checks = run_cell(cell, args.seed, args.seconds, args.trace, device, tmpdir,
                                  t_start=T_START)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    found = banned_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, seconds in result.get("setup_phases", []):
        print(f"setup {name} {seconds:.3f} s", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

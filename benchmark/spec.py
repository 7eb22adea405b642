"""The benchmark's definition, read from files by name.

``BENCHMARK.json`` at the root of the checkout names the cells; each cell's
configuration, traffic mix, limits and per-layer metrics live in files of
their own under the benchmark's folder, found by name:

* ``configs/<config>.json``: the model's sizes as run (the configuration's
  ``file`` in BENCHMARK.json), with its precision, routes and weights;
* ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  general runner that its ``kind`` names;
* ``runners/<kind>.py``: a runner, ``run(cell, seed, seconds, trace, device,
  tmpdir, **hooks)`` returning the run's record (see run.py); a runner of a
  cell on more than one chip starts and joins its own processes;
* ``workloads/<workload>.json``: the cell's correctness limits;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(view, cell)``
  returning a number, or None where the trace holds nothing to read.

A later cell, configuration or metric is a new file and an entry in
BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: str

    @property
    def precision(self) -> str:
        return self.traffic.get("precision", self.config.get("precision"))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str, end_to_end_names) -> bool:
    """Whether a metric belongs to a cell: listed there, or, without a
    ``workloads`` key, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in end_to_end_names


def load_cell(workload: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json with its files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "workloads", workload + ".json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer, bench_dir)


def _load_file(path: str, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = HERE):
    """The ``read`` function of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    return _load_file(path, f"benchmark_metric_{name.replace('.', '_')}").read


def runner(kind: str, bench_dir: str = HERE):
    """The ``run`` function of runners/<kind>.py: the benchmark folder's own,
    or else the package's (``kind`` is a module name)."""
    if not kind.isidentifier():
        raise SystemExit(f"traffic kind {kind!r} is not a module name")
    path = os.path.join(bench_dir, "runners", kind + ".py")
    if os.path.abspath(bench_dir) == HERE or not os.path.exists(path):
        return importlib.import_module(f"benchmark.runners.{kind}").run
    # relative imports inside the file resolve against benchmark.runners
    return _load_file(path, f"benchmark.runners.{kind}").run

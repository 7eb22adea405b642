"""Spans, the profiler's trace of the device, and what the metrics read in it.

The benchmark's own files record spans around their calls into the program
(``upload``, ``segment``, ``to_host``, ``wait``, ``loader``, ``step``), as
``torch.profiler.record_function`` ranges, only in a traced run. A traced
run profiles the CPU and the card over a part of the window (the
``traced_window`` span), exports the Chrome trace into the run's temporary
directory, reads it back and deletes it. :class:`TraceView` holds what the
per-layer metrics read:

* the device's operations (kernels, copies, sets) clipped to the window;
  busy time is the length of their union, so operations that overlap on two
  streams count once;
* each kernel's launching span: the innermost span of the benchmark on the
  launching thread when the launch call ran, matched through the CUDA
  correlation id;
* the units of work the window completed (mosaics, megapixels, steps).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "traced_window"


class Phases:
    """Host-clock seconds of the set-up's phases: ``mark(name)`` ends the
    phase ``name`` begun at the previous mark."""

    def __init__(self):
        self.t = time.perf_counter()
        self.done = []

    def mark(self, name: str):
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now


class Spans:
    """``spans(name)``: a named range in a traced run, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()


def union(intervals):
    """Merged (start, end) intervals of an iterable of them, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:120]


class TraceView:
    """The device operations of a Chrome trace inside its traced window."""

    def __init__(self, trace: dict, units: dict):
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
        spans = [e for e in events if e.get("cat") == "user_annotation"]
        win = [e for e in spans if e.get("name") == WINDOW]
        if not win:
            raise ValueError(f"the trace has no {WINDOW!r} span")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = w.get("tid")
        self.units = dict(units)
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
        # spans by thread, sorted by start, for the innermost-span lookup
        self._spans = {}
        for e in spans:
            if e.get("name") == WINDOW:
                continue
            s = float(e["ts"])
            self._spans.setdefault(e.get("tid"), []).append((s, s + float(e["dur"]), e["name"]))
        for v in self._spans.values():
            v.sort()
        self.ops = []  # (name, start, end, launching span or None), us, clipped
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            s, t = max(s, self.t0), min(t, self.t1)
            if t <= s:
                continue
            launch = launches.get(e.get("args", {}).get("correlation"))
            span = self.span_at(launch[1], launch[0]) if launch else None
            self.ops.append((e.get("name", ""), s, t, span))
        self.busy = union((s, t) for _, s, t, _ in self.ops)

    def span_at(self, tid, ts):
        """Name of the innermost span on thread ``tid`` that holds ``ts``."""
        spans = self._spans.get(tid, [])
        i = bisect.bisect_right(spans, (ts, float("inf"), ""))
        best = None
        for s, e, name in spans[max(0, i - 64) : i]:
            if s <= ts <= e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return length(self.busy) / 1e6

    def device_s(self, pattern=None, span=None) -> float:
        """Seconds of the union of the device operations whose name matches
        ``pattern`` (a regular expression) and that were launched under the
        innermost span ``span``; either filter optional."""
        rx = re.compile(pattern) if pattern else None
        sel = [(s, t) for name, s, t, sp in self.ops
               if (rx is None or rx.search(name)) and (span is None or sp == span)]
        return length(union(sel)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, summed by name, and
        the longest idle gaps, each named by the innermost span the main
        thread was in when it began."""
        by_name = {}
        for name, s, t, _ in self.ops:
            k = short_name(name)
            by_name[k] = by_name.get(k, 0.0) + (t - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.t0
        for s, e in self.busy + [[self.t1, self.t1]]:
            if s > prev:
                gaps.append((s - prev, prev))
            prev = max(prev, e)
        gaps.sort(reverse=True)
        named = [[self.span_at(self.main_tid, start) or "outside_spans", g / 1e6]
                 for g, start in gaps[:top]]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


class Capture:
    """``with Capture(tmpdir) as cap: ...`` profiles the CPU and the card
    over the block inside a ``traced_window`` span; :meth:`view` parses the
    exported trace (and deletes the file)."""

    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._win = torch.profiler.record_function(WINDOW)
        self._win.__enter__()
        return self

    def __exit__(self, *exc):
        self._win.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def view(self, units: dict) -> TraceView:
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmpdir)
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        return TraceView(trace, units)

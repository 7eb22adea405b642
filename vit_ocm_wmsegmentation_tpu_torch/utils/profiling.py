"""The port's spans and traces.

Counterpart of ``vit_ocm_wmsegmentation_tpu/utils/profiling.py``:

* :func:`annotate`: the port's one span primitive. While a profiler runs it
  is a ``torch.profiler.record_function`` range, so the span lands in that
  profiler's own trace, on the clock of the device's kernels and copies;
  otherwise it is one shared null context, so that a span costs a flag test
  and nothing is built or dispatched;
* :func:`trace`: a ``torch.profiler`` capture of CPU and CUDA activity,
  exported as a Chrome trace into a directory;
* the measurements on the card that ``chip_smoke.py``, the ``tools/``
  probes and the ``profile_*`` CLIs share: :func:`cuda_ms` and
  :func:`queued_ms` (CUDA events), :func:`card_line` (nvidia-smi), and a
  reader of a finished profiler run (:func:`device_ops`,
  :func:`span_device_ms`, :func:`union_ms`, :func:`kernel_table`).

The spans are named ``<module>.<stage>``: ``pipeline.segment_mosaic`` and
``pipeline.segment_mosaic_streamed`` around a mosaic, with the leaves
``pipeline.tiles``, ``pipeline.tile_maps``, ``pipeline.stitch`` and
``pipeline.threshold`` (the streamed path's ``pipeline.band`` a tile row),
``vit.cls_attention_grid`` (and inside it, for the DINOv2 block kind,
``vit.tokens`` and one ``vit.ffn`` a block); ``mim.step`` around a training step, with
``mim.forward``, ``mim.backward`` and ``mim.optimizer`` (a CUDA graph's replayed step:
``mim.inputs`` and ``mim.replay``, its capturing step the three inside ``mim.capture``
between them); ``data.device_aug``
around each batch of the device-augmentation loader. A top span holds only
host code of its own; every op that launches work runs under a leaf.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import statistics
import subprocess
import tempfile

import torch
from torch.autograd import DeviceType

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """``with annotate(name): ...``: a named span in the running profiler's
    trace, or the shared null context when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): step()`` writes ``dir/trace.json`` (Chrome trace
    format); CUDA activity is recorded when a CUDA device is present, and
    the device is synchronized before the capture stops, so that the work
    the block issued is in the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Chrome-trace categories of the device's operations and of their launches
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def cuda_ms(fn, iters=10, warmup=2):
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, n=20):
    """Device time a call in ms with n calls queued back to back (CUDA
    events around the n): the host's set-up of each call overlaps the
    device's work, where cuda_ms waits for it before every call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi reads them: the
    line printed beside every measurement on the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def innermost_span(spans, ts):
    """Name of the innermost of ``spans`` ((start, end, name), sorted, on
    one thread; nested or disjoint) that holds ``ts``, or None."""
    for start, end, name in reversed(spans[: bisect.bisect_right(spans, (ts, float("inf"), ""))]):
        if end >= ts:
            return name
    return None


def device_ops(trace: dict):
    """[(name, start us, end us, span)] of every device operation (kernel,
    copy, set) of a Chrome trace (``export_chrome_trace``'s JSON), in order
    of start; ``span`` is the innermost ``record_function`` span on the
    launching thread when the launch ran (matched through the correlation
    id)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans, launches = {}, {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ts = float(e["ts"])
            spans.setdefault(e.get("tid"), []).append((ts, ts + float(e["dur"]), e["name"]))
        elif e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    for v in spans.values():
        v.sort()
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            ts = float(e["ts"])
            launch = launches.get(e.get("args", {}).get("correlation"))
            span = innermost_span(spans.get(launch[0], []), launch[1]) if launch else None
            out.append((e.get("name", ""), ts, ts + float(e.get("dur", 0.0)), span))
    return sorted(out, key=lambda op: op[1])


def chrome_trace(prof) -> dict:
    """The Chrome trace of a finished torch.profiler run, as JSON."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def union_ms(intervals):
    """Milliseconds of the union of (start us, end us) intervals: two that
    overlap (operations on two streams) count once."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def span_device_ms(ops):
    """{span: device ms of the union of the operations launched under it}
    of :func:`device_ops`' list, the spans in order of their first operation."""
    by_span = {}
    for _, start, end, span in ops:
        by_span.setdefault(span or "outside_spans", []).append((start, end))
    return {span: union_ms(iv) for span, iv in by_span.items()}


def kernel_table(prof, wall, top=16):
    """Print the device time of each kernel in a torch.profiler run of
    ``wall`` ms, its idle share (1 - the union of the device operations'
    intervals / wall) and the ``top`` kernels. Returns :func:`device_ops`'
    list."""
    # kernels only: CPU ranges (aten ops, autograd Functions) and their GPU
    # annotations (the optimizer step) carry their kernels' time too
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   and e.self_device_time_total > 0),
                  reverse=True)
    ops = device_ops(chrome_trace(prof))
    busy = union_ms((start, end) for _, start, end, _ in ops)
    ours = sum(r[0] for r in rows if "vitocm::" in r[2])
    print(f"  wall {wall:.3f} ms under the profiler, device busy {busy:.3f} ms "
          f"({ours:.3f} ms in the port's kernels), idle share {1 - busy / wall:.4f}, "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in rows[:top]:
        print(f"    {ms:9.3f} ms x{count:4d}  {key[:100]}")
    return ops

"""Tracing and step timing.

Counterpart of ``vit_ocm_wmsegmentation_tpu/utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` capture of CPU and CUDA activity,
  exported as a Chrome trace into a directory;
* :func:`annotate`: a named span (``torch.profiler.record_function``);
* :class:`StepTimer`: steps/s and items/s, synchronizing the device's
  current stream before it reads the clock;
* :func:`device_memory_stats`: the CUDA caching allocator's bytes in use
  and peak.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): step()`` writes ``dir/trace.json`` (Chrome trace
    format); CUDA activity is recorded when a CUDA device is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span in the trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Throughput meter that waits for the device before each timestamp."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def reset(self):
        self._t0 = None
        self.steps = 0
        self.items = 0.0
        self.elapsed = 0.0

    def _sync(self):
        dev = self.device
        if dev is not None and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def step(self, items: float = 0.0):
        """Call once a step, after queueing its work."""
        self._sync()
        now = time.perf_counter()
        if self._t0 is not None:
            self.elapsed += now - self._t0
            self.steps += 1
            self.items += items
        self._t0 = now

    @property
    def steps_per_sec(self):
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def items_per_sec(self):
        return self.items / self.elapsed if self.elapsed else 0.0


def device_memory_stats(device=None):
    """{'bytes_in_use': ..., 'peak_bytes_in_use': ...} of a CUDA device, or
    {} for another device or when there is none."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}

"""Metric meters with cross-process reduction.

Counterpart of ``vit_ocm_wmsegmentation_tpu/utils/meters.py`` (the vendored
DINO MetricLogger / SmoothedValue, dino/utils.py:194-370): windowed
smoothing, global averages, and the sum of counts and totals over the
processes of an initialized ``torch.distributed`` group.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque

import numpy as np
import torch


def _all_reduce_sum(values: np.ndarray) -> np.ndarray:
    """Sum a small float64 vector over the processes of the default group;
    the identity when no group is initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return values
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.as_tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return t.cpu().numpy()


class SmoothedValue:
    """A scalar series: a window of recent values and the global average."""

    def __init__(self, window_size=20, fmt="{median:.6f} ({global_avg:.6f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """Sum count and total over the processes (the window stays local)."""
        t = _all_reduce_sum(np.array([self.count, self.total], np.float64))
        self.count, self.total = int(t[0]), float(t[1])

    @property
    def median(self):
        return float(np.median(list(self.deque))) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(list(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    """Named SmoothedValues and a log_every iterator printing ETA lines."""

    def __init__(self, delimiter="\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq, header=""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.6f}")
        data_time = SmoothedValue(fmt="{avg:.6f}")
        n = len(iterable)
        space_fmt = f":{len(str(n))}d"
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == n - 1:
                eta = datetime.timedelta(seconds=int(iter_time.global_avg * (n - i)))
                print(self.delimiter.join(
                    [header, ("[{0" + space_fmt + "}/{1}]").format(i, n), f"eta: {eta}",
                     str(self), f"time: {iter_time}", f"data: {data_time}"]))
            i += 1
            end = time.time()
        total = datetime.timedelta(seconds=int(time.time() - start_time))
        print(f"{header} Total time: {total} ({(time.time() - start_time) / max(n, 1):.6f} s / it)")

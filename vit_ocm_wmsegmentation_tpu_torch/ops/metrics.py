"""Host-side meters of the training loops (the JAX package's
``ops/metrics.py::AverageMeter``, a timm.utils.AverageMeter equivalent)."""

from __future__ import annotations


class AverageMeter:
    """Running value, sum, count and average of a host scalar."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0

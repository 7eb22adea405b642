"""device_idle of the fused 1152^2 cell: benchmark.readers.device_idle."""

from benchmark.readers import device_idle as read  # noqa: F401

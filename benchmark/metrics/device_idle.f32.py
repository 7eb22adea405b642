"""device_idle of the float32 SimMIM cell: benchmark.readers.device_idle."""

from benchmark.readers import device_idle as read  # noqa: F401

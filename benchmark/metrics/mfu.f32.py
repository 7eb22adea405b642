"""mfu of the float32 SimMIM cell: benchmark.readers.train_mfu."""

from benchmark.readers import train_mfu as read  # noqa: F401

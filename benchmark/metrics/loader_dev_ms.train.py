"""loader_dev_ms of the AMP SimMIM cell: benchmark.readers.loader_dev_ms."""

from benchmark.readers import loader_dev_ms as read  # noqa: F401

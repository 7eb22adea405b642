"""aug_dev_ms of the AMP SimMIM cell: benchmark.program_spans.aug_dev_ms."""

from benchmark.program_spans import aug_dev_ms as read  # noqa: F401

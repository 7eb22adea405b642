"""pipeline_dev_ms_per_mp of the streamed 8192^2 cell: benchmark.program_spans.pipeline_dev_ms_per_mp."""

from benchmark.program_spans import pipeline_dev_ms_per_mp as read  # noqa: F401

"""issue_ms_per_mp of the streamed 8192^2 cell: benchmark.program_spans.issue_ms_per_mp."""

from benchmark.program_spans import issue_ms_per_mp as read  # noqa: F401

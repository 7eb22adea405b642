"""issue_ms_per_step of the AMP SimMIM cell: benchmark.program_spans.issue_ms_per_step."""

from benchmark.program_spans import issue_ms_per_step as read  # noqa: F401

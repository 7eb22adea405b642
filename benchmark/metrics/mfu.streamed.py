"""mfu of the streamed 8192^2 cell: benchmark.readers.serve_mfu."""

from benchmark.readers import serve_mfu as read  # noqa: F401

"""mlp_roofline of the streamed 8192^2 cell: benchmark.readers.serve_mlp_roofline."""

from benchmark.readers import serve_mlp_roofline as read  # noqa: F401

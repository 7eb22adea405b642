"""attn_roofline of the streamed 8192^2 cell: benchmark.readers.serve_attn_roofline."""

from benchmark.readers import serve_attn_roofline as read  # noqa: F401

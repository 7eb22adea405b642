"""mlp_roofline of the fused 1152^2 cell: benchmark.readers.serve_mlp_roofline."""

from benchmark.readers import serve_mlp_roofline as read  # noqa: F401

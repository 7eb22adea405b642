"""post_dev_ms_per_mp of the fused 1152^2 cell: benchmark.readers.post_dev_ms_per_mp."""

from benchmark.readers import post_dev_ms_per_mp as read  # noqa: F401

"""pipeline_dev_ms_per_mp of the DINOv2 ViT-g/14 fused 1512^2 cell: benchmark.program_spans.pipeline_dev_ms_per_mp."""

from benchmark.program_spans import pipeline_dev_ms_per_mp as read  # noqa: F401

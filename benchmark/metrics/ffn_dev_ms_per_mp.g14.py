"""ffn_dev_ms_per_mp of the DINOv2 ViT-g/14 fused 1512^2 cell: benchmark.roofline_dinov2.ffn_dev_ms_per_mp."""

from benchmark.roofline_dinov2 import ffn_dev_ms_per_mp as read  # noqa: F401

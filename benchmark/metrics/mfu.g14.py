"""mfu of the DINOv2 ViT-g/14 fused 1512^2 cell: benchmark.roofline_dinov2.mfu."""

from benchmark.roofline_dinov2 import mfu as read  # noqa: F401

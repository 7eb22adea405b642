"""gate_roofline of the DINOv2 ViT-g/14 fused 1512^2 cell: benchmark.roofline_dinov2.gate_roofline."""

from benchmark.roofline_dinov2 import gate_roofline as read  # noqa: F401

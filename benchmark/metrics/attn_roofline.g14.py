"""attn_roofline of the DINOv2 ViT-g/14 fused 1512^2 cell: benchmark.roofline_dinov2.attn_roofline."""

from benchmark.roofline_dinov2 import attn_roofline as read  # noqa: F401

"""device_idle of the DINOv2 ViT-g/14 fused 1512^2 cell: benchmark.readers.device_idle."""

from benchmark.readers import device_idle as read  # noqa: F401

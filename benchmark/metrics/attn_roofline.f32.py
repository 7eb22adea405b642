"""attn_roofline of the float32 SimMIM cell: benchmark.readers.train_attn_roofline."""

from benchmark.readers import train_attn_roofline as read  # noqa: F401

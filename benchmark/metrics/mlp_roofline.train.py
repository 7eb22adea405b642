"""mlp_roofline of the AMP SimMIM cell: benchmark.readers.train_mlp_roofline."""

from benchmark.readers import train_mlp_roofline as read  # noqa: F401

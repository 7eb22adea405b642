"""The benchmark's plain reference: float32 PyTorch, TF32 off, written from
the published models and the paper's scripts. It imports nothing of the
program (``vit_ocm_wmsegmentation_tpu_torch``), nor JAX or the JAX package,
and takes nothing the program made: the benchmark hands both sides the same
weights and inputs, made from the seed."""

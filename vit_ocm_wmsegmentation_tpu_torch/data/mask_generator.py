"""SimMIM random mask generation (rebuild of data.py:163-186); the port's
copy of ``vit_ocm_wmsegmentation_tpu/data/mask_generator.py``."""

from __future__ import annotations

import math

import numpy as np


class MaskGenerator:
    """Random patch-mask over the token grid.

    input_size / mask_patch_size defines the coarse random grid; each coarse
    cell expands to (mask_patch_size / model_patch_size)^2 token cells. The
    number of masked coarse cells is ceil(token_count * mask_ratio), chosen
    by permutation — exactly the reference's scheme.
    """

    def __init__(self, input_size=192, mask_patch_size=32, model_patch_size=4, mask_ratio=0.6):
        assert input_size % mask_patch_size == 0
        assert mask_patch_size % model_patch_size == 0
        self.input_size = input_size
        self.mask_patch_size = mask_patch_size
        self.model_patch_size = model_patch_size
        self.mask_ratio = mask_ratio
        self.rand_size = input_size // mask_patch_size
        self.scale = mask_patch_size // model_patch_size
        self.token_count = self.rand_size**2
        self.mask_count = int(math.ceil(self.token_count * mask_ratio))

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        """(input_size/model_patch_size)^2 int mask grid."""
        mask_idx = rng.permutation(self.token_count)[: self.mask_count]
        mask = np.zeros(self.token_count, dtype=np.int32)
        mask[mask_idx] = 1
        mask = mask.reshape(self.rand_size, self.rand_size)
        return mask.repeat(self.scale, axis=0).repeat(self.scale, axis=1)

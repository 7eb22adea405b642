"""Seeding of the host RNGs and torch (the port's counterpart of
``vit_ocm_wmsegmentation_tpu/utils/seeding.py``, utils.py:21-27 of the
reference)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seeding(seed: int) -> torch.Generator:
    """Seed Python's ``random``, numpy's global RNG and torch's (every
    device); returns a CPU ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)

"""Shared fixture of the port's CPU tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each port test with one torch CPU thread. With several threads,
    torch's CPU exp loses accuracy at some work splits (up to ~1e-4 against
    float64 where one thread stays within 1e-7, seen on this suite's host
    under parallel load), which is noise the f32 parity tolerances here are
    not sized for. Restores the thread count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quant_rows(m, k, seed):
    """(m, k) float32 rows for the int8 row quantizer (numpy): N(0, 1) rows
    scaled 1e-3 to 1e3, an all-zero row 1, and rows 2 and 3 of exact round-
    half ties of x / s: max 127 (s = 1) beside 0.5, 1.5, 2.5, ... and max 254
    (s = 2) beside the odd integers, both signs; every value is exact in
    bfloat16."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)) * 10.0 ** rng.uniform(-3, 3, size=(m, 1))
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float().numpy()
    if m > 1:
        x[1] = 0
    for row, top in ((2, 127.0), (3, 254.0)):
        if m > row:
            half = (np.arange(k - 1) % 120 + 0.5) * (top / 127.0)
            x[row, 0], x[row, 1:] = top, np.where(np.arange(k - 1) % 2, -half, half)
    return x

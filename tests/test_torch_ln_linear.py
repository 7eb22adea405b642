"""The port's LN -> qkv forward against the JAX package's Pallas forward
(``ops/ln_linear.py::_fwd_impl`` in interpret mode, row block 64), at the
edges of the bfloat16 wgmma kernel's units: rows on both sides of its
128-row units (and of the f32 kernel's 64-row CTAs), output widths K on both
sides of its 192-column chunks (K a multiple of 64), and both kernel widths.

On CPU tensors ``ln_linear`` takes its plain twin, so this holds the twin's
arithmetic and rounding points against the TPU kernel's; the CUDA kernels
are held against the same twin on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances as in test_torch_train_kernels.py: 1e-4 in
float32, 2e-2 in bfloat16, relative to the largest reference value.
"""

import numpy as np
import pytest

from vit_ocm_wmsegmentation_tpu.ops import ln_linear as jln
from vit_ocm_wmsegmentation_tpu_torch.ops import ln_linear as tln

from port_helpers import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_kernels import TDT, _close, _pair

ROWS = (1, 127, 128, 129, 257)
CASES = ([(r, 1152, d) for d in (192, 384) for r in ROWS]
         + [(129, k, d) for d in (192, 384) for k in (64, 128, 192, 320)]
         + [(r, 192, d) for d in (192, 384) for r in (1, 128)])


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("r,k,d", CASES)
def test_ln_linear_matches_jax_forward(r, k, d, tag):
    rng = np.random.default_rng(r + k + d)
    f = lambda *s, std=1.0, mean=0.0: (rng.normal(size=s) * std + mean).astype(np.float32)  # noqa: E731
    (jx, tx), (js, ts), (jb, tb) = (_pair(a, tag) for a in (
        f(r, d, std=2.0, mean=0.5), f(d, std=0.1, mean=1.0), f(d, std=0.1)))
    (jw, tw), (jbias, tbias) = _pair(f(d, k, std=d ** -0.5), tag), _pair(f(k, std=0.1), tag)
    want = jln._fwd_impl(jx, js, jb, jw, jbias, 1e-6, 64, True)
    got = tln.ln_linear(tx, ts, tb, tw.T.contiguous(), tbias)
    assert got.dtype == TDT[tag] and tuple(got.shape) == (r, k)
    _close(got, want, tag, "y")
    assert tln.ln_linear.launches == 0  # CPU tensors take the twin

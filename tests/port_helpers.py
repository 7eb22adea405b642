"""Shared fixture and checks of the port's tests (tests/test_torch_*.py); no
JAX here, so that the card tests can use the checks too."""

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


def check_step_outputs_and_updates(device, k, calls=5):
    """The MIM step of ``make_train_step`` (ViT width 384, depth 1, 3 heads,
    2 images of 32^2; the kernels' widths on the card) over ``calls`` calls
    with ACCUMULATION_STEPS ``k`` on ``device``: every call returns loss and
    grad-norm tensors of its own, which still hold at the end the values read
    right after their call (a step that handed out a buffer the next call
    rewrites fails here); the optimizer's update count and the rate in its
    groups advance once every k calls, to the schedule's rate of that
    update, and the parameters move on those calls alone. Returns the step."""
    from vit_ocm_wmsegmentation_tpu_torch import pipeline
    from vit_ocm_wmsegmentation_tpu_torch.models import simmim
    from vit_ocm_wmsegmentation_tpu_torch.models.vit import ViTConfig
    from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step
    from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer
    from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

    cfg = default_config()
    cfg.TRAIN.ACCUMULATION_STEPS = k
    cfg.TRAIN.OPTIMIZER.EPS = 1e-3
    model = simmim.init(ViTConfig(patch_size=8, embed_dim=384, depth=1, num_heads=3,
                                  pretrain_img_size=32), torch.Generator().manual_seed(8), device)
    opt = Optimizer(cfg, model, lambda t: 1e-3 * (t + 1))
    step = make_train_step(model, opt)
    rng = np.random.default_rng(9)
    outs, read = [], []
    with pipeline.exact_matmuls():
        for i in range(calls):
            x = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32)).to(device)
            mask = torch.from_numpy((rng.random((2, 4, 4)) > 0.5).astype(np.int32)).to(device)
            before = [p.detach().clone() for p in opt.params]
            loss, gnorm = step(x, mask)
            read.append((float(loss), float(gnorm)))
            outs.append((loss, gnorm))
            applied = (i + 1) % k == 0
            assert opt.updates == (i + 1) // k
            moved = any(not torch.equal(b, p) for b, p in zip(before, opt.params))
            assert moved == applied, (i, moved)
            if applied:
                u = opt.updates - 1
                want = np.float32(1e-3 * ((u * k + k - 1 if k > 1 else u) + 1))
                assert [np.float32(float(g["lr"])) for g in opt.opt.param_groups] == [want] * 2
    for j in range(2):
        assert len({o[j].data_ptr() for o in outs}) == calls
    assert [(float(a), float(b)) for a, b in outs] == read
    assert len({v for v, _ in read}) == calls  # each batch its own loss
    return step

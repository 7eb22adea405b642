"""The DINOv2 block's kernels (csrc/swiglu.cu) against their plain twins,
and the launches of the DINOv2 and DINO mosaic paths, on the card.

Needs a CUDA device and nvcc; skips elsewhere. This file imports no JAX, so
it also runs where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_swiglu.py --noconftest -q -p no:cacheprovider
"""

import pytest
import torch

from benchmark import spec
from benchmark.runners import serve_dinov2
from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
from vit_ocm_wmsegmentation_tpu_torch.models import vit
from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as fa
from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as fm
from vit_ocm_wmsegmentation_tpu_torch.ops import swiglu as sw

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
# max|kernel - twin| / max|twin|: f32 differs from the twin in expf's last bit
# and the LayerNorm's order of sums; bf16 by one rounding of those
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
CELL_ROWS = 49 * 1301  # the g14reg_fused_1512 cell's rows a ViT call


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with pl.exact_matmuls():
        yield torch.device("cuda")


def _close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * float(want.float().abs().max()), err
    if dtype == torch.bfloat16:  # one rounding apart at most, and seldom
        same = float((got == want).float().mean())
        assert same >= 0.99, same


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,hidden", [(CELL_ROWS, 4096), (1, 4096), (7, 344), (1301, 4096),
                                         (130, 8), (257, 1024)])
def test_gate_kernel_matches_twin(cuda, dtype, rows, hidden):
    gen = torch.Generator(device=cuda).manual_seed(rows + hidden)
    x12 = (torch.randn(rows, 2 * hidden, generator=gen, device=cuda) * 3).to(dtype)
    before = sw.swiglu_gate.launches
    got = sw.swiglu_gate(x12)
    assert sw.swiglu_gate.launches == before + 1
    _close(got, sw.swiglu_gate_plain(x12), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(CELL_ROWS, 1536), (1, 1536), (9, 1536), (1301, 128),
                                    (131, 384), (64, 2048), (5, 8)])
def test_layerscale_norm_kernel_matches_twin(cuda, dtype, rows, d):
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = torch.randn(rows, d, generator=gen, device=cuda).to(dtype)
    y = (torch.randn(rows, d, generator=gen, device=cuda) * 4).to(dtype)
    gamma = torch.rand(d, generator=gen, device=cuda).to(dtype) * 0.9 + 0.1
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(d, generator=gen, device=cuda)
    before = sw.layerscale_norm.launches
    out, z = sw.layerscale_norm(x, y, gamma, scale, bias, 1e-6)
    assert sw.layerscale_norm.launches == before + 1
    want_out, want_z = sw.layerscale_norm_plain(x, y, gamma, scale, bias, 1e-6)
    assert torch.equal(out, want_out)  # the sum is rounded once, as the twin rounds it
    _close(z, want_z, dtype)


def _g14_model(cuda, depth=None):
    cfg = dict(spec.load_cell("g14reg_fused_1512").config)
    if depth is not None:
        cfg["depth"] = depth
    state = serve_dinov2.make_state(cfg, 2**31 + 5, cuda)
    with torch.device("meta"):
        model = vit.ViT(serve_dinov2.vit_config(vit, cfg))
    model.load_state_dict(state, assign=True)
    return model.requires_grad_(False), cfg


def _launches():
    return (fa.attention_qkv.launches, fm.fused_mlp_block_lnout.launches,
            fm.fused_mlp_block.launches, sw.swiglu_gate.launches, sw.layerscale_norm.launches)


def test_mosaic_launches_of_both_block_kinds(cuda):
    """A 1512^2 mosaic of ViT-g/14 (49 tiles, one ViT call) launches 39
    attention kernels, 39 gates and 78 LayerScale residuals and no fused MLP;
    a 1152^2 mosaic of ViT-S/8 its 11 attention, 10 lnout and 1 plain MLP
    launches and none of the DINOv2 kernels."""
    model, cfg = _g14_model(cuda)
    img = torch.randint(0, 256, (1512, 1512), dtype=torch.uint8, device=cuda)
    routes = vit.infer_routes("auto", cfg=model.cfg)
    before = _launches()
    pl.segment_mosaic(model, img, 504, 168, dtype=torch.bfloat16, routes=routes)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (39, 0, 0, 39, 78)
    del model
    small = pl.cast_params(vit.init(vit.ARCHS["vit_small"](), torch.Generator().manual_seed(0),
                                    device=cuda), torch.bfloat16)
    img = torch.randint(0, 256, (1152, 1152), dtype=torch.uint8, device=cuda)
    before = _launches()
    pl.segment_mosaic(small, img, 384, 128, dtype=torch.bfloat16, routes=vit.infer_routes("auto"))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (11, 10, 1, 0, 0)


def test_the_kernel_route_agrees_with_the_plain_chain(cuda):
    """ViT-g/14's widths at depth 4 on two 504^2 tiles: the kernel route
    (auto) against --infer_mlp none, both bf16: the same map up to bf16
    rounding of the residual stream (each route rounds it at other points)."""
    model, _ = _g14_model(cuda, depth=4)
    model = pl.cast_params(model, torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand(2, 504, 504, 3, generator=gen, device=cuda).to(torch.bfloat16)
    got = vit.cls_attention_grid(model, x, vit.InferRoutes("lnout")).float()
    want = vit.cls_attention_grid(model, x, vit.InferRoutes("none")).float()
    assert got.shape == (2, 24, 36, 36)
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())

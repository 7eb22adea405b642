"""The port's DINOv2 path (ViT-g/14 with registers, scaled down) against the
benchmark's plain float32 reference (benchmark/reference/dinov2.py), on the
same seeded weights in DINOv2's state-dict layout.

The tiny configuration keeps every mechanism of dinov2_vitg14_reg: patch 14,
4 register tokens, the SwiGLU FFN (hidden (int(4 D 2/3) + 7) // 8 * 8),
LayerScale on both residuals, DINOv2's antialiased positional interpolation;
width 128, 2 heads of 64, depth 3, a 6 x 6 positional table (84^2) standing
for the published 37 x 37 (518^2), so that 70^2, 84^2 and 112^2 images are
grids below, at and above the table, as 36, 37 and 40 are at full size.
LayerScale gammas are per channel in [0.1, 1], as the benchmark draws them.

Tolerances: both sides compute in float32 on the CPU; they differ in the
order of sums (the port's LayerNorm, its tiled online softmax in the
attention twin, F.linear for the patch convolution), a few float32 ulps
through three blocks: the maps read 1.0-1.4e-7 of their largest magnitude,
the features 0.6-1.0e-6. Both are compared at 5e-6 of their largest
magnitude, the mosaic canvas at 1e-5 relative in norm. Every negative case
below moves the compared number by at least 100 times its tolerance (GELU
in SwiGLU's place, the smallest, by about 260 times).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import dinov2 as ref
from benchmark.runners import serve_dinov2
from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
from vit_ocm_wmsegmentation_tpu_torch import sw_processing
from vit_ocm_wmsegmentation_tpu_torch.models import vit
from vit_ocm_wmsegmentation_tpu_torch.ops import attention as att
from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as fm
from vit_ocm_wmsegmentation_tpu_torch.ops import swiglu as sw
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as ckpt

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

CFG = {"patch_size": 14, "embed_dim": 128, "depth": 3, "num_heads": 2, "mlp_ratio": 4,
       "ffn": "swiglu", "ffn_hidden": 344, "layerscale": True, "num_register_tokens": 4,
       "pos_interp": "antialias", "qkv_bias": True, "ln_eps": 1e-6, "img_size": 84,
       "weights": {"dtype": "float32", "std": 0.02, "bias_std": 0.02, "gamma_low": 0.1,
                   "gamma_high": 1.0}}
TCFG = vit.ViTConfig(patch_size=14, embed_dim=128, depth=3, num_heads=2, pretrain_img_size=84,
                     num_register_tokens=4, ffn="swiglu", layerscale=True, pos_interp="antialias")
MAP_TOL = 5e-6  # of the largest magnitude: float32 sums in another order
CANVAS_TOL = 1e-5  # relative in norm
CPU = torch.device("cpu")
# DINOv2's hub state-dict keys (hub/backbones.py dinov2_vitg14_reg, block_chunks=0)
HUB_TOP = {"cls_token", "pos_embed", "register_tokens", "mask_token", "patch_embed.proj.weight",
           "patch_embed.proj.bias", "norm.weight", "norm.bias"}
HUB_BLOCK = {"norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
             "attn.proj.weight", "attn.proj.bias", "ls1.gamma", "norm2.weight", "norm2.bias",
             "mlp.w12.weight", "mlp.w12.bias", "mlp.w3.weight", "mlp.w3.bias", "ls2.gamma"}


def _state(seed=7):
    return serve_dinov2.make_state(CFG, seed, CPU)


def _model(state, cfg=TCFG):
    model = vit.ViT(cfg)
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(False)


def _images(px, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).random((2, px, px, 3), dtype=np.float32))


def _max_gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_the_published_configuration():
    c = vit.ARCHS["dinov2_vitg14_reg"](patch_size=14)
    assert (c.embed_dim, c.depth, c.num_heads, c.head_dim, c.ffn_hidden) == (1536, 40, 24, 64, 4096)
    assert (c.num_register_tokens, c.pos_grid, c.num_pos_tokens) == (4, 37, 37 * 37 + 1)
    assert c.block_kind == "dinov2" and c.layerscale and c.pos_interp == "antialias"
    d = vit.ViTConfig()
    assert (d.block_kind, d.num_prefix_tokens, d.ffn_hidden) == ("dino", 1, 384 * 4)
    m = vit.ViT(vit.ARCHS["vit_small"]())
    assert not any(k.endswith((".gamma", "register_tokens", "mask_token")) for k in m.state_dict())
    assert sw_processing.arch_config("dinov2_vitg14_reg", 14) == c
    with pytest.raises(ValueError, match="patch_size 14"):
        sw_processing.arch_config("dinov2_vitg14_reg", 8)


def test_a_hub_layout_state_dict_loads_and_gives_the_references_map(tmp_path):
    """A synthetic state dict under DINOv2's hub keys, saved as a .pth and
    read back by train/checkpoint.load_torch_checkpoint, loads strictly."""
    state = _state()
    assert set(state) == HUB_TOP | {f"blocks.{i}.{k}" for i in range(3) for k in HUB_BLOCK}
    path = tmp_path / "dinov2_tiny.pth"
    torch.save(state, path)
    model = _model(ckpt.load_torch_checkpoint(str(path), TCFG))
    x = _images(84)
    got = vit.cls_attention_grid(model, x, vit.infer_routes("auto", cfg=TCFG))
    want = ref.cls_attention(state, CFG, x)
    assert got.shape == want.shape == (2, 2, 6, 6)
    assert _max_gap(got, want) <= MAP_TOL


@pytest.mark.parametrize("px", [70, 84, 112], ids=["below", "at", "above"])
@pytest.mark.parametrize("mlp", ["lnout", "none"])
def test_cls_attention_grid_matches_the_reference(px, mlp):
    state = _state()
    x = _images(px)
    got = vit.cls_attention_grid(_model(state), x, vit.InferRoutes(mlp))
    want = ref.cls_attention(state, CFG, x)
    assert got.shape == (2, 2, px // 14, px // 14)
    assert _max_gap(got, want) <= MAP_TOL


@pytest.mark.parametrize("px", [70, 84, 112], ids=["below", "at", "above"])
def test_forward_features_match_the_reference(px):
    state = _state(11)
    x = _images(px, 4)
    got = vit.forward_features(_model(state), x, vit.infer_routes("auto", cfg=TCFG))
    want = ref.forward_features(state, CFG, x)
    keep = torch.cat([want[:, :1], want[:, 5:]], dim=1)  # the registers dropped
    assert got.shape == keep.shape == (2, 1 + (px // 14) ** 2, 128)
    assert _max_gap(got, keep) <= MAP_TOL


def test_the_positional_table_follows_dinov2s_rule():
    """Antialiased bicubic to the grid's size (A = -0.5), not DINO's A = -0.75
    with +0.1 on the scale; the table as it is at its own grid; kept per
    grid on the model."""
    model = _model(_state())
    pos = model.pos_embed
    assert vit.pos_embed_for(model, (6, 6)) is pos
    got = vit.pos_embed_for(model, (5, 5))
    assert vit.pos_embed_for(model, (5, 5)) is got
    grid = pos[:, 1:].reshape(1, 6, 6, 128).permute(0, 3, 1, 2)
    want = F.interpolate(grid, size=(5, 5), mode="bicubic", antialias=True)
    torch.testing.assert_close(got[:, 1:], want.permute(0, 2, 3, 1).reshape(1, 25, 128),
                               rtol=0, atol=0)
    v1 = vit.interpolate_pos_embed(pos, (5, 5))
    assert float((v1 - got).abs().max()) > 1e3 * MAP_TOL * float(pos.abs().max())


def test_a_3x3_tile_mosaic_matches_the_reference():
    state = _state(5)
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.integers(0, 256, (112, 112), dtype=np.uint8))
    mask, attn = pl.segment_mosaic(_model(state), img, 56, 28,
                                   routes=vit.infer_routes("auto", cfg=TCFG))
    assert pl.mosaic_tiles(img, 56, 28).shape[0] == 9
    canvas = ref.attention_canvas(state, CFG, img, 56, 28)
    rel = float(torch.linalg.vector_norm(attn - canvas) / torch.linalg.vector_norm(canvas))
    assert rel <= CANVAS_TOL
    assert mask.shape == img.shape and set(mask.unique().tolist()) <= {0, 255}


def _grid_gap(model, state, px=84):
    x = _images(px)
    return _max_gap(vit.cls_attention_grid(model, x, vit.InferRoutes("lnout")),
                    ref.cls_attention(state, CFG, x))


def test_dropping_the_registers_fails():
    state = _state()
    cfg = vit.ViTConfig(**{**TCFG.__dict__, "num_register_tokens": 0})
    cut = {k: v for k, v in state.items() if k != "register_tokens"}
    assert _grid_gap(_model(cut, cfg), state) > 100 * MAP_TOL


def test_dropping_layerscale_fails():
    state = _state()
    ones = {k: (torch.ones_like(v) if k.endswith(".gamma") else v) for k, v in state.items()}
    assert _grid_gap(_model(ones), state) > 100 * MAP_TOL


def test_gelu_in_place_of_swiglus_silu_fails(monkeypatch):
    state = _state()

    def gelu_gate(x12):
        a, b = x12.float().chunk(2, dim=-1)
        return (F.gelu(a) * b).to(x12.dtype)

    monkeypatch.setattr(sw, "swiglu_gate", gelu_gate)
    assert _grid_gap(_model(state), state) > 100 * MAP_TOL


def test_keeping_the_register_columns_in_the_map_fails():
    """The map of the CLS row's columns from 1 on (registers in, the last R
    patches out), as DINO's [:, :, 1:] would read it."""
    state = _state()
    model = _model(state)
    x = _images(84)
    h, last = vit._last_block_input(model, x, vit.InferRoutes())
    row = att.cls_row_attention(h, last.attn.qkv.weight, last.attn.qkv.bias, 2)
    wrong = row[:, :, 1 : 1 + 36].reshape(2, 2, 6, 6)
    assert _max_gap(wrong, ref.cls_attention(state, CFG, x)) > 100 * MAP_TOL


def test_the_kernel_route_calls_each_kernel_as_often_as_the_card_launches_it(monkeypatch):
    """A cls_attention_grid call runs depth - 1 gates and 2 (depth - 1)
    LayerScale residuals (39 and 78 at depth 40); the DINO block none."""
    calls = {"gate": 0, "lsnorm": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(sw, "swiglu_gate", counted("gate", sw.swiglu_gate))
    monkeypatch.setattr(sw, "layerscale_norm", counted("lsnorm", sw.layerscale_norm))
    vit.cls_attention_grid(_model(_state()), _images(56), vit.InferRoutes())
    assert calls == {"gate": 2, "lsnorm": 4}
    dino = vit.init(vit.ViTConfig(patch_size=8, embed_dim=32, depth=3, num_heads=2,
                                  pretrain_img_size=32), torch.Generator().manual_seed(0))
    vit.cls_attention_grid(dino, _images(32), vit.InferRoutes())
    assert calls == {"gate": 2, "lsnorm": 4}


def test_the_twins_round_as_stated():
    """The gate: silu(a) * b in f32, one rounding; the residual: x + gamma y
    in f32, one rounding, and LN of the rounded sum."""
    g = torch.Generator().manual_seed(0)
    x12 = torch.randn(5, 32, generator=g).to(torch.bfloat16)
    a, b = x12.float().chunk(2, dim=-1)
    assert torch.equal(sw.swiglu_gate(x12), (a / (1 + torch.exp(-a)) * b).to(torch.bfloat16))
    x, y = (torch.randn(5, 16, generator=g).to(torch.bfloat16) for _ in range(2))
    gamma, s, bb = (torch.rand(16, generator=g) for _ in range(3))
    out, z = sw.layerscale_norm(x, y, gamma, s, bb, 1e-6)
    assert torch.equal(out, (x.float() + gamma * y.float()).to(torch.bfloat16))
    torch.testing.assert_close(z, F.layer_norm(out.float(), (16,), s, bb, 1e-6).to(torch.bfloat16))


def test_the_routes_resolve_by_block_kind_and_width():
    small, base = vit.ARCHS["vit_small"](), vit.ARCHS["vit_base"]()
    g14 = vit.ARCHS["dinov2_vitg14_reg"](patch_size=14)
    assert vit.infer_routes("auto") == vit.InferRoutes("lnout")
    assert vit.infer_routes("auto", cfg=small) == vit.InferRoutes("lnout")
    assert vit.infer_routes("auto", cfg=base) == vit.InferRoutes("none")
    assert vit.infer_routes("auto", cfg=g14) == vit.InferRoutes("lnout")
    assert vit.infer_routes("none", cfg=g14) == vit.InferRoutes("none")
    assert vit.infer_routes("lnout", cfg=base) == vit.InferRoutes("lnout")
    with pytest.raises(ValueError, match="int8"):
        vit.infer_routes("auto", "int8", cfg=g14)
    # explicit kernel routes at a width the kernels lack still raise on the card
    x = torch.zeros(4, 768)
    with pytest.raises(ValueError, match="KERNEL_WIDTHS|D in"):
        fm.mlp_route(x, torch.zeros(3072, 768), torch.zeros(768, 3072))


@pytest.mark.parametrize("routes", [vit.InferRoutes("kernel"), vit.InferRoutes("lnout", "int8")])
def test_the_dinov2_block_refuses_the_dino_kernel_and_int8_routes(routes):
    with pytest.raises(ValueError):
        vit.cls_attention_grid(_model(_state()), _images(56), routes)


def test_the_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        sw.gate_route(torch.zeros(4, 24))
    with pytest.raises(ValueError):
        sw.lsnorm_route(torch.zeros(4, 12), torch.zeros(4, 12))
    with pytest.raises(ValueError):
        sw.lsnorm_route(torch.zeros(4, 16), torch.zeros(4, 24))
    assert sw.gate_route(torch.zeros(4, 32, dtype=torch.bfloat16)) == "swiglu.cu"
    assert sw.lsnorm_route(torch.zeros(4, 1536), torch.zeros(4, 1536)) == "swiglu.cu"


def test_the_analysis_api_drops_the_registers():
    model = _model(_state())
    x = _images(56)
    feats, attns, qkvs = vit.get_intermediate_feat(model, x, 1)
    assert feats.shape == (1, 2, 17, 128) and attns.shape == (1, 2, 2, 17, 17)
    assert qkvs.shape == (1, 3, 2, 2, 17, 64)
    rows = vit.query_attention_rows(model, x, [0, 3])
    assert rows.shape == (2, 2, 2, 17)
    torch.testing.assert_close(rows[:, :, 0], attns[0][:, :, 0], rtol=0, atol=2e-6)
    assert vit.last_block_key_features(model, x).shape == (2, 4, 4, 128)
    assert vit.get_intermediate_layers(model, x, 2).shape == (2, 2, 17, 128)

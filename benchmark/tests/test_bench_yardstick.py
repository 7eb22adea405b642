"""The yardstick on the CPU: the generators are deterministic for each seed,
the FLOP and byte counts equal hand sums, and the plain reference agrees with
an independent tiny model and with itself where it takes shortcuts."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs, roofline, weights
from benchmark.reference import precision as prec
from benchmark.reference import simmim as rsim
from benchmark.reference import vit as rvit
from benchmark.tests.conftest import TINY_MIM, TINY_VIT

CPU = torch.device("cpu")
SEED = 2**31 + 987654321  # more than 32 signed bits hold


def test_mosaics_repeat_per_seed_and_differ_across_seeds_and_indices():
    a = inputs.ocm_mosaic(96, 128, 32, SEED, 0, CPU)
    assert a.dtype == torch.uint8 and a.shape == (96, 128)
    assert torch.equal(a, inputs.ocm_mosaic(96, 128, 32, SEED, 0, CPU))
    assert not torch.equal(a, inputs.ocm_mosaic(96, 128, 32, SEED + 1, 0, CPU))
    pool = inputs.mosaic_pool(64, 16, 4, SEED, CPU)
    assert len({p.numpy().tobytes() for p in pool}) == 4
    assert torch.equal(pool, inputs.mosaic_pool(64, 16, 4, SEED, CPU))


def test_source_tiles_are_the_cut_mosaic(tmp_path):
    t = inputs.source_tiles(32, 2, 3, 24, SEED, CPU)
    m = inputs.ocm_mosaic(64, 96, 24, SEED, 0, CPU)
    assert t.shape == (6, 32, 32) and torch.equal(t[4], m[32:64, 32:64])
    paths = inputs.write_pngs(t, str(tmp_path))
    from PIL import Image
    assert np.array_equal(np.asarray(Image.open(paths[4])), t[4].numpy())


@pytest.mark.parametrize("cfg", [TINY_VIT, TINY_MIM], ids=["vit", "simmim"])
def test_weights_repeat_per_seed(cfg):
    a = weights.make_state(cfg, SEED, CPU)
    b = weights.make_state(cfg, SEED, CPU)
    c = weights.make_state(cfg, SEED + 1, CPU)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight" if "decoder" not in cfg
                             else "encoder.blocks.0.attn.qkv.weight"],
                           c["blocks.0.attn.qkv.weight" if "decoder" not in cfg
                             else "encoder.blocks.0.attn.qkv.weight"])


def test_weights_load_into_the_port_modules():
    from vit_ocm_wmsegmentation_tpu_torch.models import simmim, vit

    cfg = vit.ViTConfig(patch_size=8, embed_dim=64, depth=2, num_heads=2, pretrain_img_size=32)
    vit.ViT(cfg).load_state_dict(weights.make_state(TINY_VIT, SEED, CPU))
    mcfg = vit.ViTConfig(patch_size=8, embed_dim=64, depth=1, num_heads=2, pretrain_img_size=32)
    simmim.SimMIM(mcfg).load_state_dict(weights.make_state(TINY_MIM, SEED, CPU))


def test_counts_equal_hand_sums():
    assert roofline.attention_fwd(2, 3, 5, 4, 2) == (4 * 2 * 3 * 25 * 4, 4 * 2 * 5 * 12 * 2)
    assert roofline.attention_bwd(2, 3, 5, 4, 4) == (8 * 2 * 3 * 25 * 4, 8 * 2 * 5 * 12 * 4)
    assert roofline.mlp_fwd(10, 4, 16, 2) == (4 * 10 * 4 * 16, (10 * 4 * 2 + 2 * 4 * 16) * 2)
    assert roofline.mlp_fwd(10, 4, 16, 2, emits_z=True)[1] == (10 * 4 * 3 + 2 * 4 * 16) * 2
    assert roofline.mlp_bwd(10, 4, 16, 4) == (8 * 10 * 4 * 16, (3 * 10 * 4 + 4 * 4 * 16) * 4)
    cfg = {"embed_dim": 8, "patch_size": 4, "num_heads": 2, "depth": 3, "mlp_ratio": 4}
    n, d, h = 5, 8, 32  # an 8^2 window: 2x2 patches + CLS
    block = 2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d + 4 * n * d * h
    tile = 2 * 4 * 48 * d + 2 * block + (2 * n * d * d + 2 * d * d + 2 * n * d)
    assert roofline.serve_tile_flops(cfg, 8) == tile
    assert roofline.tiles_per_mosaic(16, 8, 4) == 9
    assert roofline.serve_mosaic_flops(cfg, 16, 8, 4) == 9 * tile
    assert roofline.serve_attention(cfg, 16, 8, 4, "bfloat16") == (2 * 4 * 9 * n * n * d,
                                                                  2 * 4 * 9 * n * d * 2)
    f, b = roofline.serve_mlp(cfg, 16, 8, 4, "float32")
    assert f == 2 * 4 * 45 * d * h and b == (45 * d * 3 + 2 * d * h + 45 * d * 2 + 2 * d * h) * 4
    fwd = 2 * 2 * 4 * 48 * d + 3 * (2 * (2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d
                                         + 4 * n * d * h)) + 2 * 2 * 4 * d * 48
    assert roofline.train_step_flops(cfg, 2, 8) == 3 * fwd
    assert roofline.bound(67e12, 0, "float32") == (1.0, "operations")
    assert roofline.bound(0, 3.35e12, "bfloat16") == (1.0, "bytes")


def test_counts_at_the_cells_shapes():
    vits8 = {"embed_dim": 384, "patch_size": 8, "num_heads": 6, "depth": 12, "mlp_ratio": 4}
    assert roofline.serve_mosaic_flops(vits8, 1152, 384, 128) == pytest.approx(8.85e12, rel=2e-3)
    mim = {"embed_dim": 384, "patch_size": 8, "num_heads": 3, "depth": 4, "mlp_ratio": 4}
    assert roofline.train_step_flops(mim, 16, 384) == pytest.approx(3.17e12, rel=3e-3)


class TinyViT(torch.nn.Module):
    """An independent plain ViT of torch.nn modules, DINO's layout."""

    def __init__(self, cfg):
        super().__init__()
        d, p = cfg["embed_dim"], cfg["patch_size"]
        self.cfg = cfg
        self.patch = torch.nn.Conv2d(3, d, p, p)
        n = (cfg["img_size"] // p) ** 2 + 1
        self.cls = torch.nn.Parameter(torch.zeros(1, 1, d))
        self.pos = torch.nn.Parameter(torch.zeros(1, n, d))
        self.blocks = torch.nn.ModuleList()
        for _ in range(cfg["depth"]):
            b = torch.nn.Module()
            b.n1, b.n2 = torch.nn.LayerNorm(d, eps=1e-6), torch.nn.LayerNorm(d, eps=1e-6)
            b.qkv, b.proj = torch.nn.Linear(d, 3 * d), torch.nn.Linear(d, d)
            b.fc1, b.fc2 = torch.nn.Linear(d, 4 * d), torch.nn.Linear(4 * d, d)
            self.blocks.append(b)

    def load(self, s):
        with torch.no_grad():
            self.patch.weight.copy_(s["patch_embed.proj.weight"])
            self.patch.bias.copy_(s["patch_embed.proj.bias"])
            self.cls.copy_(s["cls_token"])
            self.pos.copy_(s["pos_embed"])
            for i, b in enumerate(self.blocks):
                for mod, key in ((b.n1, "norm1"), (b.n2, "norm2"), (b.qkv, "attn.qkv"),
                                 (b.proj, "attn.proj"), (b.fc1, "mlp.fc1"), (b.fc2, "mlp.fc2")):
                    mod.weight.copy_(s[f"blocks.{i}.{key}.weight"])
                    mod.bias.copy_(s[f"blocks.{i}.{key}.bias"])

    def last_attention(self, x):
        heads = self.cfg["num_heads"]
        t = self.patch(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        g = int(math.sqrt(self.pos.shape[1] - 1))
        gh = x.shape[1] // self.cfg["patch_size"]
        pos = self.pos
        if gh != g:
            grid = F.interpolate(pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2),
                                 scale_factor=((gh + 0.1) / g, (gh + 0.1) / g), mode="bicubic")
            pos = torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], 1)
        t = torch.cat([self.cls.expand(x.shape[0], -1, -1), t], 1) + pos
        for i, b in enumerate(self.blocks):
            q, k, v = b.qkv(b.n1(t)).chunk(3, -1)
            sh = lambda z: z.unflatten(-1, (heads, -1)).transpose(1, 2)  # noqa: E731
            a = torch.softmax(sh(q) @ sh(k).transpose(-1, -2) / math.sqrt(q.shape[-1] / heads), -1)
            if i == len(self.blocks) - 1:
                return a[:, :, 0, 1:]
            t = t + b.proj((a @ sh(v)).transpose(1, 2).flatten(2))
            t = t + b.fc2(F.gelu(b.fc1(b.n2(t))))


def test_reference_cls_attention_matches_a_plain_model():
    s = weights.make_state(TINY_VIT, SEED, CPU)
    x = torch.rand(2, 48, 48, 3, generator=torch.Generator().manual_seed(1))
    m = TinyViT(TINY_VIT)
    m.load(s)
    with torch.no_grad():
        want = m.last_attention(x)
    got = rvit.cls_attention(s, TINY_VIT, x)
    assert torch.allclose(got.flatten(2), want, rtol=1e-5, atol=1e-7)


def _literal_blend(tiles, stride):
    """sw_processing's iterative blend in float64 numpy, rows then columns."""
    step = tiles[0][0].shape[0] - stride
    ramp = np.linspace(1.0, 0.0, step)

    def cat(parts, axis):
        acc = parts[0]
        for r in parts[1:]:
            a, b = np.moveaxis(acc, axis, 0), np.moveaxis(r, axis, 0)
            w = ramp.reshape((-1,) + (1,) * (a.ndim - 1))
            ov = a[-step:] * w + b[:step] * (1 - w)
            acc = np.moveaxis(np.concatenate([a[:-step], ov, b[step:]]), 0, axis)
        return acc

    return cat([cat(row, 1) for row in tiles], 0)


def test_stitch_is_the_literal_blend():
    g = torch.Generator().manual_seed(3)
    maps = torch.rand(3 * 4, 8, 8, generator=g, dtype=torch.float64)
    want = _literal_blend([[maps[r * 4 + c].numpy() for c in range(4)] for r in range(3)], 4)
    got = rvit.stitch_rows(maps, 4, 4)
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_canvas_strips_equal_the_whole_canvas():
    s = weights.make_state(TINY_VIT, SEED, CPU)
    img = inputs.ocm_mosaic(160, 96, 32, SEED, 0, CPU)
    whole = rvit.attention_canvas(s, TINY_VIT, img, 64, 32)
    n_rows = len(rvit.tile_starts(160, 64, 32))
    for first, last in ((0, 1), (1, 3), (2, n_rows - 1)):
        (y0, y1), strip = rvit.canvas_rows(s, TINY_VIT, img, 64, 32, first, last)
        assert y1 > y0 and torch.allclose(strip, whole[y0:y1], rtol=1e-5, atol=1e-4)


def test_otsu_is_cv2s_maximum_of_the_between_class_variance():
    rng = np.random.default_rng(5)
    for _ in range(5):
        hist = np.bincount(np.clip(rng.normal(rng.uniform(60, 190), 30, 5000), 0, 255)
                           .astype(int), minlength=256)
        p = hist / hist.sum()
        best, level = -1.0, 0
        for t in range(256):
            w1, w2 = p[: t + 1].sum(), p[t + 1 :].sum()
            if min(w1, w2) < 1.1920929e-07:
                continue
            m1 = (np.arange(t + 1) * p[: t + 1]).sum() / w1
            m2 = (np.arange(t + 1, 256) * p[t + 1 :]).sum() / w2
            if w1 * w2 * (m1 - m2) ** 2 > best + 1e-12:
                best, level = w1 * w2 * (m1 - m2) ** 2, t
        assert rvit.otsu_cv2(hist) == level


def test_simmim_row_blocks_equal_one_batch():
    s = weights.make_state(TINY_MIM, SEED, CPU)
    g = torch.Generator().manual_seed(2)
    x = torch.rand(6, 32, 32, 3, generator=g)
    mask = (torch.rand(6, 4, 4, generator=g) > 0.5).int()
    opt = {"base_lr": 5e-4, "warmup_lr": 5e-7, "min_lr": 5e-6, "warmup_steps": 60,
           "total_steps": 90, "clip_grad": 5.0,
           "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0.05}
    loss, grads = rsim.Trainer(s, TINY_MIM, opt).grads(x, mask)
    live = {n: t.clone().requires_grad_(True) for n, t in s.items()}
    total, pix = rsim.loss_sum(rsim._encoder_view(live), TINY_MIM, x, mask, "float32")
    full = total / (pix + 1e-5) / 3.0
    want = torch.autograd.grad(full, list(live.values()))
    assert loss == pytest.approx(float(full), rel=1e-6)
    for (n, _), w in zip(live.items(), want):
        assert torch.allclose(grads[n], w, rtol=1e-4, atol=1e-9), n


def test_reference_adamw_is_torchs():
    s = weights.make_state(TINY_MIM, SEED, CPU)
    g = torch.Generator().manual_seed(4)
    x = torch.rand(4, 32, 32, 3, generator=g)
    mask = (torch.rand(4, 4, 4, generator=g) > 0.5).int()
    opt = {"base_lr": 5e-4, "warmup_lr": 1e-3, "min_lr": 5e-6, "warmup_steps": 60,
           "total_steps": 90, "clip_grad": 0.0,
           "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0.05}
    tr = rsim.Trainer(s, TINY_MIM, opt)
    _, grads = tr.grads(x, mask)
    params = {n: torch.nn.Parameter(t.clone()) for n, t in s.items()}
    decay = [p for n, p in params.items() if not rsim.no_decay(n, p)]
    rest = [p for n, p in params.items() if rsim.no_decay(n, p)]
    ta = torch.optim.AdamW([{"params": decay, "weight_decay": 0.05},
                            {"params": rest, "weight_decay": 0.0}], lr=1e-3, eps=1e-8)
    for n, p in params.items():
        p.grad = grads[n]
    ta.step()
    tr.step(x, mask)
    for n, p in params.items():
        assert torch.allclose(tr.params[n], p.detach(), rtol=1e-6, atol=1e-9), n


@pytest.mark.parametrize("precision, lo, hi", [("tf32", 1e-5, 2**-11), ("fp8", 1e-3, 2**-3)])
def test_control_precisions_round_their_operands(precision, lo, hi):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 0.02
    err = ((prec.round_operand(x, precision) - x).abs() / x.abs()).median()
    assert lo < err < hi


def test_reference_feed_is_the_device_loader(tmp_path):
    from vit_ocm_wmsegmentation_tpu_torch.data.datasets import build_simmim_device_loader

    from benchmark.reference import augment

    tiles = inputs.source_tiles(64, 2, 3, 24, SEED, CPU)
    inputs.write_pngs(tiles, str(tmp_path))
    loader = build_simmim_device_loader(str(tmp_path), 2, 32, 16, 8, 0.5, seed=SEED, device=CPU)
    for epoch in (0, 1):
        for b, (x, mask) in enumerate(loader.epoch(epoch)):
            rx, rmask = augment.augment(tiles, SEED, epoch, b, 2, 32, 16, 8, 0.5)
            assert torch.equal(mask, rmask)
            assert torch.allclose(x, rx, rtol=0, atol=2e-6)

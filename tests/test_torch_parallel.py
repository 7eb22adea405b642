"""The port's process groups, collectives, sharding rules and sharded
mosaics on the CPU (gloo), against one rank and against the JAX package's
sharded mosaics on the conftest's 8 virtual devices, from the same weights.

One group of 4 spawned ranks (tests/parallel_workers.py) runs every
multi-rank check of this module once; the tests read its results.
"""

import os

import jax
import numpy as np
import pytest
import torch

from vit_ocm_wmsegmentation_tpu import pipeline as jpl
from vit_ocm_wmsegmentation_tpu.models import simmim as jsim
from vit_ocm_wmsegmentation_tpu.models import vit as jvit
from vit_ocm_wmsegmentation_tpu.ops import attention as jatt
from vit_ocm_wmsegmentation_tpu.parallel import make_mesh as jax_make_mesh
from vit_ocm_wmsegmentation_tpu.parallel.mesh import fsdp_param_sharding as jax_fsdp_rule
from vit_ocm_wmsegmentation_tpu_torch.models import simmim, vit
from vit_ocm_wmsegmentation_tpu_torch.parallel import dryrun
from vit_ocm_wmsegmentation_tpu_torch.parallel import mesh as pm
from vit_ocm_wmsegmentation_tpu_torch.train.checkpoint import vit_state_from_jax_numpy

import parallel_workers as pw
from port_helpers import one_torch_thread  # noqa: F401  (autouse)

WORLD = 4
JCFG = jvit.ViTConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
TCFG = vit.ViTConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
WINDOW, STRIDE = 48, 16
# 96^2: 4 x 4 = 16 tiles, 4 a rank; 144^2: 7 x 7 = 49 tiles, padded to 52
SIZES = (96, 144)


def _mosaic(size, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(120, 40, (size, size))
    base[size // 4: 3 * size // 4, size // 5: 4 * size // 5] += 70
    return np.clip(base, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_weights():
    params = jvit.init(JCFG, jax.random.PRNGKey(4))
    return params, vit_state_from_jax_numpy(jax.tree.map(np.asarray, params), TCFG)


@pytest.fixture(scope="module")
def group(jax_weights):
    """The 4-rank group's results: the collectives, then the sharded
    mosaics of both sizes."""
    _, state = jax_weights
    mosaics = [_mosaic(s, i) for i, s in enumerate(SIZES)]
    res = dryrun.spawn(pw.collectives_and_mosaics, WORLD, state, TCFG, mosaics, WINDOW, STRIDE,
                       timeout_s=240)
    return {"ranks": res, "mosaics": mosaics}


def _collectives(group):
    return [r[0] for r in group["ranks"]]


def test_mesh_coordinates_are_row_major(group):
    coords = [c["coords"] for c in _collectives(group)]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    m = pm.Mesh(("data", "model"), (2, 3), rank=4)
    assert (m.index("data"), m.index("model"), m.index("pipe")) == (1, 1, 0)
    assert m.shape == {"data": 2, "model": 3} and m.size == 6


def test_all_reduce_sums_along_one_axis(group):
    for c in _collectives(group):
        d, m = c["coords"]
        # ranks d*2 + m: 'data' sums ranks m and 2 + m, 'model' 2d and 2d + 1
        assert torch.equal(c["all_reduce_data"], torch.full((3,), float((m + 1) + (m + 3))))
        assert torch.equal(c["all_reduce_model"], torch.full((3,), float(4 * d + 3)))


def test_all_gather_reduce_scatter_broadcast(group):
    for c in _collectives(group):
        d, m = c["coords"]
        assert torch.equal(c["all_gather_dim1"], torch.tensor([[m, m + 2.0]] * 2))
        # the 'model' pair sums (2d+1) + (2d+2) times arange, split in rows
        want = torch.arange(8.0).reshape(4, 2) * (4 * d + 3)
        assert torch.equal(c["reduce_scatter"], want[2 * m: 2 * m + 2])
        assert torch.equal(c["broadcast"], torch.full((2,), float(2 * d + 1)))


def test_bucketed_all_reduce_keeps_every_tensor(group):
    for c in _collectives(group):
        got = c["all_reduce_tensors"]
        for k in range(5):
            assert torch.equal(got[k], torch.full((k + 1,), float(sum(r + k for r in range(4)))))
        assert got[5].dtype == torch.float64 and torch.equal(got[5], torch.full((2,), 10.0,
                                                                               dtype=torch.float64))


def test_send_recv_ring(group):
    for c in _collectives(group):
        assert torch.equal(c["ring_recv"], torch.full((2,), float((c["rank"] - 1) % WORLD)))


def test_49_tiles_pad_to_13_a_rank_and_gather_back(group):
    tiles = torch.arange(49 * 2, dtype=torch.float32).reshape(49, 2)
    padded = torch.cat([tiles, torch.zeros(3, 2)])
    for c in _collectives(group):
        r = c["rank"]
        assert torch.equal(c["local_tiles"], padded[13 * r: 13 * r + 13])
        assert torch.equal(c["gathered_tiles"], tiles * 2)
    assert pm.pad_rows(tiles, 4).shape == (52, 2) and pm.pad_rows(tiles, 7) is tiles
    with pytest.raises(ValueError, match="not divisible"):
        pm.local_rows(tiles, pm.Mesh(("data", "model"), (4, 1)))


def test_megatron_pair_sums_forward_and_gradient(group):
    """y = exit(enter(x) * w_m) sums the ranks' products forward (w_0 + w_1
    on the first element), and enter's backward sums the ranks' gradients."""
    for c in _collectives(group):
        assert torch.equal(c["tp_y"], torch.tensor([1.0 * 3, 2.0 * 6]))
        assert torch.equal(c["tp_gx"], torch.tensor([3.0, 60.0]))


def test_init_distributed_from_torchrun_variables(tmp_path, monkeypatch):
    """Two processes with torchrun's RANK / WORLD_SIZE / LOCAL_RANK and
    nothing passed: the group forms, a second call returns the same, and
    only rank 0's on_main_process writes. Without WORLD_SIZE nothing
    starts."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = tmp_path / "store"
    procs = [ctx.Process(target=pw.torchrun_rank,
                         args=(r, 2, str(store), str(tmp_path), str(tmp_path / f"r{r}.pt")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs)
    for r in range(2):
        res = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        assert res["first"] == res["again"] == (r, 2)
        assert res["main"] == (r == 0) and res["total"] == 3.0
    assert (tmp_path / "main_0.txt").exists() and not (tmp_path / "main_1.txt").exists()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pm.init_distributed() == (0, 1) and not pm.is_distributed()
    assert pm.is_main_process() and pm.on_main_process(lambda: 7) == 7


def test_ranks_building_at_once_build_once(tmp_path):
    """Ranks started together all ask for the kernel library: the first
    takes the file lock and builds, the others wait on it and load what it
    built (nvcc replaced by a stand-in; this host has none)."""
    log = tmp_path / "compiled.txt"
    res = dryrun.spawn(pw.build_at_once, 3, str(tmp_path / "_build"), str(log), timeout_s=120)
    assert log.read_text().split() in (["0"], ["1"], ["2"])
    assert len({path for path, _ in res}) == 1
    assert sorted(sec > 0 for _, sec in res) == [False, False, True]
    assert os.listdir(tmp_path / "_build") and not [
        p for p in os.listdir(tmp_path / "_build") if p.endswith((".tmp", ".objs"))]


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2)])
def test_fsdp_rule_at_vit_s_geometry_matches_jax(data, model):
    """The production rule (4096 elements a shard) at the ViT-S/8 MIM
    geometry: every weight matrix shards, along an axis of the same size as
    the JAX package's, and every bias, LayerNorm vector and token stays
    replicated, as fsdp_param_sharding decides on the JAX tree. The JAX tree
    stacks the 12 blocks, so its block vectors are 12 times the port's
    tensors: at data 4 its (12, 1536) fc1 bias passes the per-shard floor
    (4608 elements) where the port's (1536,) does not (384); that is the one
    difference, and the rule's own."""
    big_j = jvit.ViTConfig(patch_size=8, embed_dim=384, depth=12, num_heads=6,
                           pretrain_img_size=224)
    shapes = jax.eval_shape(lambda: jsim.init(big_j, jax.random.PRNGKey(0)))
    jspec = jax_fsdp_rule(jax_make_mesh(data=data, model=model), shapes)
    tree = jax.tree.map(lambda s: s.shape, shapes)

    def jax_side(path):
        node, spec = tree, jspec
        for k in path.split("/"):
            node, spec = node[k], spec[k]
        axes = [i for i, a in enumerate(spec.spec) if a == "data"]
        return (node[axes[0]] if axes else None)

    big = vit.ViTConfig(patch_size=8, embed_dim=384, depth=12, num_heads=6, pretrain_img_size=224)
    with torch.device("meta"):
        model_t = simmim.SimMIM(big)
    tspec = pm.fsdp_param_sharding(pm.Mesh(("data", "model"), (data, model)),
                                   model_t.named_parameters())
    shapes_t = dict(model_t.named_parameters())

    def port_side(name):
        s = tspec[name]
        return shapes_t[name].shape[s.dim] if s is not None else None

    pairs = {"pos_embed": "encoder.pos_embed", "cls_token": "encoder.cls_token",
             "mask_token": "encoder.mask_token",
             "patch_embed/kernel": "encoder.patch_embed.proj.weight",
             "patch_embed/bias": "encoder.patch_embed.proj.bias",
             "norm/scale": "encoder.norm.weight", "norm/bias": "encoder.norm.bias",
             "decoder/kernel": "decoder.0.weight", "decoder/bias": "decoder.0.bias"}
    block = {"attn/wqkv": "attn.qkv.weight", "attn/bqkv": "attn.qkv.bias",
             "attn/wo": "attn.proj.weight", "attn/bo": "attn.proj.bias",
             "mlp/w1": "mlp.fc1.weight", "mlp/b1": "mlp.fc1.bias", "mlp/w2": "mlp.fc2.weight",
             "mlp/b2": "mlp.fc2.bias", "norm1/scale": "norm1.weight", "norm1/bias": "norm1.bias",
             "norm2/scale": "norm2.weight", "norm2/bias": "norm2.bias"}
    pairs = list(pairs.items()) + [(f"blocks/{k}", f"encoder.blocks.{i}.{v}")
                                   for i in range(12) for k, v in block.items()]
    assert sorted(n for _, n in pairs) == sorted(shapes_t)
    for jpath, name in pairs:
        if data == 4 and jpath == "blocks/mlp/b1":
            assert port_side(name) is None and jax_side(jpath) == 1536
            assert 12 * 1536 // data >= 4096 > 1536 // data
            continue
        assert port_side(name) == jax_side(jpath), (jpath, name)
    weights = [n for n in shapes_t if n.endswith("weight") and shapes_t[n].ndim > 1]
    assert all(tspec[n] is not None for n in weights)
    assert all(tspec[n] is None for n in shapes_t if shapes_t[n].ndim == 1)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["fused", "streamed"])
def test_sharded_mosaic_equals_one_rank(group, size, kind):
    """Every rank returns the single-rank mask bit for bit and its
    attention within 5e-3 on the 0-255 scale (the tiles, or each band's
    row of tiles, sharded over 4 ranks; 49 tiles pad to 52)."""
    i = SIZES.index(size)
    for res in (r[1][i] for r in group["ranks"]):
        (mask, attn), (smask, sattn) = res[kind], res[kind + "_single"]
        assert torch.equal(mask, smask)
        assert float((attn - sattn).abs().max()) <= 5e-3
    first = group["ranks"][0][1][i][kind]
    for r in group["ranks"][1:]:
        assert torch.equal(r[1][i][kind][0], first[0]) and torch.equal(r[1][i][kind][1], first[1])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["fused", "streamed"])
def test_sharded_mosaic_matches_jax_sharded_mosaic(group, jax_weights, size, kind, monkeypatch):
    """The port's 4-rank mosaic against the JAX package's on its 8-device
    mesh (the pure-dp kernel islands in interpret mode), from the same
    weights: masks Dice >= 0.999 (tests/test_torch_pipeline.py's
    single-device gate) and attention within 5e-3 on the 0-255 scale (the
    dry run's tolerance; with these weights the two packages' single-device
    maps lie up to ~4.4e-3 apart, as the sharded ones do)."""
    params, _ = jax_weights
    img = group["mosaics"][SIZES.index(size)]
    monkeypatch.setattr(jatt, "DP_KERNEL_INTERPRET", True)
    if kind == "fused":
        jmask, jattn = jpl.segment_mosaic(params, JCFG, jax.numpy.asarray(img), window=WINDOW,
                                          stride=STRIDE, mesh=jax_make_mesh())
    else:
        jmask, jattn = jpl.segment_mosaic_streamed(params, JCFG, img, window=WINDOW,
                                                   stride=STRIDE, band_chunk=2,
                                                   mesh=jax_make_mesh())
    mask, attn = group["ranks"][0][1][SIZES.index(size)][kind]
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), rtol=0, atol=5e-3)
    a, b = mask.numpy() > 0, np.asarray(jmask) > 0
    assert 2 * (a & b).sum() / (a.sum() + b.sum()) >= 0.999


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    """The dry run (parallel/dryrun.py) at its tiny geometry on 2 gloo
    ranks: every sharded MIM step against the single-rank step, every
    sharded mosaic against one rank; it raises on any failure."""
    reports = dryrun.dryrun_multichip(2, "gloo", "cpu", timeout_s=240)
    out = capsys.readouterr().out
    lines = reports[0]["lines"]
    assert len(lines) == 12 and all("mosaic" in l or "loss" in l for l in lines)
    # dp x tp: f32, f32 with one rank's residual signs, AMP
    for mode, n in (("dp x tp (data x model 1 x 2)", 3), ("dp (data 2 x 1)", 2),
                    ("fsdp (data 2 x 1)", 2), ("pp (data x pipe 1 x 2)", 2)):
        assert sum(l.startswith(mode) for l in lines) == n, mode
    assert sum("one rank's residual signs [f32]" in l for l in lines) == 1
    assert "world 2, backend gloo, device cpu" in out
    assert reports[0]["fractions"]["f32"]["encoder.blocks.0.attn.qkv.weight"] == (0.5, 0.5)
    assert reports[0]["bytes"]["fsdp [f32]"] < 0.55 * reports[0]["bytes"]["single [f32]"]


def test_dryrun_cli_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """python -m ...parallel.dryrun defaults to cuda:0 and raises without a
    card, as the port's other entry points do; the CPU run is --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--world", "2"])

"""The port's sharded MIM steps on the CPU (gloo, 4 ranks) against its
single-rank step, and its data- and pipeline-parallel steps against the JAX
package's make_train_step on a make_mesh and pp.make_pp_train_step on its 8
virtual devices, from the same weights (the JAX init, converted).

One group of 4 spawned ranks (tests/parallel_workers.py) runs every step of
this module once; the tests read its results. The batch's mask is the
JAX dry run's ``> 0.5`` draw, so the ranks' shards hold unequal mask
counts, and the global masked mean has to be taken over the whole batch.
As in tests/test_torch_train.py, the steps run without weight decay (the
packages group it differently, ROADMAP Queue 3) and with AdamW's epsilon
at 1e-3, so that a gradient near 0 whose sign the summation order flips
moves a parameter by an f32-sized amount, not by 2 learning rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ocm_wmsegmentation_tpu.models import simmim as jsim
from vit_ocm_wmsegmentation_tpu.models.vit import ViTConfig as JViTConfig
from vit_ocm_wmsegmentation_tpu.parallel import batch_sharding, data_parallel_sharding
from vit_ocm_wmsegmentation_tpu.parallel import make_mesh as jax_make_mesh
from vit_ocm_wmsegmentation_tpu.parallel import pp as jpp
from vit_ocm_wmsegmentation_tpu.parallel.mesh import shard_params
from vit_ocm_wmsegmentation_tpu.train import optim as joptim
from vit_ocm_wmsegmentation_tpu.train.mim_trainer import make_train_step as jax_step
from vit_ocm_wmsegmentation_tpu.utils.config import default_config as jax_default_config
from vit_ocm_wmsegmentation_tpu_torch.models import simmim
from vit_ocm_wmsegmentation_tpu_torch.models.vit import ViTConfig
from vit_ocm_wmsegmentation_tpu_torch.parallel import dryrun
from vit_ocm_wmsegmentation_tpu_torch.parallel import mesh as pm
from vit_ocm_wmsegmentation_tpu_torch.parallel import pp
from vit_ocm_wmsegmentation_tpu_torch.pipeline import exact_matmuls
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as ckpt
from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step
from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer
from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

import parallel_workers as pw
from port_helpers import one_torch_thread  # noqa: F401  (autouse)

WORLD, LR = 4, 1e-3
GEOM = dict(patch_size=8, embed_dim=32, depth=4, num_heads=2, pretrain_img_size=32)
F32 = {"loss": 1e-5, "gnorm": 1e-4, "params": 1e-4}
# tests/test_parallel.py::test_pp_train_step_amp_matches_single_device_amp
AMP = {"loss": 5e-3, "gnorm": 2e-2, "params": 2.5 * LR}
# (name, mode, amp, data, model or pipe, microbatches, batch index)
CASES = [("dp", "dp", False, 4, 1, 0, 0), ("fsdp", "fsdp", False, 4, 1, 0, 0),
         ("fsdp amp", "fsdp", True, 4, 1, 0, 0), ("pp 2x2", "pp", False, 2, 2, 2, 0),
         ("pp 4 stages", "pp", False, 1, 4, 3, 1), ("pp amp", "pp", True, 2, 2, 2, 0),
         ("dp x tp", "tp", False, 2, 2, 0, 0), ("dp x tp amp", "tp", True, 2, 2, 0, 0)]


def _cfgs():
    out = []
    for cfg in (jax_default_config(), default_config()):
        cfg.TRAIN.WEIGHT_DECAY = 0.0
        cfg.TRAIN.OPTIMIZER.EPS = 1e-3
        out.append(cfg)
    return out


def _batches():
    """(x, mask) of 8 images and of 6 (the pure pipeline's 3 microbatches)."""
    out = []
    for n, seed in ((8, 3), (6, 22)):
        rng = np.random.default_rng(seed)
        x = rng.random((n, 32, 32, 3), dtype=np.float32)
        mask = (rng.random((n, 4, 4)) > 0.5).astype(np.int64)
        out.append((torch.from_numpy(x), torch.from_numpy(mask)))
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = JViTConfig(**GEOM)
    params = jsim.init(jcfg, jax.random.PRNGKey(2))
    state = ckpt.mim_state_from_jax_numpy(jax.tree.map(np.asarray, params), ViTConfig(**GEOM))
    return jcfg, params, state, _batches()


@pytest.fixture(scope="module")
def group(setup):
    _, _, state, batches = setup
    res = dryrun.spawn(pw.train_steps, WORLD, _cfgs()[1], ViTConfig(**GEOM), state, batches,
                       CASES, LR, timeout_s=240)
    return {c[0]: [r[c[0]] for r in res] for c in CASES}


def _single(state, x, mask, amp):
    model = simmim.SimMIM(ViTConfig(**GEOM))
    model.load_state_dict(state)
    opt = Optimizer(_cfgs()[1], model, lambda t: LR)
    with exact_matmuls():
        loss, gnorm = make_train_step(model, opt, amp=amp)(x, mask)
    return float(loss), float(gnorm), model.state_dict()


def _assert_close(got, want, tol):
    loss, gnorm, state = got
    rloss, rgnorm, rstate = want
    assert abs(loss - rloss) <= tol["loss"] * abs(rloss), (loss, rloss)
    assert abs(gnorm - rgnorm) <= tol["gnorm"] * abs(rgnorm), (gnorm, rgnorm)
    assert set(state) == set(rstate)
    for k, v in rstate.items():
        err = float((state[k] - v).abs().max())
        assert err <= tol["params"], f"{k}: {err:.3e}"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_step_equals_single_rank_step(group, setup, case):
    """Loss, gradient norm and every updated parameter, on every rank."""
    name, mode, amp, data, other, micro, b = case
    _, _, state, batches = setup
    want = _single(state, *batches[b], amp)
    results = group[name]
    for r in results:
        _assert_close((r["loss"], r["gnorm"], r["state"]), want, AMP if amp else F32)
    if data > 1:  # the shards hold unequal mask counts
        counts = {r["local_mask"] for r in results}
        assert len(counts) > 1, counts


def test_fsdp_holds_a_quarter_of_each_sharded_tensor(group):
    """Parameters and Adam moments: 1/4 of each sharded tensor on every
    rank (min_shard 64 shards the tiny weights), biases and LayerNorm
    vectors whole."""
    for name in ("fsdp", "fsdp amp"):
        for r in group[name]:
            fr = r["fractions"]
            assert fr["encoder.blocks.0.attn.qkv.weight"] == (0.25, 0.25)
            assert fr["encoder.blocks.0.mlp.fc1.weight"] == (0.25, 0.25)
            assert fr["encoder.pos_embed"] == (0.25, 0.25)
            for n in ("encoder.blocks.0.attn.qkv.bias", "encoder.blocks.0.norm1.weight",
                      "decoder.0.bias", "encoder.mask_token"):
                assert fr[n] == (1.0, 1.0), n


def _jax_result(params, loss, gnorm, cfg):
    return (float(loss), float(gnorm),
            ckpt.mim_state_from_jax_numpy(jax.tree.map(np.asarray, params), cfg))


def test_dp_step_matches_jax_sharded_step(group, setup):
    """The port's 4-rank data-parallel step against make_train_step on the
    JAX package's 8-device make_mesh, from the same weights and batch."""
    jcfg, params, _, batches = setup
    params = jax.tree.map(jnp.copy, params)  # the JAX steps donate their inputs
    x, mask = (jnp.asarray(t.numpy()) for t in batches[0])
    jc = _cfgs()[0]
    tx = joptim.build_optimizer(jc, params, lambda t: LR)
    mesh = jax_make_mesh()
    psh, bsh = data_parallel_sharding(mesh, params), batch_sharding(mesh)
    sp = shard_params(params, psh)
    step = jax_step(jcfg, tx, mesh=mesh, param_sharding=psh, batch_sharding_=bsh)
    p8, _, l8, g8 = step(sp, tx.init(sp), jax.device_put(x, bsh), jax.device_put(mask, bsh))
    r = group["dp"][0]
    _assert_close((r["loss"], r["gnorm"], r["state"]),
                  _jax_result(p8, l8, g8, ViTConfig(**GEOM)), {"loss": 1e-4, "gnorm": 1e-4,
                                                               "params": 1e-5})


def test_pp_step_matches_jax_pp_step(group, setup):
    """The port's pipelined step (data 2 x pipe 2, 2 microbatches) against
    pp.make_pp_train_step on a (data 2, pipe 4) mesh with 4 microbatches."""
    jcfg, params, _, batches = setup
    params = jax.tree.map(jnp.copy, params)  # the JAX steps donate their inputs
    x, mask = (jnp.asarray(t.numpy()) for t in batches[0])
    jc = _cfgs()[0]
    mesh = jpp.make_pp_mesh(data=2, pipe=4)
    ppp = jpp.pp_params(params, 4)
    tx = joptim.build_optimizer(jc, ppp, lambda t: LR)
    pppd = shard_params(ppp, jpp.pp_param_sharding(mesh, ppp))
    p2, _, l2, g2 = jpp.make_pp_train_step(jcfg, tx, mesh, microbatches=4)(
        pppd, tx.init(pppd), x, mask)
    r = group["pp 2x2"][0]
    _assert_close((r["loss"], r["gnorm"], r["state"]),
                  _jax_result(jpp.unpp_params(p2), l2, g2, ViTConfig(**GEOM)),
                  {"loss": 1e-4, "gnorm": 1e-4, "params": 1e-5})


def test_pp_params_roundtrip_and_validation():
    model = simmim.SimMIM(ViTConfig(**GEOM))
    with pytest.raises(ValueError, match="not divisible by pp stages 3"):
        pp.stage_bounds(4, 3, 0)  # depth 4 % 3 != 0
    with pytest.raises(ValueError, match="not divisible by pp stages 3"):
        pp.pp_layout(pm.Mesh(("data", "pipe"), (1, 3)), model)
    with pytest.raises(ValueError, match="not divisible by microbatches 3"):
        pp.pp_run_blocks(model.encoder, torch.zeros(7, 17, 32), pm.Mesh(("data", "pipe"), (1, 2)),
                         3)
    layout = pp.pp_layout(pm.Mesh(("data", "pipe"), (1, 2), rank=1), model)
    assert layout.stage["encoder.blocks.1.norm1.weight"] == 0
    assert layout.stage["encoder.blocks.2.norm1.weight"] == 1
    assert layout.grad_owner["encoder.pos_embed"] == 0 and layout.grad_owner["decoder.0.bias"] == 1


def test_tensor_parallel_needs_whole_heads():
    """A rank keeps whole heads: the MIM ViT's 3 heads over 'model' 2 raise
    (the JAX package's GSPMD splits any layout)."""
    model = simmim.SimMIM(simmim.mim_vit_config(32, 8))
    with pytest.raises(ValueError, match="3 heads .* do not divide over the mesh's 'model' axis 2"):
        pm.vit_param_sharding(pm.Mesh(("data", "model"), (1, 2)), model)
    specs = pm.vit_param_sharding(pm.Mesh(("data", "model"), (1, 3)), model)
    assert specs["encoder.blocks.0.attn.qkv.weight"] == pm.Shard("model", 0, 3)
    assert specs["encoder.blocks.0.mlp.fc2.weight"] == pm.Shard("model", 1)
    assert specs["encoder.blocks.0.attn.proj.bias"] is None and specs["decoder.0.weight"] is None

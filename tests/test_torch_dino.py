"""The port's DINO training components against the JAX package's, on the
same numpy-made inputs and converted weights: cosine_scheduler exactly;
LARS steps, multi_crop_forward and the DINO head within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ocm_wmsegmentation_tpu.train import dino as jdino
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as ckpt
from vit_ocm_wmsegmentation_tpu_torch.train import dino

from port_helpers import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("args", [
    (1.0, 0.1, 10, 5, 2, 0.0), (0.04, 0.4, 3, 7, 0, 0), (5e-4, 1e-6, 4, 3, 1, 1e-5)])
def test_cosine_scheduler_equals_jax(args):
    np.testing.assert_array_equal(dino.cosine_scheduler(*args), jdino.cosine_scheduler(*args))


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_lars_steps_match_jax(wd):
    """Five LARS steps under a decaying lr on a 2-d weight, a 1-d bias and
    an all-zero weight (trust ratio 1), against the JAX package's optax
    transformation: parameters within 1e-6."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(6, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32),
          "z": np.zeros((3, 3), np.float32)}
    lrs = [0.3, 0.1, 0.05, 0.03, 0.01]
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in lrs]
    tx = jdino.lars(lambda t: jnp.asarray(lrs)[t], momentum=0.9, weight_decay=wd, eta=0.001)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = dino.LARS(list(tp.values()), weight_decay=wd, momentum=0.9, eta=0.001)
    for lr, g in zip(lrs, grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        for group in opt.param_groups:
            group["lr"] = lr
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                   rtol=1e-6)


def test_lars_bias_is_plain_momentum_sgd():
    b = torch.nn.Parameter(torch.zeros(4))
    opt = dino.LARS([b], lr=0.1, weight_decay=1e-4)
    b.grad = torch.ones(4)
    opt.step()
    np.testing.assert_allclose(b.detach().numpy(), -0.1 * np.ones(4), atol=1e-7)


def _head_pair(nlayers, seed=0):
    jparams = jdino.dino_head_init(jax.random.PRNGKey(seed), in_dim=16, out_dim=8,
                                   nlayers=nlayers, hidden_dim=32, bottleneck_dim=12)
    head = dino.DINOHead(16, 8, nlayers, 32, 12)
    head.load_state_dict(ckpt.dino_head_state_from_jax_numpy(jax.tree.map(np.asarray, jparams)))
    return jparams, head


@pytest.mark.parametrize("nlayers", [1, 3])
def test_dino_head_matches_jax(nlayers):
    jparams, head = _head_pair(nlayers)
    x = np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32)
    want = np.asarray(jdino.dino_head_apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_dino_head_state_has_reference_keys_and_weight_norm():
    head = dino.dino_head_init(16, 8, 3, 32, 12, generator=torch.Generator().manual_seed(0))
    assert sorted(head.state_dict()) == sorted(
        ["mlp.0.weight", "mlp.0.bias", "mlp.2.weight", "mlp.2.bias", "mlp.4.weight",
         "mlp.4.bias", "last_layer.weight_g", "last_layer.weight_v"])
    assert not head.last_layer.weight_g.requires_grad
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32))
    with torch.no_grad():
        out = head(x)
        head.last_layer.weight_v.mul_(3.7)  # g v / ||v||: the scale of v drops out
        np.testing.assert_allclose(head(x).numpy(), out.numpy(), atol=1e-6)
    assert float(head.mlp[0].weight.detach().std()) == pytest.approx(0.02, rel=0.2)


def test_multi_crop_forward_matches_jax():
    """Two 16^2 crops and one 8^2 crop: one backbone call per resolution,
    outputs in crop order, then the head (a DINO head on a linear
    backbone), against the JAX package's."""
    rng = np.random.default_rng(2)
    crops = [rng.random((2, 16, 16, 3), dtype=np.float32),
             rng.random((2, 16, 16, 3), dtype=np.float32),
             rng.random((3, 8, 8, 3), dtype=np.float32)]
    w = rng.normal(size=(3, 16)).astype(np.float32)
    jparams, head = _head_pair(3, seed=4)
    calls = []

    def backbone(x):
        calls.append(tuple(x.shape))
        return torch.einsum("bhwc,cd->bd", x, torch.from_numpy(w)) / x.shape[1] ** 2

    with torch.no_grad():
        got = dino.multi_crop_forward(backbone, head, [torch.from_numpy(c) for c in crops]).numpy()
    want = jdino.multi_crop_forward(
        lambda x: jnp.einsum("bhwc,cd->bd", x, jnp.asarray(w)) / x.shape[1] ** 2,
        lambda h: jdino.dino_head_apply(jparams, h), [jnp.asarray(c) for c in crops])
    assert calls == [(4, 16, 16, 3), (3, 8, 8, 3)]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)

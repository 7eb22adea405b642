"""The port's opt-in training routes (TRAIN.ATTN_SAVE_P on, TRAIN.MLP_REMAT
kernel+gp, TRAIN.LN_QKV kernel) against the JAX package's Pallas kernels in
interpret mode and its MIM loss on the same routes.

On CPU tensors the port's wrappers take their plain twins, so these tests
hold the twins' arithmetic, the autograd wiring and the route plumbing
against the JAX package; the CUDA kernels are held against the same twins on
the card (chip_smoke.py, tests/test_torch_cuda.py). Tolerances are relative
to the largest reference value, as in test_torch_train_kernels.py: 1e-4 in
float32, 2e-2 in bfloat16. The JAX package's route globals are set through
monkeypatch only, and its jit caches are cleared around each step test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ocm_wmsegmentation_tpu.models import simmim as jsim
from vit_ocm_wmsegmentation_tpu.models import vit as jvit
from vit_ocm_wmsegmentation_tpu.ops import flash_attention_mod as jfa
from vit_ocm_wmsegmentation_tpu.ops import fused_mlp as jfm
from vit_ocm_wmsegmentation_tpu.ops.ln_linear import ln_linear as jln_linear
from vit_ocm_wmsegmentation_tpu.train.mim_trainer import amp_cast
from vit_ocm_wmsegmentation_tpu_torch import mim
from vit_ocm_wmsegmentation_tpu_torch.models.vit import TrainRoutes
from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as tfa
from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as tfm
from vit_ocm_wmsegmentation_tpu_torch.ops import ln_linear as tln
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as ckpt
from vit_ocm_wmsegmentation_tpu_torch.train import mim_trainer as tmt
from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import train_routes
from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

from port_helpers import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import _batch, _models, _write_images
from test_torch_train_kernels import JDT, TDT, _close, _mlp_arrays, _pair

ALL = TrainRoutes(mlp_save_gp=True, ln_qkv=True, attn_save_p=True)


def _attention_arrays(d, tag, n=130):
    rng = np.random.default_rng(d + 1)
    arrays = [rng.normal(0, 1, (2, 2, n, d)).astype(np.float32) for _ in range(4)]
    return [_pair(a, tag) for a in arrays]


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [63, 65, 127, 129, 130, 257])
def test_savep_function_matches_jax_vjp(n, d, tag):
    """flash_attention_trainable(save_p=True) against the JAX custom VJP on
    its saved-P route, at N on both sides of the kernels' tiles (64 queries
    or keys a tile, 64 or 128 a CTA; the bf16 forward's 128-row CTA and
    64-key tile) and at a ragged N = 130."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _attention_arrays(d, tag, n)
    out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_trainable(q, k, v, 0, True, True),
                       jq, jk, jv)
    want = (out, *vjp(jdo))
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    got = tfa.flash_attention_trainable(tq, tk, tv, save_p=True)
    got.backward(tdo)
    assert got.dtype == tq.grad.dtype == TDT[tag]
    for name, g, w in zip(("out", "dq", "dk", "dv"), (got, tq.grad, tk.grad, tv.grad), want):
        _close(g, w, tag, name)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_savep_residuals_match_jax(tag):
    """P against the TPU kernel's P (true row max, rounded to the storage
    type), its padded columns exactly 0, and inv = 1/denominator."""
    (jq, tq), (jk, tk), (jv, tv), _ = _attention_arrays(64, tag)
    n = tq.shape[2]
    _, jinv, jp = jfa._flash_fwd(jq, jk, jv, 0, True, want_lse=False, want_p=True)
    fold = lambda t: t.reshape(4, n, 64)  # noqa: E731
    out, p, inv = tfa.flash_attention_savep(fold(tq), fold(tk), fold(tv))
    assert p.shape == (4, n, tfa.p_columns(n)) == (4, 130, 192) and p.dtype == TDT[tag]
    assert not p[..., n:].any()
    _close(p[..., :n], np.asarray(jp.astype(jnp.float32))[:, :n, :n], tag, "P")
    _close(inv, np.asarray(jinv)[:, :n, 0], tag, "inv")


def _jax_mlp_args(a, tag):
    names = ("x", "s", "b", "w1", "b1", "w2", "b2")
    jargs, targs = zip(*(_pair(a[k], tag) for k in names))
    targs = list(targs)
    targs[3], targs[5] = targs[3].T.contiguous(), targs[5].T.contiguous()
    return names, jargs, targs


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_gp_function_matches_jax_vjp(tag):
    a = _mlp_arrays(9)
    names, jargs, targs = _jax_mlp_args(a, tag)
    jdo, tdo = _pair(a["do"], tag)
    out, vjp = jax.vjp(
        lambda *p: jfm.fused_mlp_block(*p, 1e-6, jfm.DEFAULT_BLOCK_R, True, True), *jargs)
    want = [out, *vjp(jdo)]
    want[4], want[6] = want[4].T, want[6].T  # dw1, dw2 in the port's layouts
    targs = [t.requires_grad_() for t in targs]
    got = tfm.fused_mlp_block_trainable(*targs, 1e-6, save_gp=True)
    got.backward(tdo)
    assert got.dtype == TDT[tag] and all(t.grad.dtype == TDT[tag] for t in targs)
    for name, g, w in zip(("out",) + tuple("d" + k for k in names), [got] + [t.grad for t in targs],
                          want):
        _close(g, w, tag, name)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_gp_out_is_bit_equal_to_h1_out(tag):
    """The gp forward's out equals the h1 forward's bit for bit; g and gp
    match the JAX kernel's residuals on its want="gp" route."""
    a = _mlp_arrays(10)
    _, jargs, targs = _jax_mlp_args(a, tag)
    out, g, gp = tfm.fused_mlp_block_gp(*targs)
    out_h1, _ = tfm.fused_mlp_block_h1(*targs)
    assert torch.equal(out, out_h1)
    assert g.dtype == gp.dtype == TDT[tag] and g.shape == gp.shape == (70, 256)
    _, jg, jgp = jfm._fwd_impl(*jargs, 1e-6, jfm.DEFAULT_BLOCK_R, True, "gp")
    _close(g, jg[:70], tag, "g")
    _close(gp, jgp[:70], tag, "gp")


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("r,d", [(r, d) for d in (64, 192) for r in (63, 65, 70, 129)]
                         + [(r, d) for d in (192, 384) for r in (127, 129, 257)
                            if (r, d) != (129, 192)])
def test_ln_linear_function_matches_jax_vjp(r, d, tag):
    """ln_linear_trainable: the output and all five gradients against the
    JAX ln_linear custom VJP (interpret mode, row block 64), K = 3 D as the
    qkv projection has it, at rows on both sides of the kernels' 64-row
    tiles and of the bf16 backward's 128-row dx CTA, at both kernel widths."""
    rng = np.random.default_rng(11)
    k = 3 * d
    f = lambda *s, std=1.0, mean=0.0: (rng.normal(size=s) * std + mean).astype(np.float32)  # noqa: E731
    a = {"x": f(r, d, std=2.0, mean=0.5), "s": f(d, std=0.1, mean=1.0), "b": f(d, std=0.1),
         "w": f(d, k, std=d ** -0.5), "bias": f(k, std=0.1), "dy": f(r, k)}
    names = ("x", "s", "b", "w", "bias")
    jargs, targs = zip(*(_pair(a[n], tag) for n in names))
    targs = list(targs)
    targs[3] = targs[3].T.contiguous()  # nn.Linear's (K, D)
    jdy, tdy = _pair(a["dy"], tag)
    out, vjp = jax.vjp(lambda *p: jln_linear(*p, 1e-6, 64, True), *jargs)
    want = [out, *vjp(jdy)]
    want[4] = want[4].T
    targs = [t.requires_grad_() for t in targs]
    got = tln.ln_linear_trainable(*targs, 1e-6)
    got.backward(tdy)
    assert got.dtype == TDT[tag] and all(t.grad.dtype == TDT[tag] for t in targs)
    for name, g, w in zip(("out",) + tuple("d" + n for n in names), [got] + [t.grad for t in targs],
                          want):
        _close(g, w, tag, name)


def test_ln_linear_rounds_once():
    """bf16: y = round(LN(x) W^T + b) with the bias added in f32, not the
    default route's round(round(LN(x) W^T) + b)."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32) * 0.125).bfloat16()
    b = torch.from_numpy(rng.normal(size=128).astype(np.float32)).bfloat16()
    s, bb = torch.ones(64), torch.zeros(64)
    xn = tln.tnn.layer_norm(x, s, bb).float()
    y = tln.ln_linear(x, s, bb, w, b)
    assert torch.equal(y, (xn @ w.float().T + b.float()).bfloat16())
    assert not torch.equal(y, (xn @ w.float().T).bfloat16() + b)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def test_new_wrappers_raise_off_cpu_without_kernel():
    q = _meta(2, 8, 64)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_savep(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_bwd_savep(q, q, q, q, _meta(2, 8, 64), _meta(2, 8), q)
    args = (_meta(4, 384), _meta(384), _meta(384), _meta(1536, 384), _meta(1536),
            _meta(384, 1536), _meta(384))
    with pytest.raises(ValueError, match="no kernel"):
        tfm.fused_mlp_block_gp(*args)
    with pytest.raises(ValueError, match="no kernel"):
        tfm.fused_mlp_bwd_gp(*args[:1], *args[:1], _meta(4, 1536), _meta(4, 1536), *args[1:4],
                             args[5])
    with pytest.raises(ValueError, match="no kernel"):
        tln.ln_linear(args[0], args[1], args[2], _meta(1152, 384), _meta(1152))
    with pytest.raises(ValueError, match="no kernel"):
        tln.ln_linear_bwd(args[0], _meta(4, 1152), args[1], args[2], _meta(1152, 384))


# --- the MIM step on each route -----------------------------------------------------

ROUTES = {"ln_qkv": TrainRoutes(ln_qkv=True), "gp": TrainRoutes(mlp_save_gp=True), "all": ALL}


@pytest.fixture
def jax_routes(monkeypatch):
    """Set the JAX package's route globals for one test, clearing its jit
    caches before and after (the routes are read at trace time). Returns
    what its traced blocks took: the save_gp and save_p arguments of its
    fused-MLP and flash-attention calls and the count of LN_QKV branches."""
    seen = {"save_gp": set(), "save_p": set(), "ln_qkv": 0}

    def spy(mod, name, record):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            record(args)
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    def set_routes(routes):
        monkeypatch.setattr(jvit, "FUSED_MLP_INTERPRET", True)
        monkeypatch.setattr(jvit, "MLP_REMAT", "kernel")
        monkeypatch.setattr(jvit, "LN_QKV", "kernel" if routes.ln_qkv else None)
        monkeypatch.setattr(jfm, "SAVE_GP", routes.mlp_save_gp)
        monkeypatch.setattr(jfa, "SAVE_P", routes.attn_save_p)
        spy(jfm, "fused_mlp_block", lambda a: seen["save_gp"].add(a[10]))
        spy(jfa, "flash_attention_trainable", lambda a: seen["save_p"].add(a[5]))
        spy(jvit, "_ln_qkv_attention", lambda a: seen.__setitem__("ln_qkv", seen["ln_qkv"] + 1))
        jax.clear_caches()
        return seen

    yield set_routes
    jax.clear_caches()


def _port_loss_grads(model, x, mask, amp, routes):
    if amp:
        live = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        loss, _, _ = torch.func.functional_call(
            model, live, (torch.from_numpy(x).bfloat16(), torch.from_numpy(mask), False, routes))
    else:
        loss, _, _ = model(torch.from_numpy(x), torch.from_numpy(mask), False, routes)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip((n for n, _ in model.named_parameters()), grads))


def _gnorm(grads):
    return float(torch.sqrt(sum(g.double().square().sum() for g in grads.values())))


def _assert_step_close(got, want, amp):
    """test_mim_step_matches_jax's tolerances: loss and grad norm to rtol
    1e-4 (f32) / 1e-2 (AMP); every gradient within 1e-4 (f32) / 15 % (AMP,
    where bf16 x_rec within an ulp of x flips the L1 gradient's sign) of
    its tensor's max|g|."""
    (loss, grads), (wloss, wgrads) = got, want
    rtol = 1e-2 if amp else 1e-4
    assert loss == pytest.approx(wloss, rel=rtol)
    assert _gnorm(grads) == pytest.approx(_gnorm(wgrads), rel=rtol)
    frac = 0.15 if amp else 1e-4
    for name, g in grads.items():
        w = wgrads[name]
        err = float((g.float() - w.float()).abs().max())
        assert err <= frac * float(w.float().abs().max()) + 1e-12, f"d{name}: {err:.3e}"


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mim_loss_and_grads_match_jax_on_route(route, amp, jax_routes):
    """The port's MIM loss and gradients on an opt-in route against
    simmim.mim_loss(train=True) with the JAX package on the same route (its
    Pallas kernels in interpret mode)."""
    routes = ROUTES[route]
    jcfg, jparams, model = _models()
    x, mask = _batch()
    seen = jax_routes(routes)

    def jloss_fn(p):
        xx = jnp.asarray(x)
        if amp:
            p, xx = amp_cast(p), xx.astype(jnp.bfloat16)
        return jsim.mim_loss(p, jcfg, xx, jnp.asarray(mask), train=True)[0]

    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams)
    assert seen["save_gp"] == {routes.mlp_save_gp}
    assert bool(seen["ln_qkv"]) == routes.ln_qkv  # the scanned block is traced once
    assert seen["save_p"] == ({routes.attn_save_p} if routes.ln_qkv else set())
    want = {k: v for k, v in ckpt.mim_state_from_jax_numpy(
        jax.tree.map(np.asarray, jgrads), model.cfg).items()}
    got = _port_loss_grads(model, x, mask, amp, routes)
    _assert_step_close(got, (float(jloss), want), amp)


@pytest.mark.parametrize("amp", [False, True])
def test_mim_savep_route_matches_default_route(amp):
    """JAX on the CPU reaches its saved-P backward only through the LN_QKV
    interpret route (held above, route "all"); the saved-P route alone is
    held against the port's own default route."""
    _, _, model = _models()
    x, mask = _batch()
    got = _port_loss_grads(model, x, mask, amp, TrainRoutes(attn_save_p=True))
    want = _port_loss_grads(model, x, mask, amp, TrainRoutes())
    _assert_step_close(got, want, amp)


def test_remat_keeps_gradients_on_every_route():
    """TRAIN.USE_CHECKPOINT with all three routes on: the same loss and
    gradients, bit for bit."""
    _, _, model = _models()
    x, mask = (torch.from_numpy(a) for a in _batch(2))
    out = []
    for remat in (False, True):
        loss, _, _ = model(x, mask, remat, ALL)
        out.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- train_routes and the CLI ------------------------------------------------------


def _routes_cfg(mlp="auto", ln_qkv="auto", save_p="auto"):
    cfg = default_config()
    cfg.TRAIN.MLP_REMAT, cfg.TRAIN.LN_QKV, cfg.TRAIN.ATTN_SAVE_P = mlp, ln_qkv, save_p
    return cfg


@pytest.mark.parametrize("mlp,ln_qkv,save_p,want", [
    ("auto", "auto", "auto", TrainRoutes()),
    ("kernel", "none", "off", TrainRoutes()),
    ("kernel+h1", "auto", "auto", TrainRoutes()),
    ("kernel+gp", "auto", "auto", TrainRoutes(mlp_save_gp=True)),
    ("auto", "kernel", "auto", TrainRoutes(ln_qkv=True)),
    ("auto", "auto", "on", TrainRoutes(attn_save_p=True)),
    ("kernel+gp", "kernel", "on", ALL),
])
def test_train_routes_accepts_the_jax_choices(mlp, ln_qkv, save_p, want):
    assert train_routes(_routes_cfg(mlp, ln_qkv, save_p)) == want


def test_auto_is_the_jax_shipped_default():
    """"auto" gives what the JAX package ships: the MLP kernel saving h1,
    LN_QKV off, the saved P off."""
    assert train_routes(_routes_cfg()) == TrainRoutes()
    assert (jvit._SHIPPED_MLP_REMAT, jvit._SHIPPED_LN_QKV) == ("kernel", None)
    assert (jfm._SHIPPED_SAVE_GP, jfa._SHIPPED_SAVE_P) == (False, False)
    assert (jvit._MLP_REMAT_CHOICES, jvit._LN_QKV_CHOICES, jvit._ATTN_SAVE_P_CHOICES) == (
        tmt.MLP_REMAT_CHOICES, tmt.LN_QKV_CHOICES, tmt.ATTN_SAVE_P_CHOICES)


@pytest.mark.parametrize("key,value", [("MLP_REMAT", "kernel+xyz"), ("LN_QKV", "on"),
                                       ("ATTN_SAVE_P", "kernel")])
def test_train_routes_rejects_unknown_values(key, value):
    cfg = _routes_cfg()
    cfg.TRAIN[key] = value
    with pytest.raises(ValueError, match=f"TRAIN.{key}"):
        train_routes(cfg)


def test_mim_cli_trains_one_epoch_on_every_route(tmp_path):
    src = _write_images(tmp_path / "imgs", 8)
    args = ["--image_path", src, "--image_size", "32", "--mask_patch_size", "8",
            "--batch_size", "4", "--warmup_epochs", "1", "--epochs", "1", "--device", "cpu",
            "--output", str(tmp_path / "out"), "--output_dir", str(tmp_path / "log"),
            "--opts", "TRAIN.LN_QKV", "kernel", "TRAIN.ATTN_SAVE_P", "on",
            "TRAIN.MLP_REMAT", "kernel+gp"]
    _, hist = mim.main(args)
    assert len(hist) == 1 and np.isfinite(hist).all()
    log = "".join(p.read_text() for p in (tmp_path / "log").rglob("*.txt"))
    assert "MLP_REMAT=kernel+gp LN_QKV=kernel ATTN_SAVE_P=True" in log

"""The port's Swin classifier and its training loop against the JAX package
(and the Swin against a HF transformers model built here), on identical
weights and numpy-made inputs.

The port never imports transformers; only this test does, to build the
oracle and its state dict. Tolerances: f32 logits within 3e-5 (the JAX
package's own HF parity bound), f32 training within rtol 1e-5 (loss) and
2e-5 * max(1, max|p|) (parameters), AMP (bf16 compute) within 1e-2.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu.models import swin as jswin
from vit_ocm_wmsegmentation_tpu.train import classifier as jcls
from vit_ocm_wmsegmentation_tpu_torch import allen_train
from vit_ocm_wmsegmentation_tpu_torch.models import swin
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as ckpt
from vit_ocm_wmsegmentation_tpu_torch.train import classifier as cls

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

GEOM = dict(img_size=32, patch_size=4, embed_dim=24, depths=(2, 2), num_heads=(2, 4), window=4,
            num_classes=3)


def _port_from_jax(jparams, cfg):
    model = swin.Swin(cfg)
    model.load_state_dict(ckpt.swin_state_from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg))
    return model


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jswin.SwinConfig(**GEOM), swin.SwinConfig(**GEOM)
    jparams = jswin.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, _port_from_jax(jparams, cfg)


def _x(n=2, size=32, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def test_swin_logits_match_jax(pair):
    jcfg, jparams, cfg, model = pair
    x = _x()
    want = np.asarray(jswin.apply(jparams, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = swin.apply(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("hf_geom", [
    dict(image_size=32, embed_dim=24, depths=[2, 2], num_heads=[2, 4], window_size=4),
    # all 4 stages and 3 patch merges of swin-tiny's topology, window 4
    dict(image_size=128, embed_dim=24, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24],
         window_size=4),
], ids=["2-stage", "tiny-topology"])
def test_swin_loads_hf_state_dict_and_matches_hf(tmp_path, hf_geom):
    """A HF SwinForImageClassification's state dict loads strictly into the
    port's Swin (keys and shapes equal), also from a local file through
    load_hf_swin, and the logits agree within 3e-5."""
    from transformers import SwinConfig as HFConfig, SwinForImageClassification

    torch.manual_seed(0)
    hf = SwinForImageClassification(HFConfig(
        patch_size=4, num_labels=4, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0, **hf_geom)).eval()
    cfg = swin.SwinConfig(img_size=hf_geom["image_size"], patch_size=4,
                          embed_dim=hf_geom["embed_dim"], depths=tuple(hf_geom["depths"]),
                          num_heads=tuple(hf_geom["num_heads"]), window=hf_geom["window_size"],
                          num_classes=4)
    model = swin.Swin(cfg)
    model.load_state_dict(hf.state_dict())
    torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    from_file = ckpt.load_hf_swin(str(tmp_path), swin.init(cfg, torch.Generator().manual_seed(1)))
    x = _x(1, cfg.img_size, 2)
    with torch.no_grad():
        want = hf(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits.numpy()
        got = swin.apply(model, torch.from_numpy(x)).numpy()
        got_file = swin.apply(from_file, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_array_equal(got_file, got)


def test_load_hf_swin_keeps_a_mismatched_head(tmp_path, pair):
    """Another class count (HF's ignore_mismatched_sizes): the classifier
    keeps the model's init, every other tensor comes from the file; an
    unexpected key raises."""
    _, _, cfg, model = pair
    sd = model.state_dict()
    other = swin.init(swin.SwinConfig(**{**GEOM, "num_classes": 5}),
                      torch.Generator().manual_seed(3))
    head = other.classifier.weight.detach().clone()
    torch.save(sd, tmp_path / "w.pth")
    ckpt.load_hf_swin(str(tmp_path / "w.pth"), other)
    assert torch.equal(other.classifier.weight, head)
    assert torch.equal(other.swin.layernorm.weight, sd["swin.layernorm.weight"])
    torch.save({**sd, "swin.extra": torch.zeros(1)}, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="unexpected"):
        ckpt.load_hf_swin(str(tmp_path / "bad.pth"), other)


def test_window_helpers_match_jax():
    for w in (2, 4, 7):
        np.testing.assert_array_equal(swin.relative_position_index(w),
                                      jswin.relative_position_index(w))
    for res, w, shift in ((8, 4, 2), ((14, 21), 7, 3), (56, 7, 3)):
        np.testing.assert_array_equal(swin.shifted_window_mask(res, w, shift),
                                      jswin.shifted_window_mask(res, w, shift))
    x = np.random.default_rng(1).random((2, 8, 12, 5), dtype=np.float32)
    part = swin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(part.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(swin.window_reverse(part, 4, 8, 12).numpy(), x)


def test_swin_odd_resolution_pads_like_jax():
    """A 36^2 image: 9 x 9 tokens, windows of 4 padded, an odd patch merge."""
    geom = {**GEOM, "img_size": 36}
    jcfg, cfg = jswin.SwinConfig(**geom), swin.SwinConfig(**geom)
    jparams = jswin.init(jcfg, jax.random.PRNGKey(4))
    model = _port_from_jax(jparams, cfg)
    x = _x(1, 36, 5)
    want = np.asarray(jswin.apply(jparams, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = swin.apply(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_swin_init_distributions():
    cfg = swin.SwinConfig(**GEOM)
    model = swin.init(cfg, torch.Generator().manual_seed(0))
    lin = model.swin.encoder.layers[0].blocks[0].intermediate.dense
    assert float(lin.weight.detach().abs().max()) <= 1 / np.sqrt(24)
    red = model.swin.encoder.layers[0].downsample.reduction
    assert red.bias is None and float(red.weight.detach().abs().max()) <= 1 / np.sqrt(96)
    table = model.swin.encoder.layers[0].blocks[0].attention.self.relative_position_bias_table
    assert 0.01 < float(table.detach().std()) < 0.03
    assert all(p.requires_grad for p in model.parameters())


def test_hf_linear_schedule_matches_jax():
    fn, jfn = cls.hf_linear_schedule(1e-3, 100), jcls.hf_linear_schedule(1e-3, 100)
    for t in (0, 1, 5, 10, 11, 55, 99, 100, 120):
        assert fn(t) == pytest.approx(float(jfn(t)), rel=1e-6, abs=1e-12)


def test_accumulated_adamw_matches_optax_multisteps():
    """Three updates of k = 3 micro-steps (and one micro-step left over)
    against optax.MultiSteps(optax.adamw(schedule, weight_decay=0), 3),
    parameters within 1e-5 (updates of ~lr = 0.1, rounded in another
    order by torch's AdamW)."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(4, 5)).astype(np.float32)
    grads = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(10)]
    sched = cls.hf_linear_schedule(0.1, 4)
    tx = optax.MultiSteps(optax.adamw(jcls.hf_linear_schedule(0.1, 4), weight_decay=0.0),
                          every_k_schedule=3)
    jp = {"w": jnp.asarray(p0)}
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = cls.AccumulatedAdamW([p], sched, 3)
    for i, g in enumerate(grads):
        upd, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        applied = opt.step([torch.from_numpy(g)])
        assert applied == (i % 3 == 2)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["w"]), atol=1e-5, rtol=1e-5)
    assert opt.updates == 3 and opt.mini == 1


def _class_batches(n_batches, seed, size=32, bsz=4):
    """epoch -> batches of two classes (bright / dark images), the same
    numpy arrays for both packages."""

    def gen(epoch):
        rng = np.random.default_rng((seed, epoch))
        for _ in range(n_batches):
            y = rng.integers(0, 3, bsz).astype(np.int32)
            x = (0.2 + 0.3 * y[:, None, None, None]
                 + rng.normal(0, 0.05, (bsz, size, size, 3))).astype(np.float32)
            yield x, y

    return gen


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_train_classifier_matches_jax(pair, amp, monkeypatch):
    """Three epochs of 3 micro-batches with grad_accum 2: updates land at
    micro-steps 2, 4, 6 and 8, so the step at 4 carries epoch 0's last
    micro-batch into epoch 1. Per-epoch train losses and eval accuracies
    against the JAX loop (rtol 1e-5 f32, 1e-2 AMP); with no eval data the
    accuracy is 0 and the best weights are those after epoch 0, held
    against JAX's (2e-5 f32, 1e-2 AMP, times max(1, max|p|)). Adam's eps is
    raised to 1e-3 in both packages (as tests/test_torch_train.py does): with
    1e-8 a gradient that is 0 up to rounding (the key biases', which the
    softmax cancels) or below 1e-8 turns f32 noise into steps of up to lr."""
    jcfg, jparams, cfg, _ = pair
    model = _port_from_jax(jparams, cfg)
    kw = dict(epochs=3, lr=1e-3, grad_accum=2, steps_per_epoch=3, logger=lambda *_: None, amp=amp)
    empty = lambda epoch: iter(())  # noqa: E731
    monkeypatch.setattr(jcls.optax, "adamw", functools.partial(optax.adamw, eps=1e-3))
    monkeypatch.setattr(torch.optim, "AdamW", functools.partial(torch.optim.AdamW, eps=1e-3))
    # a copy: the JAX step donates its parameter buffers
    jbest, jhist = jcls.train_classifier(lambda p, x: jswin.apply(p, jcfg, x),
                                         jax.tree.map(jnp.copy, jparams),
                                         _class_batches(3, 1), empty, **kw)
    model, hist = cls.train_classifier(model, _class_batches(3, 1), empty, **kw)
    rtol = 1e-2 if amp else 1e-5
    for h, jh in zip(hist, jhist):
        assert h["train_loss"] == pytest.approx(jh["train_loss"], rel=rtol)
        assert h["eval_accuracy"] == jh["eval_accuracy"] == 0.0
    want = ckpt.swin_state_from_jax_numpy(jax.tree.map(np.asarray, jbest), cfg)
    tol = 1e-2 if amp else 2e-5
    for k, w in want.items():
        err = float((model.state_dict()[k].float() - w.float()).abs().max())
        assert err <= tol * max(1.0, float(w.float().abs().max())), f"{k}: {err:.3e}"
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_train_classifier_keeps_best_accuracy(pair):
    """A tiny Swin learns three brightness classes; the best epoch's
    accuracy is kept and its weights loaded back."""
    _, _, cfg, _ = pair
    model = swin.init(cfg, torch.Generator().manual_seed(0))
    model, hist = cls.train_classifier(model, _class_batches(6, 2), _class_batches(2, 3),
                                       epochs=4, lr=2e-3, grad_accum=1, steps_per_epoch=6,
                                       logger=lambda *_: None)
    best = max(h["eval_accuracy"] for h in hist)
    epoch = next(h["epoch"] for h in hist if h["eval_accuracy"] == best)  # the first best
    assert best >= 0.75
    correct = total = 0
    with torch.no_grad():
        for x, y in _class_batches(2, 3)(epoch):
            correct += int((swin.apply(model, torch.from_numpy(x)).argmax(-1).numpy() == y).sum())
            total += len(y)
    assert correct / total == best


def _imagefolder(root, n_per_class=5, size=40):
    rng = np.random.default_rng(0)
    for c, level in (("dark", 50), ("bright", 200)):
        os.makedirs(root / c)
        for i in range(n_per_class):
            a = np.clip(level + rng.normal(0, 20, (size, size, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(a).save(root / c / f"{i}.png")
    return str(root)


def test_allen_cli_matches_root_script(tmp_path, monkeypatch, capsys):
    """The port's CLI and Allen_data_Backbone/train.py on the same
    imagefolder from scratch at 32^2: the same split and batches, each
    epoch's train loss within rtol 1e-4 (the two inits differ: the port's
    weights are converted from the JAX package's seed-0 init for this
    comparison), the files written."""
    import importlib.util
    import sys

    data = _imagefolder(tmp_path / "data")
    root_py = os.path.join(os.path.dirname(__file__), "..", "Allen_data_Backbone", "train.py")
    spec = importlib.util.spec_from_file_location("allen_root_train", root_py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["--data_path", data, "--image_size", "32", "--epochs", "2", "--batch_size", "2",
            "--from_scratch"]
    captured = {}

    def jax_train(apply_fn, params, tb, eb, **kw):
        captured["jparams"] = jax.tree.map(np.array, params)  # before donation
        out = jcls.train_classifier(apply_fn, params, tb, eb, logger=lambda *_: None, **kw)
        captured["jhist"] = out[1]
        return out

    monkeypatch.setattr(mod, "train_classifier", jax_train)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv, "--output_dir", str(tmp_path / "root")])
    mod.main()
    cfg = swin.SwinConfig(img_size=32, num_classes=2)
    monkeypatch.setattr(allen_train.swin, "init",
                        lambda c, g=None, device=None: _port_from_jax(captured["jparams"], cfg))
    model, hist = allen_train.main([*argv, "--output_dir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    for h, jh in zip(hist, captured["jhist"]):
        assert h["train_loss"] == pytest.approx(jh["train_loss"], rel=1e-4)
        assert h["eval_accuracy"] == jh["eval_accuracy"]
    saved = json.load(open(tmp_path / "port" / "history.json"))
    assert saved["classes"] == ["bright", "dark"] and len(saved["history"]) == 2
    state = torch.load(tmp_path / "port" / "ckpt_epoch_0", weights_only=False)
    assert set(state["model"]) == set(model.state_dict())
    assert "saved best checkpoint" in capsys.readouterr().out


def test_allen_cli_pretrained_local_file_and_fallback(tmp_path, capsys):
    """--model_name as a local HF-layout file initializes the model from it
    (the classifier of another class count keeps its init); a name that is
    no local file falls back to training from scratch; nothing downloads."""
    data = _imagefolder(tmp_path / "data", 3)
    cfg = swin.SwinConfig(img_size=32, num_classes=7)
    src = swin.init(cfg, torch.Generator().manual_seed(9))
    torch.save(src.state_dict(), tmp_path / "pytorch_model.bin")
    argv = ["--data_path", data, "--image_size", "32", "--epochs", "1", "--batch_size", "2",
            "--device", "cpu", "--output_dir", str(tmp_path / "out")]
    allen_train.main([*argv, "--model_name", str(tmp_path)])
    assert f"initialized from {tmp_path}" in capsys.readouterr().out
    allen_train.main([*argv, "--model_name", "no/such-model"])
    assert "training from scratch" in capsys.readouterr().out


def test_allen_cli_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        allen_train.main(["--data_path", str(tmp_path)])

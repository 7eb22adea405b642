"""The port's supervised training pieces against the JAX package's, on
identical weights (carried across by train/checkpoint's converters) and
numpy-made inputs: the conv / BN / pool layers, the UNet and LinearProbing
forwards, one train step, the PGT teacher, the cv2-exact loader, the
plateau schedule, the splits and the test pass.

Tolerances: forwards within atol 1e-5; one Adam step's loss and parameters
within 1e-5 (eps raised to 1e-3 in both packages, as tests/test_torch_train.py
does: with 1e-8 Adam's first step is lr * sign(g), so a gradient that is 0
up to rounding, like a conv bias before BatchNorm, moves by 2 lr); the
teacher's masks, the loader's bytes, the plateau rates and the splits
exactly; the test-pass metrics within 1e-6.
"""

import glob
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from vit_ocm_wmsegmentation_tpu import nn as jnn
from vit_ocm_wmsegmentation_tpu.models import probing as jprobing
from vit_ocm_wmsegmentation_tpu.models import unet as junet
from vit_ocm_wmsegmentation_tpu.models import vit as jvit
from vit_ocm_wmsegmentation_tpu.models.vit import ViTConfig as JViTConfig
from vit_ocm_wmsegmentation_tpu.train import checkpoint as jckpt
from vit_ocm_wmsegmentation_tpu.train import supervised as jsup
from vit_ocm_wmsegmentation_tpu_torch import nn as tnn
from vit_ocm_wmsegmentation_tpu_torch.models import probing, unet
from vit_ocm_wmsegmentation_tpu_torch.models import vit as tvit
from vit_ocm_wmsegmentation_tpu_torch.models.vit import ViTConfig
from vit_ocm_wmsegmentation_tpu_torch.train import checkpoint as ckpt
from vit_ocm_wmsegmentation_tpu_torch.train import supervised as sup

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

GEOM = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
JCFG, CFG = JViTConfig(**GEOM), ViTConfig(**GEOM)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _x(n, size, seed, c=3):
    return np.random.default_rng(seed).random((n, size, size, c), dtype=np.float32)


def _probing_pair(layer_num, seed=0):
    jparams = jprobing.init(JCFG, jax.random.PRNGKey(seed), layer_num=layer_num)
    model = probing.LinearProbing(CFG, layer_num)
    model.load_state_dict(ckpt.probing_state_from_jax_numpy(_np_tree(jparams), CFG, layer_num))
    return jparams, model


def _unet_pair(seed=0):
    jparams, jstate = junet.init(jax.random.PRNGKey(seed))
    model = unet.UNet()
    model.load_state_dict(ckpt.unet_state_from_jax_numpy(_np_tree(jparams), _np_tree(jstate)))
    return jparams, jstate, model


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# nn layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (4, 4)])
def test_conv2d_matches_jax(k, stride):
    rng = np.random.default_rng(k)
    p = jnn.conv2d_init(jax.random.PRNGKey(k), k, k, 5, 7)
    x = rng.random((2, 16, 16, 5), dtype=np.float32)
    pad = "SAME" if stride == 1 else "VALID"
    want = jnn.conv2d(p, jnp.asarray(x), stride=stride, padding=pad)
    conv = torch.nn.Conv2d(5, 7, k, stride=stride)
    sd = ckpt._conv_from_hwio(_np_tree(p), "c")  # noqa: SLF001
    conv.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    with torch.no_grad():
        got = tnn.nhwc(F.conv2d(tnn.nchw(torch.from_numpy(x)), conv.weight, conv.bias, stride,
                                "same" if stride == 1 else "valid"))
    _close(got, want)


def test_conv_transpose_weight_round_trip_and_flip():
    """A torch ConvTranspose2d weight through the JAX package's converter
    (spatially flipped HWIO) and back through the port's gives the same
    bits, and both packages compute the same output. Without the flip the
    converted kernel loads cleanly and computes something else."""
    torch.manual_seed(0)
    conv = torch.nn.ConvTranspose2d(6, 4, 2, stride=2)
    sd = {"up.weight": conv.weight.detach(), "up.bias": conv.bias.detach()}
    jp = jckpt._conv_transpose_from_torch(sd, "up")  # noqa: SLF001
    back = ckpt._conv_transpose_from_hwio(_np_tree(jp), "up")  # noqa: SLF001
    assert torch.equal(back["up.weight"], conv.weight.detach())
    x = _x(2, 5, 1, 6)
    want = jnn.conv_transpose2d(jp, jnp.asarray(x), stride=2)
    with torch.no_grad():
        got = tnn.nhwc(F.conv_transpose2d(tnn.nchw(torch.from_numpy(x)), conv.weight, conv.bias, 2))
    _close(got, want)
    unflipped = {"kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 0, 1)),
                 "bias": jp["bias"]}
    assert np.abs(np.asarray(jnn.conv_transpose2d(unflipped, jnp.asarray(x))) -
                  got.numpy()).max() > 1e-2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batch_norm_train_eval_and_running_state_match_jax(dtype):
    """Training normalizes with the batch's biased variance and moves the
    running statistics with the unbiased one (momentum 0.1); eval uses
    them. Statistics in f32 for a bf16 input too."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 6, 5, 4)) * 2 + 1).astype(np.float32)
    jp, js = jnn.batch_norm_init(4)
    jp = {"scale": jnp.asarray(rng.normal(size=4).astype(np.float32)),
          "bias": jnp.asarray(rng.normal(size=4).astype(np.float32))}
    bn = torch.nn.BatchNorm2d(4)
    tnn.batch_norm_init(bn)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(jp["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(jp["bias"])))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xt = tnn.nchw(torch.from_numpy(x).to(tdt))
    for train in (True, True, False):
        want, js = jnn.batch_norm(jp, js, jnp.asarray(x).astype(jdt), train=train)
        with torch.no_grad():
            got = tnn.nhwc(tnn.batch_norm(xt, bn, train))
        assert got.dtype == tdt
        _close(got.float(), want.astype(jnp.float32), 1e-5 if dtype == "f32" else 2e-2)
        _close(bn.running_mean, js["mean"], 1e-6)
        _close(bn.running_var, js["var"], 1e-6)
        assert int(bn.num_batches_tracked) == int(js["count"])
        assert bn.running_mean.dtype == torch.float32


def test_max_pool_matches_jax():
    """The UNet's F.max_pool2d(2, 2) on the NCHW view of an NHWC batch."""
    x = _x(2, 8, 4, 3)
    want = jnn.max_pool2d(jnp.asarray(x))
    got = tnn.nhwc(F.max_pool2d(tnn.nchw(torch.from_numpy(x)), 2, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_init_fan_in_counts_torch_s_way():
    """Conv2d's bound is 1/sqrt(Cin kh kw); ConvTranspose2d's 1/sqrt(Cout kh
    kw) (torch's fan-in of a (Cin, Cout, kh, kw) weight), as the JAX
    package's inits."""
    g = torch.Generator().manual_seed(0)
    conv, up = torch.nn.Conv2d(16, 8, 3), torch.nn.ConvTranspose2d(64, 4, 2, 2)
    tnn.conv_init(conv, g)
    tnn.conv_init(up, g)
    assert float(conv.weight.detach().abs().max()) <= 1 / np.sqrt(16 * 9)
    assert float(up.bias.detach().abs().max()) <= 1 / np.sqrt(4 * 4)
    assert float(up.weight.detach().abs().max()) > 1 / np.sqrt(64 * 4)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def test_unet_forward_train_and_eval_match_jax():
    """The UNet at 32^2: train mode (batch statistics, the running ones
    updated) then eval (running statistics), atol 1e-5; the running state
    after the training forward equals JAX's new state."""
    jparams, jstate, model = _unet_pair(0)
    x = _x(2, 32, 5)
    want, jnew = junet.apply(jparams, jstate, jnp.asarray(x), train=True)
    got = unet.apply(model, torch.from_numpy(x), True)
    _close(got.detach(), want)
    sd = ckpt.unet_state_from_jax_numpy(_np_tree(jparams), _np_tree(jnew))
    for k, v in model.state_dict().items():
        if "running" in k or "num_batches" in k:
            _close(v, sd[k], 1e-6)
    want_eval, _ = junet.apply(jparams, jnew, jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(unet.apply(model, torch.from_numpy(x), False), want_eval)


def test_unet_has_the_reference_keys():
    keys = set(unet.UNet().state_dict())
    for k in ("e1.conv.conv1.weight", "e4.conv.bn2.running_var", "b.conv1.weight",
              "b.bn2.num_batches_tracked", "d1.up.weight", "d4.conv.conv2.bias",
              "outputs.weight"):
        assert k in keys
    assert unet.UNet().d1.up.weight.shape == (1024, 512, 2, 2)


@pytest.mark.parametrize("layer_num", [1, 2])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_probing_forward_matches_jax(layer_num, train):
    """LinearProbing at 32^2, depth 2: the training forward (training
    kernels' twins) and the eval forward (inference routes' twins) within
    atol 1e-5 of JAX's apply."""
    jparams, model = _probing_pair(layer_num, 1)
    x = _x(2, 32, 6)
    want, _ = jprobing.apply(jparams, JCFG, jnp.asarray(x), layer_num=layer_num, train=train)
    with torch.set_grad_enabled(train):
        got = probing.apply(model, torch.from_numpy(x), train)
    assert got.shape == (2, 32, 32, 1)
    _close(got.detach(), want)


def test_probing_keys_and_reference_load(tmp_path):
    """The reference's keys, and a reference-layout .pth (module. prefixes,
    a "model" dict) loads strictly; the positional table of another size
    is taken at the checkpoint's size."""
    _, model = _probing_pair(2)
    keys = set(model.state_dict())
    assert {"two_layer_decoder.0.weight", "two_layer_decoder.1.running_mean",
            "two_layer_decoder.3.bias", "encoder.blocks.1.attn.qkv.weight"} <= keys
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "ref.pth")
    other = probing.init(CFG, torch.Generator().manual_seed(5), layer_num=2)
    ckpt.load_reference_checkpoint(str(tmp_path / "ref.pth"), other)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v)
    big = probing.init(probing.finetune_vit_config(64, 8), torch.Generator().manual_seed(1))
    vit_sd = tvit.init(tvit.VIT_SMALL(patch_size=8)).state_dict()  # a 224^2 table
    ckpt.load_vit_state(big.encoder, vit_sd)
    assert big.encoder.pos_embed.shape == (1, 785, 384)
    with torch.no_grad():
        assert probing.apply(big, torch.zeros(1, 64, 64, 3)).shape == (1, 64, 64, 1)


def test_unet_reference_checkpoint_loads(tmp_path):
    _, _, model = _unet_pair(2)
    torch.save({"teacher": model.state_dict()}, tmp_path / "unet.pth")
    other = unet.init(torch.Generator().manual_seed(0))
    ckpt.load_reference_checkpoint(str(tmp_path / "unet.pth"), other)
    # and the JAX package reads the same file into its own tree
    jp, js = jckpt.unet_params_from_torch(torch.load(tmp_path / "unet.pth"))
    back = ckpt.unet_state_from_jax_numpy(_np_tree(jp), _np_tree(js))
    for k, v in other.state_dict().items():
        assert torch.equal(back[k].to(v.dtype), v), k


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _jax_step(apply_fn, params, state, x, y, lr):
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=lr, eps=1e-3)
    train_step, eval_step = jsup.make_seg_step(apply_fn, tx)
    opt_state = tx.init(params)
    params, state, _, loss = train_step(jax.tree.map(jnp.copy, params), state, opt_state, lr,
                                        jnp.asarray(x), jnp.asarray(y))
    return params, state, float(loss), float(eval_step(params, state, jnp.asarray(x),
                                                       jnp.asarray(y)))


def _port_step(apply_fn, model, x, y, lr):
    adam = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr, eps=1e-3)
    train_step, eval_step = sup.make_seg_step(apply_fn, model, adam)
    dt = next(model.parameters()).dtype
    x, y = torch.from_numpy(x).to(dt), torch.from_numpy(y).to(dt)
    return float(train_step(x, y, lr)), float(eval_step(x, y))


def _labels(n, size, seed):
    return (np.random.default_rng(seed).random((n, size, size, 1)) > 0.5).astype(np.float32)


def test_seg_step_probing_matches_jax():
    """One Adam step of the 2-layer LinearProbing on the Dice loss (training
    kernels' twins, BN in train mode), then the eval loss: losses and every
    parameter and BN buffer within 1e-5."""
    jparams, model = _probing_pair(2, 3)
    x, y = _x(2, 32, 7), _labels(2, 32, 8)
    state = jparams.pop("state")

    def japply(p, s, xx, train):
        return jprobing.apply(dict(p, state=s), JCFG, xx, layer_num=2, train=train)

    jp, js, jloss, jeval = _jax_step(japply, jparams, state, x, y, 1e-3)
    loss, evl = _port_step(probing.apply, model, x, y, 1e-3)
    assert loss == pytest.approx(jloss, abs=1e-5) and evl == pytest.approx(jeval, abs=1e-5)
    want = ckpt.probing_state_from_jax_numpy(_np_tree(dict(jp, state=js)), CFG, 2)
    for k, v in model.state_dict().items():
        _close(v.detach().float(), want[k].float(), 1e-5)


def test_seg_step_unet_matches_jax():
    """One UNet step: the loss in f32 within 1e-5 of JAX's; the updated
    parameters and BN buffers of the port's f32 step within 1e-5 of JAX's f32
    step, except the 17 parameters that two near-ties reach; and every tensor
    of the port's step run in float64 within 1e-5 of JAX's f32 step.

    In f32 both packages round the activations, and at this seed (one torch
    thread) two of them lie within rounding of a branch: a max-pool window
    after e2 whose two largest values are 0.556698 and 0.556700, and the
    pre-ReLU value of d3.conv.bn1 at image 0, channel 58, pixel (15, 7):
    5.7e-6 in float64, -3.0e-7 in the port's f32. Each routes its gradient by
    that rounding. The pool's reaches only the parameters upstream of it,
    e1's and e2's (their f32 updates differ by up to 2e-4); the ReLU's
    reaches d3.conv.conv1.weight's output channel 58 (2.6e-5) and, below
    1e-5, what lies upstream. Adam's first step with eps 1e-3 passes a
    gradient's difference on nearly whole where the gradient is small. The BN
    running statistics come from the forward and are held. Float64 on the
    port's side leaves only JAX's rounding, so there every tensor is held."""
    jparams, jstate, model = _unet_pair(4)
    x, y = _x(2, 32, 9), _labels(2, 32, 10)
    jp, js, jloss, jeval = _jax_step(lambda p, s, xx, train: junet.apply(p, s, xx, train=train),
                                     jparams, jstate, x, y, 1e-3)
    model64 = unet.UNet().double()
    model64.load_state_dict(model.state_dict())
    loss, evl = _port_step(unet.apply, model, x, y, 1e-3)
    assert loss == pytest.approx(jloss, abs=1e-5) and evl == pytest.approx(jeval, abs=1e-5)
    _port_step(unet.apply, model64, x, y, 1e-3)
    want = ckpt.unet_state_from_jax_numpy(_np_tree(jp), _np_tree(js))
    near_ties = {k for k, _ in model.named_parameters() if k.startswith(("e1.", "e2."))}
    near_ties.add("d3.conv.conv1.weight")
    held = [k for k in model.state_dict() if k not in near_ties]
    assert len(near_ties) == 17 and len(held) == len(want) - 17
    for k in held:
        _close(model.state_dict()[k].detach().float(), want[k].float(), 1e-5)
    for k, v in model64.state_dict().items():
        _close(v.detach().float(), want[k].float(), 1e-5)


def test_frozen_encoder_gets_no_update():
    """--finetune False: the encoder requires no gradient, the optimizer
    holds only the decoder, and a step leaves the encoder's bits alone."""
    _, model = _probing_pair(1, 5)
    model.encoder.requires_grad_(False)
    before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    _port_step(probing.apply, model, _x(2, 32, 1), _labels(2, 32, 2), 1e-2)
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, before[k])
    assert len(sup.make_adam(model, 1e-3).param_groups[0]["params"]) == 2


# ---------------------------------------------------------------------------
# PGT teacher
# ---------------------------------------------------------------------------


def test_pil_luma_matches_jax_and_pil():
    arr = np.random.default_rng(1).random((2, 8, 8, 3)).astype(np.float32)
    got = sup.pil_luma(torch.from_numpy(arr)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsup._pil_l_from_float(jnp.asarray(arr))))
    want = np.asarray(Image.fromarray((arr[0] * 255).astype(np.uint8), "RGB").convert("L"))
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("seed", [0, 1])
def test_teacher_pseudo_labels_equal_jax(seed):
    """The fused teacher on a batch of 3 images at 48^2 (depth 2): masks
    bit-equal to the JAX package's."""
    jteacher = jvit.init(JCFG, jax.random.PRNGKey(seed))
    teacher = tvit.ViT(CFG)
    teacher.load_state_dict(ckpt.vit_state_from_jax_numpy(_np_tree(jteacher), CFG))
    x = _x(3, 48, 10 + seed)
    want = np.asarray(jsup.teacher_pseudo_labels(jteacher, JCFG, jnp.asarray(x)))
    got = sup.teacher_pseudo_labels(teacher, torch.from_numpy(x))
    assert got.shape == (3, 48, 48, 1) and not got.is_inference()
    np.testing.assert_array_equal(got.numpy(), want)


def test_head_subset_weights_match_jax_formula():
    """The rand mode's weights for the same draws as JAX's
    (arange(nh) < num)[argsort(order)]; each image averages num heads."""
    rng = np.random.default_rng(0)
    for nh in (1, 3, 6):
        for _ in range(5):
            num, order = int(rng.integers(1, nh + 1)), rng.permutation(nh)
            want = (jnp.arange(nh) < num).astype(jnp.float32)[jnp.argsort(jnp.asarray(order))]
            got = sup.head_subset_weights(num, torch.from_numpy(order), nh)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert float(got.sum()) == num


def test_teacher_rand_mode_properties():
    """Binary masks, reproducible from the generator's seed; with one head
    every subset is that head, so the masks equal the all-heads path's."""
    x = torch.from_numpy(_x(2, 32, 3))
    teacher = tvit.init(CFG, torch.Generator().manual_seed(2))
    a = sup.teacher_pseudo_labels(teacher, x, torch.Generator().manual_seed(7))
    b = sup.teacher_pseudo_labels(teacher, x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and set(np.unique(a.numpy())) <= {0.0, 1.0}
    one = tvit.init(ViTConfig(**{**GEOM, "num_heads": 1}), torch.Generator().manual_seed(2))
    assert torch.equal(sup.teacher_pseudo_labels(one, x, torch.Generator().manual_seed(1)),
                       sup.teacher_pseudo_labels(one, x))


# ---------------------------------------------------------------------------
# loader, schedule, splits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """PNGs in the modes a dataset may hold: RGB, grey, RGBA, palette,
    grey+alpha, 16-bit grey; odd sizes."""
    root = tmp_path_factory.mktemp("modes")
    rng = np.random.default_rng(0)
    paths = []
    for i, (mode, hw) in enumerate([("RGB", (37, 53)), ("L", (64, 64)), ("RGBA", (20, 30)),
                                    ("P", (50, 41)), ("LA", (33, 33)), ("I;16", (45, 60)),
                                    ("RGB", (512, 384))]):
        a = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        if mode == "I;16":
            im = Image.fromarray(rng.integers(0, 65536, hw).astype(np.uint16))
        else:
            im = Image.fromarray(a).convert(mode)
        p = str(root / f"{i}_{mode.replace(';', '')}.png")
        im.save(p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("size", [32, 48, 64, (40, 24), 100, 384])
def test_loader_bytes_equal_cv2(image_files, size):
    """cv2.resize(cv2.imread(p, IMREAD_COLOR), (w, h)) and the grayscale
    masks (INTER_LINEAR and INTER_NEAREST), byte for byte."""
    h, w = (size, size) if isinstance(size, int) else size
    for p in image_files:
        want = cv2.resize(cv2.imread(p, cv2.IMREAD_COLOR), (w, h))
        np.testing.assert_array_equal(sup.read_image_u8(p, size), want, err_msg=p)
        g = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(sup.read_mask_u8(p, size), cv2.resize(g, (w, h)), err_msg=p)
        np.testing.assert_array_equal(
            sup.read_mask_u8(p, size, nearest=True),
            cv2.resize(g, (w, h), interpolation=cv2.INTER_NEAREST), err_msg=p)


def test_resize_linear_u8_equals_cv2_on_random_shapes():
    rng = np.random.default_rng(1)
    for _ in range(60):
        sh, sw, h, w = (int(v) for v in rng.integers(2, 200, 4))
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        np.testing.assert_array_equal(sup.resize_linear_u8(img, (h, w)), cv2.resize(img, (w, h)))


@pytest.fixture(scope="module")
def seg_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        img = np.full((60, 52), 60, np.uint8)
        img[16:48, 12:40] = 200
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        lab = np.zeros((60, 52), np.uint8)
        lab[16:48, 12:40] = 255
        Image.fromarray(np.stack([img, img // 2, 255 - img], -1)).save(root / "images" / f"{i}.png")
        Image.fromarray(lab).save(root / "labels" / f"{i}.png")
    return (sorted(glob.glob(str(root / "images" / "*"))),
            sorted(glob.glob(str(root / "labels" / "*"))))


@pytest.mark.parametrize("labeled", [True, False])
def test_segloader_matches_jax_and_host_path(seg_dataset, labeled):
    """The port's loader (a uint8 stack on its device) and the JAX package's
    host (cv2) loader give the same batches, shuffled by the same seed, in
    the same number of batches."""
    imgs, labs = seg_dataset
    labs = labs if labeled else None
    loader = sup.SegLoader(imgs, labs, 32, 4, shuffle=True)
    jl = jsup.SegLoader(imgs, labs, 32, 4, shuffle=True, device_resident=False)
    for epoch in (0, 3):
        got, want = list(loader.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) == len(loader) == 2
        for a, j in zip(got, want):
            a, j = ((t,) if not isinstance(t, tuple) else t for t in (a, j))
            assert len(a) == len(j)
            for ta, tj in zip(a, j):
                assert ta.dtype == torch.float32
                np.testing.assert_array_equal(ta.numpy(), np.asarray(tj))
    empty = sup.SegLoader([], [], 32, 2)
    assert len(empty) == 0 and list(empty.epoch(0)) == []


def test_plateau_lr_sequence_matches_jax_and_torch():
    """The plateau rates over a loss curve that improves, stalls, creeps
    below the relative threshold and improves again: equal to the JAX
    package's and to torch's ReduceLROnPlateau('min', patience=5)."""
    losses = [1.0, 0.9, 0.95, 0.96, 0.9, 0.91, 0.92, 0.93, 0.8999, 0.89999, 0.5, 0.6, 0.6, 0.6,
              0.6, 0.6, 0.6, 0.6, 0.49999, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7]
    ours, theirs = sup.ReduceLROnPlateau(1e-3), jsup.ReduceLROnPlateau(1e-3)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1e-3)
    ref = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, "min", patience=5)
    for v in losses:
        ref.step(v)
        assert ours.step(v) == theirs.step(v) == pytest.approx(opt.param_groups[0]["lr"],
                                                               rel=1e-12)


def test_split_reference_equals_jax():
    imgs, labs = [f"i{i}" for i in range(230)], [f"l{i}" for i in range(230)]
    for kind in ("finetune", "unet", "pgt"):
        for ratio in (1.0, 0.5, 0.05):
            assert sup.split_reference(imgs, labs, kind, ratio) == \
                jsup.split_reference(imgs, labs, kind, ratio)
    assert sup.split_reference(imgs, None, "pgt")[0][1] is None
    with pytest.raises(ValueError):
        sup.split_reference(imgs, labs, "other")


# ---------------------------------------------------------------------------
# train / test loops
# ---------------------------------------------------------------------------


def test_test_supervised_matches_jax(seg_dataset, tmp_path):
    """The per-image test pass of a 1-layer LinearProbing at 32^2: the six
    averaged metrics within 1e-6 and the mean loss within 1e-6, the same
    triptych files, nearest and linear GT resizes."""
    imgs, labs = seg_dataset
    jparams, model = _probing_pair(1, 6)
    state = jparams.pop("state")

    def japply(p, s, xx, train):
        return jprobing.apply(dict(p, state=s), JCFG, xx, layer_num=1, train=train)

    for nearest in (True, False):
        want, wloss = jsup.test_supervised(japply, jparams, state, imgs[:3], labs[:3], 32,
                                           str(tmp_path / f"j{nearest}"), mask_nearest=nearest,
                                           logger=lambda *_: None)
        got, loss = sup.test_supervised(probing.apply, model, imgs[:3], labs[:3], 32,
                                        str(tmp_path / f"t{nearest}"), mask_nearest=nearest,
                                        logger=lambda *_: None)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert loss == pytest.approx(wloss, abs=1e-6)
        names = sorted(os.listdir(tmp_path / f"t{nearest}"))
        assert names == sorted(os.listdir(tmp_path / f"j{nearest}")) and len(names) == 3
        for n in names:
            a = np.asarray(Image.open(tmp_path / f"t{nearest}" / n))
            b = np.asarray(Image.open(tmp_path / f"j{nearest}" / n))
            assert a.shape == b.shape == (32, 32 * 3 + 20, 3)
            np.testing.assert_array_equal(a, b)


def test_test_supervised_pseudo_labels_and_empty(tmp_path, seg_dataset):
    """GT of None takes the pseudo-label function; an empty test set warns
    and returns zeros."""
    imgs, _ = seg_dataset
    _, model = _probing_pair(1, 7)
    calls = []

    def pseudo(x):
        calls.append(x.shape)
        return (x[..., :1] > 0.5).float()

    avg, _ = sup.test_supervised(probing.apply, model, imgs[:2], [None, None], 32,
                                 str(tmp_path / "p"), pseudo_label_fn=pseudo,
                                 logger=lambda *_: None)
    assert calls == [(1, 32, 32, 3)] * 2 and np.isfinite(avg).all()
    logs = []
    avg, loss = sup.test_supervised(probing.apply, model, [], [], 32, str(tmp_path / "e"),
                                    logger=logs.append)
    assert not avg.any() and loss == 0.0 and "test split is empty" in logs[0]


def test_train_supervised_empty_splits(tmp_path, seg_dataset):
    """An empty train split raises; an empty validation split warns and
    falls back to the train loss; the best model is saved and restored."""
    imgs, labs = seg_dataset
    _, model = _probing_pair(2, 8)
    with pytest.raises(ValueError, match="train split is empty"):
        sup.train_supervised(probing.apply, model, sup.SegLoader([], [], 32, 2),
                             sup.SegLoader([], [], 32, 2), epochs=1, lr=1e-3,
                             checkpoint_path=str(tmp_path / "x"))
    logs = []
    model, tl, vl = sup.train_supervised(
        probing.apply, model, sup.SegLoader(imgs, labs, 32, 3, shuffle=True),
        sup.SegLoader([], [], 32, 2), epochs=3, lr=1e-3, checkpoint_path=str(tmp_path / "ft"),
        logger=logs.append)
    assert "validation split is empty" in logs[0] and vl == tl and tl[-1] < tl[0]
    saved = torch.load(tmp_path / "ft" / "ckpt_epoch_0", weights_only=False)
    best = int(np.argmin(vl))
    assert saved["epoch"] == 0 and set(saved["model"]) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    assert best == len(vl) - 1
